"""The port's GCNII (``dgll_tpu_torch.nn.GCNII``), as the CLI builds it."""
from __future__ import annotations

import torch

NEEDS_LAYOUTS = False  # its layers build their own on the card (``Graph.gcn_chunked``)


def build(cfg: dict, n_feat: int, n_class: int, seed: int) -> torch.nn.Module:
    from dgll_tpu_torch.nn import GCNII

    return GCNII(n_feat, hidden=cfg["hidden"], n_class=n_class, n_layers=cfg["n_layers"],
                 alpha=cfg["alpha"], lamda=cfg["lamda"], dropout=cfg["dropout"],
                 generator=torch.Generator().manual_seed(seed))
