"""The port's GraphSAGE (``dgll_tpu_torch.nn.GraphSAGE``), as the CLI builds it."""
from __future__ import annotations

import torch

NEEDS_LAYOUTS = False  # the layers read no kernel layout (the CLI attaches none)


def build(cfg: dict, n_feat: int, n_class: int, seed: int) -> torch.nn.Module:
    from dgll_tpu_torch.nn import GraphSAGE

    return GraphSAGE(n_feat, hidden=cfg["hidden"], n_class=n_class,
                     n_layers=cfg["n_layers"], aggregator="mean", combine="concat",
                     dropout=cfg["dropout"],
                     generator=torch.Generator().manual_seed(seed))
