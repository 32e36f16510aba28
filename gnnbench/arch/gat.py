"""The port's GAT (``dgll_tpu_torch.nn.GAT``), as the CLI builds it."""
from __future__ import annotations

import torch

NEEDS_LAYOUTS = True  # a full graph runs the fused op on the kernel layouts (K1, K3-K7)


def build(cfg: dict, n_feat: int, n_class: int, seed: int) -> torch.nn.Module:
    from dgll_tpu_torch.nn import GAT

    return GAT(n_feat, hidden=cfg["hidden"], n_class=n_class, num_heads=cfg["heads"],
               n_layers=cfg["n_layers"], dropout=cfg["dropout"],
               negative_slope=cfg["negative_slope"],
               generator=torch.Generator().manual_seed(seed))
