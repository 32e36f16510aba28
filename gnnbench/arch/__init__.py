"""The port's side of each architecture: how the harness builds ``dgll_tpu_torch``'s
model and optimizer for a configuration, as the port's CLI builds them
(``dgll_tpu_torch.run``: ``resolve_device`` keeps float32 products out of TF32,
``make_optimizer`` picks Adam or AdamW). One module an ``arch`` named by a
configuration file; its plain reference is ``gnnbench/reference/<arch>.py``."""
from __future__ import annotations

from types import SimpleNamespace


def optimizer(cfg: dict, captured: bool):
    """The CLI's optimizer factory for ``cfg``; ``captured``: options of a step that
    runs as a CUDA graph (``GRAPH_ADAM``)."""
    from dgll_tpu_torch.run import make_optimizer
    from dgll_tpu_torch.train import GRAPH_ADAM

    ns = SimpleNamespace(lr=cfg["lr"], weight_decay=cfg["weight_decay"])
    return make_optimizer(ns, **(GRAPH_ADAM if captured else {}))
