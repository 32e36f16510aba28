"""Loss and evaluation metrics. Counterpart of ``dgll_tpu/train/metrics.py``.

The metrics take tensors (or anything ``torch.as_tensor`` takes), compute on the
tensors' device and return Python floats.
"""
from __future__ import annotations

import os

import numpy as np
import torch


def _t(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))


def accuracy(logits_or_pred, labels, mask=None) -> float:
    pred = _t(logits_or_pred)
    if pred.dim() > 1:
        pred = pred.argmax(-1)
    ok = (pred == _t(labels).to(pred.device)).double()
    if mask is not None:
        m = _t(mask).to(pred.device).double()
        return float((ok * m).sum() / m.sum().clamp_min(1))
    return float(ok.mean())


def micro_f1(pred, target, mask=None) -> float:
    """Micro-averaged F1 for multilabel (2-D {0,1}) or multiclass (1-D int) predictions."""
    pred = _t(pred)
    target = _t(target).to(pred.device)
    if mask is not None:
        m = _t(mask).to(pred.device).bool()
        pred, target = pred[m], target[m]
    if pred.dim() == 1 or (pred.dim() == 2 and target.dim() == 1):
        if pred.dim() == 2:
            pred = pred.argmax(-1)
        # multiclass micro-F1 == accuracy
        return float((pred == target).double().mean())
    tp = float(((pred == 1) & (target == 1)).sum())
    fp = float(((pred == 1) & (target == 0)).sum())
    fn = float(((pred == 0) & (target == 1)).sum())
    denom = 2 * tp + fp + fn
    return 2 * tp / denom if denom else 0.0


METRIC_FOR_DATASET = {
    "reddit": "f1",
    "ogbn-proteins": "roc-auc",
    "ogbn-arxiv": "acc",
    "ogbn-products": "acc",
    "cora": "acc",
    "citeseer": "acc",
    "pubmed": "acc",
    "ppi": "f1",
}


def metric_for_dataset(name: str) -> str:
    """Headline-metric key for a dataset; datasets not in the table get ``acc``."""
    base = os.path.basename(str(name).rstrip("/")).lower()
    for suffix in (".graph", ".pkl"):
        if base.endswith(suffix):
            base = base[: -len(suffix)]
    return METRIC_FOR_DATASET.get(base, "acc")


def masked_nll_loss(log_probs: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean negative log-likelihood over masked nodes (models emit log_softmax)."""
    nll = -log_probs.gather(-1, labels[:, None].long())[:, 0]
    if mask is None:
        return nll.mean()
    m = mask.to(nll.dtype)
    return (nll * m).sum() / m.sum().clamp_min(1.0)
