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


def macro_f1(pred, target, n_class: int, mask=None) -> float:
    """Unweighted mean over classes ``0 .. n_class - 1`` of each class's F1 (0 for a
    class that is neither predicted nor present); ``pred`` may be logits."""
    pred = _t(pred)
    if pred.dim() > 1:
        pred = pred.argmax(-1)
    target = _t(target).to(pred.device)
    if mask is not None:
        m = _t(mask).to(pred.device).bool()
        pred, target = pred[m], target[m]
    classes = torch.arange(n_class, device=pred.device)[:, None]
    p, t = pred[None, :] == classes, target[None, :] == classes
    tp = (p & t).sum(1).double()
    denom = 2 * tp + (p & ~t).sum(1) + (~p & t).sum(1)
    f1 = torch.where(denom > 0, 2 * tp / denom.clamp_min(1), 0.0)
    return float(f1.mean())


def roc_auc(scores, target, mask=None) -> float:
    """Binary ROC-AUC by the rank statistic, tied scores taking their average rank;
    a target of ``1`` is positive and anything else negative, and a set with one
    class only gives 0.5."""
    scores = _t(scores).double().reshape(-1)
    target = _t(target).to(scores.device).reshape(-1)
    if mask is not None:
        m = _t(mask).to(scores.device).bool().reshape(-1)
        scores, target = scores[m], target[m]
    pos = target == 1
    n_pos, n_neg = int(pos.sum()), int((~pos).sum())
    if n_pos == 0 or n_neg == 0:
        return 0.5
    _, inv, counts = torch.unique(scores, sorted=True, return_inverse=True,
                                  return_counts=True)
    # a tie group holding ranks end - count + 1 .. end takes their mean
    last = counts.cumsum(0).double()
    ranks = (last - (counts - 1) / 2.0)[inv]
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


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


def masked_bce_loss(logits: torch.Tensor, targets: torch.Tensor, mask=None) -> torch.Tensor:
    """Multilabel sigmoid cross-entropy (PPI-style), the mean over labels and then
    over the masked nodes; the logits are clipped to [-30, 30] and the loss is
    ``max(z, 0) - z t + log1p(exp(-|z|))``, which does not overflow."""
    z = logits.clamp(-30, 30)
    loss = (torch.maximum(z, torch.zeros_like(z)) - z * targets
            + torch.log1p(torch.exp(-z.abs())))
    loss = loss.mean(-1)
    if mask is None:
        return loss.mean()
    m = mask.to(loss.dtype)
    return (loss * m).sum() / m.sum().clamp_min(1.0)
