"""Downstream classifiers over learned embeddings: counterpart of
``dgll_tpu/embedding/classifiers.py`` (host numpy, the same code).

Parity with ``TrainingClassifiers`` (``Graph Embedding/src/ge/Classifiers.py:10-59``):
LR / decision tree / random forest / gradient boosting / MLP with a train/test split
and accuracy. Uses sklearn when present, with a self-contained softmax-regression
fallback so the capability never depends on the optional import.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


def _softmax_regression(Xtr, ytr, Xte, epochs=300, lr=0.5):
    n_class = int(ytr.max()) + 1
    W = np.zeros((Xtr.shape[1], n_class))
    b = np.zeros(n_class)
    y1h = np.eye(n_class)[ytr]
    for _ in range(epochs):
        z = Xtr @ W + b
        z -= z.max(1, keepdims=True)
        p = np.exp(z)
        p /= p.sum(1, keepdims=True)
        g = (p - y1h) / len(Xtr)
        W -= lr * Xtr.T @ g
        b -= lr * g.sum(0)
    return (Xte @ W + b).argmax(1)


def train_classifier(
    embeddings: np.ndarray,
    labels: np.ndarray,
    kind: str = "logistic",
    test_size: float = 0.25,
    seed: int = 0,
) -> Tuple[float, np.ndarray]:
    """Train one classifier kind; returns (test accuracy, test predictions)."""
    rng = np.random.default_rng(seed)
    n = len(labels)
    order = rng.permutation(n)
    n_te = max(1, int(test_size * n))
    te, tr = order[:n_te], order[n_te:]
    Xtr, ytr, Xte, yte = embeddings[tr], labels[tr], embeddings[te], labels[te]

    pred = None
    try:
        if kind == "logistic":
            from sklearn.linear_model import LogisticRegression as M
            model = M(max_iter=500)
        elif kind == "tree":
            from sklearn.tree import DecisionTreeClassifier as M
            model = M(random_state=seed)
        elif kind == "forest":
            from sklearn.ensemble import RandomForestClassifier as M
            model = M(n_estimators=100, random_state=seed)
        elif kind == "boosting":
            from sklearn.ensemble import GradientBoostingClassifier as M
            model = M(random_state=seed)
        elif kind == "mlp":
            from sklearn.neural_network import MLPClassifier as M
            model = M(hidden_layer_sizes=(64,), max_iter=500, random_state=seed)
        else:
            raise ValueError(f"unknown classifier {kind!r}")
        model.fit(Xtr, ytr)
        pred = model.predict(Xte)
    except ImportError:
        pred = _softmax_regression(Xtr, ytr, Xte)

    acc = float((pred == yte).mean())
    return acc, pred


def train_all_classifiers(embeddings, labels, seed: int = 0) -> Dict[str, float]:
    """All five reference classifier kinds -> accuracy dict."""
    return {
        k: train_classifier(embeddings, labels, k, seed=seed)[0]
        for k in ("logistic", "tree", "forest", "boosting", "mlp")
    }
