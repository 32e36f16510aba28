"""Skip-gram embedding training with negative sampling: counterpart of
``dgll_tpu/embedding/skipgram.py``.

Parity with the reference's skip-gram (``deepWalk.py:41-52``, ``skipgram.py:3-26``),
as the JAX package redesigned it: (center, context) pairs come from the walks on the
host (``walk_pairs``, the same numpy), and a step is one SGNS update over a batch of
pairs on the device: gathers of the two tables' rows, a batched product with the
negatives' rows, ``log_sigmoid`` and Adam (``torch.optim.Adam`` for ``optax.adam``,
as the trainers). No ``[N]``-wide softmax.

The JAX step draws its negatives with ``jax.random.randint``, whose bits no
``torch.Generator`` gives: a step here draws them from the model's generator unless
it is given them, which is how the tests feed both packages the same negatives.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def walk_pairs(walks: np.ndarray, window: int, rng: np.random.Generator) -> np.ndarray:
    """(center, context) pairs from walks with the standard shrinking window."""
    W, L = walks.shape
    pairs = []
    for off in range(1, window + 1):
        keep = rng.random((W, L - off)) < (1.0 - (off - 1) / window)
        c = walks[:, :-off][keep]
        t = walks[:, off:][keep]
        pairs.append(np.stack([c, t], 1))
        pairs.append(np.stack([t, c], 1))
    return np.concatenate(pairs, 0)


def _device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device}: no CUDA device is available")
    return dev


class SkipGramModel(torch.nn.Module):
    """Two-table SGNS model on ``device`` (the card by default): ``w_in`` (the
    embeddings, uniform in ``±1/sqrt(dim)`` from ``seed``) and ``w_out`` (zeros),
    trained with Adam at ``lr``; ``embeddings`` returns ``w_in`` (ref
    ``SkipGramModel``)."""

    def __init__(self, n_node: int, dim: int, n_negative: int = 5, lr: float = 1e-2,
                 seed: int = 0, device="cuda"):
        super().__init__()
        self.n_node, self.dim, self.n_negative = n_node, dim, n_negative
        dev = _device(device)
        scale = 1.0 / np.sqrt(dim)
        gen = torch.Generator().manual_seed(seed)
        w_in = (torch.rand(n_node, dim, generator=gen) * 2.0 - 1.0) * scale
        self.w_in = torch.nn.Parameter(w_in.to(dev))
        self.w_out = torch.nn.Parameter(torch.zeros(n_node, dim, device=dev))
        self.optimizer = torch.optim.Adam(self.parameters(), lr=lr)
        self.generator = torch.Generator(device=dev).manual_seed(seed + 1)

    @property
    def device(self) -> torch.device:
        return self.w_in.device

    def loss(self, centers: torch.Tensor, contexts: torch.Tensor,
             negatives: torch.Tensor) -> torch.Tensor:
        """The SGNS loss of a batch: ``-mean(log σ(h·pos) + Σ_k log σ(-h·neg_k))``."""
        h = self.w_in.index_select(0, centers)                       # [B, D]
        pos = self.w_out.index_select(0, contexts)                   # [B, D]
        negv = self.w_out.index_select(0, negatives.reshape(-1)).view(
            *negatives.shape, self.dim)                               # [B, K, D]
        pos_score = (h * pos).sum(-1)
        neg_score = torch.einsum("bd,bkd->bk", h, negv)
        return -(F.logsigmoid(pos_score) + F.logsigmoid(-neg_score).sum(-1)).mean()

    def step(self, centers, contexts, negatives=None) -> torch.Tensor:
        """One Adam step on a batch of pairs; the loss before it, a device tensor.
        ``negatives`` ``[B, n_negative]``: drawn uniformly from the model's generator
        where None."""
        dev = self.device
        centers = torch.as_tensor(centers, device=dev).long()
        contexts = torch.as_tensor(contexts, device=dev).long()
        if negatives is None:
            negatives = torch.randint(0, self.n_node, (len(centers), self.n_negative),
                                      generator=self.generator, device=dev)
        negatives = torch.as_tensor(negatives, device=dev).long()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss(centers, contexts, negatives)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def train(self, pairs: np.ndarray = None, epochs: int = 1, batch_size: int = 8192,
              seed: int = 0, shuffle: bool = True):
        """``epochs`` passes over ``pairs`` in batches of ``min(batch_size, len)``
        (the tail that fills no batch left out), in the order of
        ``default_rng(seed).permutation``, as the JAX package's; the last batch's loss.
        An epoch's batches go to the device in one copy, and its loss is read back
        once. Called without pairs, ``nn.Module.train()``: training mode."""
        if pairs is None or isinstance(pairs, bool):
            return super().train(True if pairs is None else pairs)
        rng = np.random.default_rng(seed)
        n = len(pairs)
        bs = min(batch_size, n)
        nb = n // bs
        last = 0.0
        for _ in range(epochs):
            order = rng.permutation(n) if shuffle else np.arange(n)
            batches = torch.from_numpy(np.ascontiguousarray(
                pairs[order[: nb * bs]], np.int64)).to(self.device)
            for i in range(nb):
                batch = batches[i * bs:(i + 1) * bs]
                loss = self.step(batch[:, 0], batch[:, 1])
            last = float(loss)
        return last

    @property
    def embeddings(self) -> np.ndarray:
        return self.w_in.detach().cpu().numpy()

    def node_embedding(self, nodes) -> np.ndarray:
        """ref ``learnNodeEmbedding``."""
        return self.embeddings[np.asarray(nodes)]

    def edge_embedding(self, src, dst) -> np.ndarray:
        """Hadamard edge features (ref ``learnEdgeEmbedding``)."""
        e = self.embeddings
        return e[np.asarray(src)] * e[np.asarray(dst)]


def save_embedding(path: str, emb: np.ndarray) -> None:
    np.save(path, emb)


def load_embedding(path: str) -> np.ndarray:
    return np.load(path)


def plot_embedding(emb: np.ndarray, labels=None, path: str = "embedding.png") -> str:
    """2-D scatter of embeddings (PCA to 2 dims), saved to ``path``, which it returns
    (the reference's ``ge.utils`` plot helper). Needs matplotlib, and raises a clear
    error where it is absent."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise RuntimeError("plot_embedding needs matplotlib") from e

    x = np.asarray(emb, np.float64)
    x = x - x.mean(0)
    u, s, _ = np.linalg.svd(x, full_matrices=False)  # PCA via SVD
    pts = u[:, :2] * s[:2]
    fig, ax = plt.subplots(figsize=(6, 6))
    ax.scatter(pts[:, 0], pts[:, 1], c=None if labels is None else np.asarray(labels),
               s=8, cmap="tab10")
    ax.set_title("node embeddings (PCA)")
    fig.savefig(path, dpi=120)
    plt.close(fig)
    return path
