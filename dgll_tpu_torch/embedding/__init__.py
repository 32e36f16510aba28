"""Graph embeddings: counterpart of ``dgll_tpu/embedding``. Random walks on the host
(``walks``), skip-gram with negative sampling on the device (``skipgram``), and
classifiers over the embeddings (``classifiers``); ``DeepWalk``, ``Node2Vec`` and
``Struc2Vec`` chain walks, pairs and training, as the reference's classes do."""
import numpy as np

from dgll_tpu_torch.embedding.classifiers import train_all_classifiers, train_classifier
from dgll_tpu_torch.embedding.skipgram import (
    SkipGramModel,
    load_embedding,
    plot_embedding,
    save_embedding,
    walk_pairs,
)
from dgll_tpu_torch.embedding.walks import (
    WalkGraph,
    deepwalk_walks,
    node2vec_walks,
    struc2vec_walks,
)

__all__ = [
    "WalkGraph",
    "deepwalk_walks",
    "node2vec_walks",
    "struc2vec_walks",
    "SkipGramModel",
    "walk_pairs",
    "save_embedding",
    "plot_embedding",
    "load_embedding",
    "train_classifier",
    "train_all_classifiers",
    "DeepWalk",
    "Node2Vec",
    "Struc2Vec",
]


class DeepWalk:
    """Walk, then train, then read the embeddings (the reference's ``deepWalk.py``
    class shape); the skip-gram model on ``device``, the card by default."""

    def __init__(self, graph, walk_length=20, num_walks=10, dim=64, window=5,
                 n_negative=5, lr=1e-2, seed=0, device="cuda"):
        self.wg = WalkGraph.from_graph(graph)
        self.walk_length, self.num_walks = walk_length, num_walks
        self.window, self.seed = window, seed
        self.model = SkipGramModel(self.wg.n_node, dim, n_negative, lr, seed, device)

    def walks(self) -> np.ndarray:
        return deepwalk_walks(self.wg, self.num_walks, self.walk_length, self.seed)

    def train(self, epochs: int = 2) -> "DeepWalk":
        pairs = walk_pairs(self.walks(), self.window, np.random.default_rng(self.seed))
        self.model.train(pairs, epochs=epochs)
        return self

    @property
    def embeddings(self) -> np.ndarray:
        return self.model.embeddings


class Node2Vec(DeepWalk):
    """node2vec (ref ``node2vec.py``): DeepWalk on p/q-biased walks."""

    def __init__(self, graph, p=1.0, q=1.0, **kw):
        super().__init__(graph, **kw)
        self.p, self.q = p, q

    def walks(self) -> np.ndarray:
        return node2vec_walks(self.wg, self.num_walks, self.walk_length, self.p, self.q,
                              self.seed)


class Struc2Vec(DeepWalk):
    """struc2vec (ref ``struc2vec.py``): DeepWalk on structural walks."""

    def walks(self) -> np.ndarray:
        return struc2vec_walks(self.wg, self.num_walks, self.walk_length, seed=self.seed)
