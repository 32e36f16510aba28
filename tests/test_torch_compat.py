"""The port's reference-API surface (``dgll_tpu_torch/compat.py``) against the JAX
package's (``dgll_tpu/compat.py``; the counterpart of ``tests/test_compat.py``).

Every public name of ``dgll_tpu.compat`` exists in ``dgll_tpu_torch.compat`` and is
the port's counterpart of the same kind (a class for a class, a function for a
function); ``backend`` is ``torch``, the reference's own; ``DGraph`` builds the same
graph as JAX's from the reference's adjacency dict (CSR, features, labels, masks) and
answers the same queries; a training step runs through compat names only.
"""
import inspect

import numpy as np
import torch

from dgll_tpu import compat as jax_compat
from dgll_tpu_torch import compat as dgll

REFERENCE_NAMES = [
    "backend", "DGraph", "Base_sampler", "DGLLNeighborSampler", "NeighborSampler",
    "DataLoader", "sugbraph", "gcnConv", "GraphConvolution", "gatConv",
    "sparseGatConv", "sageConv", "GinConv", "GCN", "GAT", "SpGAT", "GraphSage",
    "GIN", "Pooling", "sumPooling", "meanPooling", "maxPooling",
    "GraphCacheServer", "DeepWalk", "Node2vec", "Struc2Vec", "SkipGramModel",
    "TrainingClassifiers", "loadGraph", "saveGraph", "saveEmbedding", "mylog",
    "normalize", "accuracy", "FastGCNSampler", "LadiesSampler",
]


def _public(mod):
    return {k for k in vars(mod) if not k.startswith("_")} - {"annotations"}


def test_every_public_name_of_the_jax_compat_exists():
    missing = sorted(_public(jax_compat) - _public(dgll))
    assert not missing, missing
    for name in REFERENCE_NAMES:
        assert hasattr(dgll, name), name
    for name in _public(jax_compat) - {"backend", "np", "Dict", "List", "Optional",
                                       "Sequence"}:
        a, b = getattr(jax_compat, name), getattr(dgll, name)
        assert inspect.isclass(a) == inspect.isclass(b), name
        assert callable(a) == callable(b), name
        assert getattr(b, "__module__", "dgll_tpu_torch").startswith("dgll_tpu_torch"), name
    assert dgll.backend is torch


def _graphs():
    nodes = [0, 1, 2, 3]
    edges = {0: [1, 2], 1: [0], 2: [0, 1], 3: []}
    kw = dict(labels=np.array([0, 1, 0, 1]), features=np.eye(4, dtype=np.float32),
              train_mask=np.array([1, 1, 0, 0], bool), test_mask=np.array([0, 0, 1, 1], bool))
    return dgll.DGraph(nodes, edges, **kw), jax_compat.DGraph(nodes, edges, **kw)


def test_dgraph_builds_the_jax_graph():
    gt, gj = _graphs()
    assert (gt.n_node, gt.n_edge, gt.n_real_node, gt.n_real_edge) == (
        gj.n_node, gj.n_edge, gj.n_real_node, gj.n_real_edge)
    for f in ("indptr", "src", "dst", "node_feat", "labels", "train_mask", "test_mask"):
        np.testing.assert_array_equal(getattr(gt, f).numpy(), np.asarray(getattr(gj, f)), f)
    assert sorted(gt.get_neighbors([0])[0]) == [1, 2]
    np.testing.assert_array_equal(gt.get_features([2]).numpy(), np.eye(4)[[2]])
    np.testing.assert_array_equal(gt.get_train_nodes(), [0, 1])
    np.testing.assert_array_equal(gt.get_train_nodes(), gj.get_train_nodes())
    empty = dgll.DGraph([0, 1], {})
    assert empty.n_node == 2 and empty.n_real_edge == 0


def test_compat_training_flow():
    """graphage.py-style training through compat names only."""
    from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
    from dgll_tpu_torch.train import MiniBatchTrainer

    g = gcn_normalize(synthetic_classification_graph(n_node=200, avg_degree=6,
                                                     n_class=3, feat_dim=8, seed=0))
    sampler = dgll.DGLLNeighborSampler([4, 4])
    loader = dgll.DataLoader(g, g.get_train_nodes(), sampler, batch_size=16)
    model = dgll.GraphSage(8, 16, 3, dropout=0.0)
    tr = MiniBatchTrainer(model, lambda p: torch.optim.Adam(p, lr=1e-2), device="cpu")
    state = tr.init_state()
    state, loss, _ = tr.run_epoch(state, loader, g.node_feat, g.labels)
    assert np.isfinite(loss)
    from dgll_tpu_torch.utils.logging import get_logger

    assert dgll.mylog.get_logger is get_logger
