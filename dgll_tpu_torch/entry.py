"""Entry point for a quick check of the flagship model: ``entry(device="cuda")``.

Counterpart of ``entry()`` in the JAX package's entry hooks (``__graft_entry__.py``):
the flagship model, minibatch GraphSAGE, on blocks sampled on the host from the same
graph with the same sampler seed and sizes (2,000 nodes of average degree 8, 8
classes, 64 features, ``gcn_normalize``; fanouts [10, 5], a batch of the first 64
nodes; hidden width 128, dropout 0; weights from seed 0). ``entry`` returns
``(forward, args)``; ``forward(*args)`` is the model's output on the batch in eval
mode, ``[64, 8]`` log-probabilities. The multi-chip dry run is not ported.
"""
from __future__ import annotations

import numpy as np
import torch


def flagship(device="cuda", n_node=2000, n_class=8, feat_dim=64, batch=64,
             fanouts=(10, 5), seed=0):
    """``(graph, host graph, sampler, model, blocks, x)`` on ``device``."""
    from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.sampling import HostGraph, NeighborSampler

    g = gcn_normalize(synthetic_classification_graph(
        n_node=n_node, avg_degree=8, n_class=n_class, feat_dim=feat_dim, seed=seed))
    hg = HostGraph.from_graph(g)
    sampler = NeighborSampler(list(fanouts), seed=seed)
    _, _, blocks = sampler.sample(hg, np.arange(batch), pad_to=batch)
    dev = torch.device(device)
    blocks = [b.to(dev) for b in blocks]
    model = GraphSAGE(feat_dim, 128, n_class, dropout=0.0,
                      generator=torch.Generator().manual_seed(seed)).to(dev)
    x = g.node_feat.to(dev).index_select(0, blocks[0].src_ids)
    return g, hg, sampler, model, blocks, x


def entry(device="cuda"):
    """The flagship model's forward on a sampled batch, and its arguments."""
    _, _, _, model, blocks, x = flagship(device)

    @torch.no_grad()
    def forward(model, blocks, x):
        return model.eval()(list(blocks), x)

    return forward, (model, tuple(blocks), x)
