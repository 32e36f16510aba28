"""PPI-protocol evaluation: a two-layer multilabel GCN trained graph by graph with
the sigmoid cross-entropy, scored by micro-F1 on held-out graphs (the reference's
``Evaluation/PPI/train_gcn.py``):

    python -m dgll_tpu_torch.examples.ppi_eval                  # synthetic PPI-shaped graphs
    python -m dgll_tpu_torch.examples.ppi_eval --data /path/ppi # {split}_graph.json + .npy

The graphs are not padded to one shape (the JAX example pads them so that its
step compiles once); on a CUDA device each gets the kernel layouts.
"""
import argparse
import time

import numpy as np
import torch
from torch import nn


def synthetic_ppi(n_graph=4, n_node=600, avg_deg=8, feat_dim=50, n_label=121, seed=0):
    """PPI-shaped multilabel graphs whose labels follow one shared linear map of the
    features, so the training graphs carry over to the test graph."""
    from dgll_tpu_torch.graph import Graph

    rng = np.random.default_rng(seed)
    w = rng.standard_normal((feat_dim, n_label), dtype=np.float32)
    graphs = []
    for _ in range(n_graph):
        src = rng.integers(0, n_node, n_node * avg_deg)
        dst = rng.integers(0, n_node, n_node * avg_deg)
        feats = rng.standard_normal((n_node, feat_dim), dtype=np.float32)
        labels = ((feats @ w) > 0.8).astype(np.float32)
        graphs.append(Graph.from_edges(src, dst, n_node, node_feat=feats, labels=labels,
                                       make_bidirected=True, add_self_loops=True))
    return graphs


class PPIModel(nn.Module):
    """GCNConv, ReLU, GCNConv: multilabel logits."""

    def __init__(self, in_features: int, hidden: int, n_label: int, generator=None):
        super().__init__()
        from dgll_tpu_torch.nn import GCNConv

        self.conv1 = GCNConv(in_features, hidden, generator=generator)
        self.conv2 = GCNConv(hidden, n_label, generator=generator)

    def forward(self, g, x):
        return self.conv2(g, torch.relu(self.conv1(g, x)))


def main(argv=None) -> dict:
    from dgll_tpu_torch.data import gcn_normalize, load_ppi_split
    from dgll_tpu_torch.run import resolve_device
    from dgll_tpu_torch.train.metrics import masked_bce_loss, micro_f1

    p = argparse.ArgumentParser()
    p.add_argument("--data", default="", help="dir with {split}_graph.json + .npy")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--n_node", type=int, default=600, help="synthetic graphs' nodes")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    if args.data:
        train_graphs = load_ppi_split(args.data, "train")
        test_graphs = load_ppi_split(args.data, "test")
    else:
        graphs = synthetic_ppi(n_node=args.n_node)
        train_graphs, test_graphs = graphs[:-1], graphs[-1:]

    def prepare(g):
        g = gcn_normalize(g)
        return (g.with_chunked() if dev.type == "cuda" else g).to(dev)

    train_graphs = [prepare(g) for g in train_graphs]
    test_graphs = [prepare(g) for g in test_graphs]
    n_label = int(train_graphs[0].labels.shape[1])
    model = PPIModel(train_graphs[0].node_feat.shape[1], args.hidden, n_label,
                     generator=torch.Generator().manual_seed(0)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)

    t0 = time.perf_counter()
    for _ in range(args.epochs):
        for g in train_graphs:
            opt.zero_grad(set_to_none=True)
            loss = masked_bce_loss(model(g, g.node_feat), g.labels)
            loss.backward()
            opt.step()
    loss = loss.item()
    train_s = time.perf_counter() - t0

    f1s = []
    with torch.no_grad():
        for g in test_graphs:
            pred = (model(g, g.node_feat) > 0).float()
            f1s.append(micro_f1(pred[: g.n_real_node], g.labels[: g.n_real_node]))
    out = {"loss": loss, "test_micro_f1": float(np.mean(f1s)),
           "train_s": round(train_s, 2), "epochs": args.epochs}
    print(out)
    return out


if __name__ == "__main__":
    main()
