"""Device-resident FastGCN training: importance draws from alias tables on the
device, ``WeightedBlock`` aggregation and the sampled evaluation sweep, each batch
a CUDA-graph replay (``DeviceEpochRunner`` with ``sampler="fastgcn"`` on the
ELL-packed normalised Laplacian, ``build_device_lap``).

    python -m dgll_tpu_torch.examples.device_fastgcn_gcn [--n_node 30000 --epochs 10]
"""
import argparse
import functools

import numpy as np
import torch


def main(argv=None) -> dict:
    from dgll_tpu_torch.data import synthetic_classification_graph
    from dgll_tpu_torch.nn import GCN
    from dgll_tpu_torch.run import resolve_device
    from dgll_tpu_torch.sampling import build_device_lap
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceEpochRunner

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_node", type=int, default=30_000)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--layer_sizes", default="1024,512",
                   help="nodes sampled a layer, outermost first")
    p.add_argument("--batch_size", type=int, default=256)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    g = synthetic_classification_graph(n_node=args.n_node, avg_degree=12, n_class=16,
                                       feat_dim=64, power_law=1.0, homophily=0.8, seed=0)
    lap = build_device_lap(g, k=32, device=dev)
    model = GCN(64, hidden=64, n_class=16, dropout=0.0,
                generator=torch.Generator().manual_seed(0))
    opt = functools.partial(torch.optim.Adam, lr=1e-3,
                            **(GRAPH_ADAM if dev.type == "cuda" else {}))
    runner = DeviceEpochRunner(model, opt, lap,
                               fanouts=[int(s) for s in args.layer_sizes.split(",")],
                               batch_size=args.batch_size,
                               train_nodes=g.get_train_nodes(), seed=0, sampler="fastgcn")
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    state = runner.init_state(feats)
    losses = []
    for epoch in range(args.epochs):
        state, loss = runner.run_epoch(state, feats, labels)
        losses.append(float(loss))
        print(f"epoch {epoch}: loss {losses[-1]:.3f}")
    val = runner.evaluate_nodes(state, feats, np.asarray(g.labels),
                                g.get_validation_nodes())
    print(f"val acc {val:.3f}")
    return {"losses": losses, "val_acc": val}


if __name__ == "__main__":
    main()
