"""Device-resident minibatch GraphSAGE: the CSR, features and labels on the device,
neighbour sampling in block-window mode on the device, each batch a CUDA-graph
replay (``DeviceEpochRunner``); the test accuracy from host-sampled blocks
(``MiniBatchTrainer.evaluate_nodes`` over a ``DataLoader``).

    python -m dgll_tpu_torch.examples.device_pipeline_sage [--n_node 20000 --epochs 10]

The CLI's counterpart: ``python -m dgll_tpu_torch.run --Model SAGE --device_sampling``.
"""
import argparse
import functools

import torch


def main(argv=None) -> dict:
    from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.run import resolve_device
    from dgll_tpu_torch.sampling import DeviceCSR, NeighborSampler
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceEpochRunner, MiniBatchTrainer

    p = argparse.ArgumentParser()
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_node", type=int, default=20_000)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch_size", type=int, default=512)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    g = gcn_normalize(synthetic_classification_graph(
        n_node=args.n_node, avg_degree=10, n_class=8, feat_dim=64, seed=0))
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    model = GraphSAGE(64, hidden=128, n_class=8, dropout=0.0,
                      generator=torch.Generator().manual_seed(0))
    opt = functools.partial(torch.optim.Adam, lr=1e-2,
                            **(GRAPH_ADAM if dev.type == "cuda" else {}))
    runner = DeviceEpochRunner(model, opt, DeviceCSR.from_graph(g, dev), fanouts=[10, 5],
                               batch_size=args.batch_size,
                               train_nodes=g.get_train_nodes(), window=True, seed=0)
    state = runner.init_state(feats)
    losses = []
    for epoch in range(args.epochs):
        state, loss = runner.run_epoch(state, feats, labels)
        losses.append(float(loss))
        print(f"epoch {epoch}: loss {losses[-1]:.4f}")

    ev = MiniBatchTrainer(model, opt, device=dev)
    test_loader = DataLoader(g, g.get_test_nodes(), NeighborSampler([10, 5]),
                             args.batch_size, shuffle=False, device=dev)
    acc = ev.evaluate_nodes(state, test_loader, feats, labels)
    print(f"test accuracy: {acc:.4f}")
    return {"losses": losses, "test_acc": acc}


if __name__ == "__main__":
    main()
