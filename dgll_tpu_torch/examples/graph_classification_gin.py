"""GIN graph classification with global pooling and a stratified 10-fold split (the
reference's GIN protocol):

    python -m dgll_tpu_torch.examples.graph_classification_gin              # synthetic
    python -m dgll_tpu_torch.examples.graph_classification_gin --data MUTAG.txt
    python -m dgll_tpu_torch.examples.graph_classification_gin --fold_idx 3 --degree_as_tag

``--data`` reads the graph-classification text format (``load_dataP``) and splits it
with ``separate_graphs``. The graphs of each split are batched into one graph; on a
CUDA device its aggregations run K1 on the kernel layouts. Nodes are padded to a
multiple of 128 and edges not at all, so the layouts cover every node row.
"""
import argparse

import torch


def load(args):
    """``(train tuples, test tuples, n_class)``."""
    from dgll_tpu_torch.data import (
        load_dataP,
        s2v_to_tuples,
        separate_data,
        separate_graphs,
        synthetic_graph_classification,
    )

    if args.data:
        graphs, n_class = load_dataP(args.data, degree_as_tag=args.degree_as_tag)
        train_g, test_g = separate_graphs(graphs, seed=args.seed, fold_idx=args.fold_idx)
        return s2v_to_tuples(train_g), s2v_to_tuples(test_g), n_class
    data = synthetic_graph_classification(n_graph=args.n_graph, n_class=2, feat_dim=8,
                                          seed=args.seed)
    tr, te = separate_data([d[3] for d in data], fold_idx=args.fold_idx, seed=args.seed)
    return [data[i] for i in tr], [data[i] for i in te], 2


def _batch(data, dev):
    from dgll_tpu_torch.nn import batch_graphs

    g, graph_id, labels = batch_graphs(data, node_pad_multiple=128, edge_pad_multiple=1)
    if dev.type == "cuda":
        g = g.with_chunked()
    return g.to(dev), graph_id.to(dev), labels.to(dev).long()


def fit(train_data, test_data, n_class, dev, epochs=100, seed=0) -> dict:
    from dgll_tpu_torch.nn import GIN
    from dgll_tpu_torch.train import accuracy

    g, graph_id, labels = _batch(train_data, dev)
    gt, graph_id_t, labels_t = _batch(test_data, dev)
    n_graph = len(train_data)
    model = GIN(g.node_feat.shape[1], hidden=32, n_class=n_class, n_layers=3,
                pooling=("sum", "mean"), dropout=0.1,
                generator=torch.Generator().manual_seed(seed)).to(dev)
    opt = torch.optim.Adam(model.parameters(), lr=5e-3)
    gen = torch.Generator(dev).manual_seed(seed + 1)
    model.train()
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        logp = model(g, g.node_feat, graph_id, n_graph, generator=gen)
        loss = -logp.gather(1, labels[:, None]).mean()
        loss.backward()
        opt.step()
    model.eval()
    with torch.no_grad():
        logp_tr = model(g, g.node_feat, graph_id, n_graph)
        logp_te = model(gt, gt.node_feat, graph_id_t, len(test_data))
    return {"loss": loss.item(), "train_acc": accuracy(logp_tr, labels),
            "test_acc": accuracy(logp_te, labels_t)}


def main(argv=None) -> dict:
    from dgll_tpu_torch.run import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--data", default="", help="load_dataP text file (optional)")
    p.add_argument("--degree_as_tag", action="store_true")
    p.add_argument("--fold_idx", type=int, default=0)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--n_graph", type=int, default=128, help="synthetic graphs")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)

    train_data, test_data, n_class = load(args)
    out = {"fold": args.fold_idx, "n_train": len(train_data), "n_test": len(test_data),
           **fit(train_data, test_data, n_class, dev, epochs=args.epochs, seed=args.seed)}
    print(out)
    return out


if __name__ == "__main__":
    main()
