"""Graph embeddings and downstream classifiers (the reference's ``main_ge.py`` and
``main_trainClf.py``; the counterpart of the JAX package's
``examples/deepwalk_embedding.py``):

    python -m dgll_tpu_torch.examples.deepwalk_embedding [deepwalk|node2vec|struc2vec]

Walks on the host, skip-gram with negative sampling on ``--device`` (the card by
default), then the five classifiers on the embeddings (sklearn where it is
installed, a softmax regression otherwise). Prints the accuracies.
"""
import argparse

import numpy as np


def main(argv=None) -> dict:
    from dgll_tpu_torch.data import synthetic_classification_graph
    from dgll_tpu_torch.embedding import DeepWalk, Node2Vec, Struc2Vec, train_all_classifiers

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("kind", nargs="?", default="deepwalk",
                   choices=["deepwalk", "node2vec", "struc2vec"])
    p.add_argument("--device", default="cuda")
    p.add_argument("--n_node", type=int, default=300)
    p.add_argument("--epochs", type=int, default=2)
    args = p.parse_args(argv)
    g = synthetic_classification_graph(n_node=args.n_node, avg_degree=8, n_class=4,
                                       homophily=0.9, seed=0)
    cls = {"deepwalk": DeepWalk, "node2vec": Node2Vec, "struc2vec": Struc2Vec}[args.kind]
    model = cls(g, walk_length=16, num_walks=8, dim=32, seed=0, device=args.device)
    model.train(epochs=args.epochs)
    labels = g.labels[: g.n_real_node].numpy()
    accs = train_all_classifiers(model.embeddings, labels, seed=0)
    print({k: round(v, 4) for k, v in accs.items()})
    return {"kind": args.kind, "accuracy": accs,
            "finite": bool(np.isfinite(model.embeddings).all())}


if __name__ == "__main__":
    main()
