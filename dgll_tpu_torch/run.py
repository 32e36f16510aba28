"""Training CLI: ``python -m dgll_tpu_torch.run --Model GCN|GAT --samp_type full ...``

Counterpart of ``dgll_tpu/run.py``, for the part of it this package has ported:
full-batch GCN and GAT training on the synthetic dataset, on one device. It prints
the same JSON keys. Everything else raises ``NotImplementedError`` naming the
ROADMAP.md item that will port it.

On a CUDA device the graph gets the kernel layouts, whatever its size. A GCN run
attaches ``g.with_windowed(reorder=True).with_chunked()`` as the JAX CLI does: where
the graph has source locality, or a relabelling gives it some, both GCN layers
aggregate through the windowed kernel K2 and K1 on the residual edges; where it
declines, through K1 alone. Every GAT layer runs the fused attention op (K3-K7 and
K1) on ``with_chunked()`` only, since GAT never reads the windowed layout. The JAX
package's 100k-edge threshold is the TPU's launch-overhead rule; the port's layers
have no plain version on the card.
"""
from __future__ import annotations

import functools
import json
import time

import numpy as np
import torch

# The port's names for its SpMM kernels (K1, and K2 composed with K1 on the
# residual) and its fused GAT op, reported as ``spmm_kernel`` and ``gat_kernel``.
SPMM_KERNEL = "spmm_csr_cuda"
WINDOWED_KERNEL = "spmm_windowed_cuda"
GAT_KERNEL = "gat_attention_fused"


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for a configuration outside the ported slice."""
    todo = "see ROADMAP.md, Queue 1, item"
    model = cfg.model.upper()
    if model in ("GRAPHSAGE", "SAGE"):
        raise NotImplementedError(f"--Model {cfg.model}: {todo} 1 (minibatch GraphSAGE)")
    if model == "GIN":
        raise NotImplementedError(f"--Model {cfg.model}: {todo} 4 (GIN layers and pooling)")
    if model not in ("GCN", "GAT"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if model == "GAT" and _dtype(cfg) is not None:
        raise NotImplementedError(f"--dtype {cfg.dtype} with --Model GAT: {todo} 2 "
                                  "(GAT's bf16 path)")
    if cfg.sampler != "full":
        item = {"neighbor": "1 (device neighbour sampling) and 5 (host minibatch path)",
                "fastgcn": "6 (layer-wise samplers)",
                "ladies": "6 (layer-wise samplers)"}.get(cfg.sampler)
        if item is None:
            raise ValueError(f"unknown sampler {cfg.sampler!r}")
        raise NotImplementedError(f"--samp_type {cfg.sampler}: {todo} {item}")
    if cfg.n_devices > 1:
        raise NotImplementedError(f"--n_devices {cfg.n_devices}: {todo} 8 (parallel)")
    if cfg.checkpoint_dir:
        raise NotImplementedError(f"--checkpoint_dir: {todo} 11 (checkpoints)")


def resolve_device(name: str) -> torch.device:
    """The torch device to run on. A CUDA device that is not there raises; on a CUDA
    device float32 matrix products and convolutions stay in full float32 (no TF32)."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev


def build_dataset(cfg):
    from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph

    if cfg.dataset != "synthetic":
        raise NotImplementedError(f"--dataset {cfg.dataset}: see ROADMAP.md, Queue 1, "
                                  "item 10 (dataset loaders)")
    g = synthetic_classification_graph(
        n_node=cfg.n_node, avg_degree=cfg.avg_degree, n_class=cfg.n_class,
        feat_dim=cfg.feat_dim, power_law=1.0, seed=cfg.seed,
    )
    return gcn_normalize(g)


def _dtype(cfg):
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16}.get(cfg.dtype)


def build_model(cfg, n_class: int, in_features: int, generator=None):
    from dgll_tpu_torch.nn import GAT, GCN

    if cfg.model.upper() == "GAT":
        return GAT(in_features, hidden=cfg.nhid, n_class=n_class, num_heads=cfg.n_heads,
                   n_layers=cfg.n_layers, dropout=cfg.dropout, generator=generator)
    return GCN(in_features, hidden=cfg.nhid, n_class=n_class, n_layers=cfg.n_layers,
               dropout=cfg.dropout, dtype=_dtype(cfg), generator=generator)


def make_optimizer(cfg):
    """The optimizer factory of the JAX CLI's choice: AdamW (decoupled weight
    decay, as ``optax.adamw``) when ``--weight_decay`` is set, else Adam."""
    if cfg.weight_decay:
        return functools.partial(torch.optim.AdamW, lr=cfg.lr,
                                 weight_decay=cfg.weight_decay)
    return functools.partial(torch.optim.Adam, lr=cfg.lr)


def _finalize_trial(cfg, timer, t_start, extra, test_acc, f1, best_val,
                    n_epochs_run):
    """Shared trial epilogue: the per-dataset headline metric and the result dict."""
    from dgll_tpu_torch.train.metrics import metric_for_dataset

    total = time.perf_counter() - t_start
    metric_name = metric_for_dataset(cfg.dataset)
    metric_value = {"acc": test_acc, "f1": f1}.get(metric_name, test_acc)
    return {
        "test_acc": float(test_acc),
        "micro_f1": float(f1),
        "metric_name": metric_name,
        "metric": float(metric_value),
        "best_val": float(best_val),
        "epochs": n_epochs_run,
        "train_s": timer.totals.get("train", total),
        "total_s": total,
        **extra,
    }


def attach_kernel_layouts(cfg, g):
    """The graph with the kernel layouts of ``cfg``'s model attached, and what the
    CLI reports of them: GCN tries the windowed layouts (relabelling for locality
    where needed) and keeps the chunked ones for a decline; GAT takes the chunked
    ones only."""
    t_pre = time.perf_counter()
    extra: dict = {}
    if cfg.model.upper() == "GAT":
        g = g.with_chunked()
        extra["gat_kernel"] = GAT_KERNEL
    else:
        g = g.with_windowed(reorder=True).with_chunked()
    extra["spmm_kernel"] = SPMM_KERNEL if g.hybrid is None else WINDOWED_KERNEL
    extra["layout_preprocess_s"] = time.perf_counter() - t_pre
    if g.node_perm is not None:
        extra["locality_reordered"] = True
    return g, extra


def run_trial(cfg, g, trial_seed: int, dev: torch.device) -> dict:
    """One trial of a configuration ``main`` has checked, on the device it resolved."""
    from dgll_tpu_torch.train import FullBatchTrainer, accuracy, micro_f1
    from dgll_tpu_torch.utils import PhaseTimer

    timer = PhaseTimer()
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = build_model(cfg, n_class, g.node_feat.shape[1],
                        generator=torch.Generator().manual_seed(trial_seed))
    opt = make_optimizer(cfg)

    t_start = time.perf_counter()
    extra: dict = {}
    if dev.type == "cuda":
        g, extra = attach_kernel_layouts(cfg, g)
    g = g.to(dev)

    tr = FullBatchTrainer(model, opt, seed=trial_seed, device=dev)
    with timer.phase("train"):
        state, hist = tr.fit(
            g, g.node_feat, g.labels, g.train_mask, g.val_mask,
            epochs=cfg.n_epochs, patience=cfg.n_stops,
        )
    logp = tr.evaluate(state, g, g.node_feat)
    test_acc = accuracy(logp, g.labels, g.test_mask)
    f1 = micro_f1(logp.argmax(-1), g.labels, g.test_mask)
    # the loss curve and step times, for checks of a run (not in the JAX CLI)
    extra["epoch_loss"] = [e.loss for e in hist.epochs]
    extra["epoch_s"] = [e.seconds for e in hist.epochs]
    return _finalize_trial(cfg, timer, t_start, extra, test_acc, f1,
                           hist.best_val, len(hist.epochs))


def main(argv=None) -> dict:
    from dgll_tpu_torch.utils import parse_train_config

    cfg = parse_train_config(argv)
    check_supported(cfg)
    dev = resolve_device(cfg.device)
    g = build_dataset(cfg)  # raises for a dataset other than the synthetic one
    results = [run_trial(cfg, g, cfg.seed + t, dev) for t in range(cfg.n_trial)]
    agg = {
        k: {
            "mean": float(np.mean([r[k] for r in results])),
            "std": float(np.std([r[k] for r in results])),
        }
        for k in results[0]
        if isinstance(results[0][k], (int, float)) and results[0][k] is not None
        and not isinstance(results[0][k], bool)
    }
    out = {"config": vars(cfg) | {"fanouts": list(cfg.fanouts)}, "trials": results,
           "aggregate": agg}
    print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
