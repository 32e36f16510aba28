"""Training CLI: ``python -m dgll_tpu_torch.run --Model GCN|GAT|GraphSAGE|GIN ...``

Counterpart of ``dgll_tpu/run.py``, for the part of it this package has ported, on
the synthetic dataset and one device: full-batch GCN, GAT, GraphSAGE and GIN
(``--samp_type full``), and the minibatch paths for all four, with the uniform
neighbour sampler (``--samp_type neighbor``, the default) or the layer-wise FastGCN
and LADIES samplers (``--samp_type fastgcn|ladies``, layer sizes from ``--n_samp``
and ``--samp_growth_rate``, with ``--flatten`` and ``--wrs``). The host path samples
on the host, a prefetching ``DataLoader`` moves each batch's blocks to the device and
``MiniBatchTrainer`` steps, with the device feature cache (``--cached_nPercent``)
and the community pipeline (``--n_parts``). The device path (``--device_sampling``)
keeps the CSR (or, for the layer-wise samplers, the normalised Laplacian), features
and labels on the device and runs ``DeviceEpochRunner``'s epochs, a CUDA-graph
replay a batch; its neighbour draws are per-slot or ``--window_sampling``, its
layer-wise draws with replacement (``--wrs`` is the host path's).
``--exact_eval`` takes the test accuracy of either minibatch path by exact
full-graph inference. ``--preprocess`` precomputes each node's neighbour-mean
features, concatenates them to the raw ones and drops the outermost sampled hop and
one layer, on either minibatch path. It prints the same JSON keys. Everything else
raises ``NotImplementedError`` naming the ROADMAP.md item that will port it.

On a CUDA device the graph gets the kernel layouts, whatever its size. A GCN or GIN
run attaches ``g.with_windowed(reorder=True).with_chunked()`` as the JAX CLI does:
where the graph has source locality, or a relabelling gives it some, every layer
aggregates through the windowed kernel K2 and K1 on the residual edges; where it
declines, through K1 alone. Every GAT layer runs the fused attention op (K3-K7 and
K1) on ``with_chunked()`` only, since GAT never reads the windowed layout. The JAX
package's 100k-edge threshold is the TPU's launch-overhead rule; the port's layers
have no plain version on the card. GraphSAGE's aggregations are plain PyTorch (XLA
in the JAX package), so a full-batch GraphSAGE run attaches no layout.

On the host minibatch path the graph stays on the host for the sampler, and the
features and labels live on the device; with the cache only the cached rows do, and
the misses come from the host store.
"""
from __future__ import annotations

import dataclasses
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
    """Raise ``NotImplementedError`` for a configuration outside the ported slices."""
    todo = "see ROADMAP.md, Queue 1, item"
    model = cfg.model.upper()
    if model not in ("GCN", "GAT", "GRAPHSAGE", "SAGE", "GIN"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if model == "GAT" and _dtype(cfg) is not None:
        raise NotImplementedError(f"--dtype {cfg.dtype} with --Model GAT: {todo} 2 "
                                  "(GAT's bf16 path)")
    if cfg.sampler not in ("full", "neighbor", "fastgcn", "ladies"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
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
    from dgll_tpu_torch.nn import GAT, GCN, GINNode, GraphSAGE

    if cfg.model.upper() == "GAT":
        return GAT(in_features, hidden=cfg.nhid, n_class=n_class, num_heads=cfg.n_heads,
                   n_layers=cfg.n_layers, dropout=cfg.dropout, generator=generator)
    if cfg.model.upper() in ("GRAPHSAGE", "SAGE"):
        return GraphSAGE(in_features, hidden=cfg.nhid, n_class=n_class,
                         n_layers=cfg.n_layers, aggregator=cfg.sage_aggregator,
                         combine=cfg.sage_combine, dropout=cfg.dropout,
                         dtype=_dtype(cfg), generator=generator)
    if cfg.model.upper() == "GIN":
        return GINNode(in_features, hidden=cfg.nhid, n_class=n_class,
                       n_layers=cfg.n_layers, dropout=cfg.dropout, dtype=_dtype(cfg),
                       generator=generator)
    return GCN(in_features, hidden=cfg.nhid, n_class=n_class, n_layers=cfg.n_layers,
               dropout=cfg.dropout, dtype=_dtype(cfg), generator=generator)


def build_sampler(cfg, g=None):
    """The host sampler: uniform neighbour fanout, or FastGCN/LADIES over ``g``'s
    normalised Laplacian with the geometric layer sizes."""
    from dgll_tpu_torch.sampling import (
        FastGCNSampler,
        LadiesSampler,
        NeighborSampler,
        geometric_layer_sizes,
        normalized_laplacian,
    )

    if cfg.sampler == "neighbor":
        return NeighborSampler(cfg.fanouts, seed=cfg.seed)
    sizes = geometric_layer_sizes(cfg.n_samp, cfg.samp_growth_rate, cfg.n_layers)
    cls = FastGCNSampler if cfg.sampler == "fastgcn" else LadiesSampler
    return cls(normalized_laplacian(g), sizes, flatten=cfg.flatten, wrs=cfg.wrs,
               seed=cfg.seed)


def device_sampling_graph(cfg, g, dev: torch.device, log):
    """The device sampler's graph and its per-layer sizes for ``--device_sampling``:
    the CSR and the fanouts (``neighbor``), or the ELL-packed normalised Laplacian
    (``build_device_lap``, K 32, ``--flatten`` baked in) and the geometric layer
    sizes (``fastgcn``/``ladies``)."""
    from dgll_tpu_torch.sampling import DeviceCSR, build_device_lap, geometric_layer_sizes

    if cfg.sampler == "neighbor":
        if cfg.window_sampling:
            log.info("device sampling: block-window mode (marginally uniform, draws "
                     "within a node correlated; --no_window_sampling for exact "
                     "per-slot draws)")
        return DeviceCSR.from_graph(g, dev), cfg.fanouts
    if cfg.wrs:
        log.info("device layer-wise sampling draws WITH replacement (multiplicity-"
                 "weighted unbiased estimator); --wrs's without-replacement draw is "
                 "host-path only")
    sizes = geometric_layer_sizes(cfg.n_samp, cfg.samp_growth_rate, cfg.n_layers)
    return build_device_lap(g, k=32, flatten=cfg.flatten, device=dev), sizes


def make_optimizer(cfg, **options):
    """The optimizer factory of the JAX CLI's choice: AdamW (decoupled weight
    decay, as ``optax.adamw``) when ``--weight_decay`` is set, else Adam; ``options``
    go to its constructor (``GRAPH_ADAM`` for a captured step)."""
    if cfg.weight_decay:
        return functools.partial(torch.optim.AdamW, lr=cfg.lr,
                                 weight_decay=cfg.weight_decay, **options)
    return functools.partial(torch.optim.Adam, lr=cfg.lr, **options)


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
    CLI reports of them: GCN and GIN try the windowed layouts (relabelling for
    locality where needed) and keep the chunked ones for a decline; GAT takes the
    chunked ones only."""
    t_pre = time.perf_counter()
    extra: dict = {}
    if cfg.model.upper() in ("GRAPHSAGE", "SAGE"):
        return g, extra  # no kernel on its path
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


def preprocess_features(cfg, g, model, n_class: int, trial_seed: int, extra: dict,
                        dev: torch.device):
    """``--preprocess`` (the reference's ``FeatureCache/gs.py:43-56``): each node's
    neighbour-mean features (``precompute_neighbor_features``, computed on ``dev``)
    concatenated to its raw features, padded rows kept padded; where there are two
    fanouts or more the outermost one and one layer go. The model is built anew for
    the wider input, from the trial's seed. Returns ``(cfg, g, model)``, unchanged
    without the flag."""
    if not cfg.preprocess:
        return cfg, g, model
    from dgll_tpu_torch.data import precompute_neighbor_features

    feats = g.node_feat.to(torch.float32)
    neigh = precompute_neighbor_features(g.to(dev)).to(feats.device)
    neigh = torch.nn.functional.pad(neigh, (0, 0, 0, g.n_node - g.n_real_node))
    g = g.replace(node_feat=torch.cat([feats, neigh], dim=1))
    if len(cfg.fanouts) > 1:
        cfg = dataclasses.replace(cfg, fanouts=list(cfg.fanouts[1:]),
                                  n_layers=max(cfg.n_layers - 1, 1))
    model = build_model(cfg, n_class, g.node_feat.shape[1],
                        generator=torch.Generator().manual_seed(trial_seed))
    extra["preprocess"] = True
    return cfg, g, model


def prepare_pipeline(cfg, g, model, n_class: int, trial_seed: int, timer, extra: dict,
                     dev: torch.device, log):
    """The community relabelling (``--n_parts`` > 1), the neighbour-feature
    preprocessing (``--preprocess``, ``preprocess_features``) and the device feature
    cache (``--cached_nPercent``) of the host minibatch path, in the JAX CLI's order.
    Returns ``(cfg, g, model, book, cache, fetch)``: the configuration, graph and
    model as preprocessing left them (the graph relabelled), the community book or
    None, and the cache and its fetch function or None."""
    book = None
    if cfg.n_parts > 1:
        from dgll_tpu_torch.parallel.community import run_cog

        cap = -(-g.n_real_node // cfg.n_parts)
        budget = cap * (int(g.node_feat.shape[1]) * 4 + 4)
        with timer.phase("cog"):
            g, book, cog_t = run_cog(g, hbm_budget_bytes=budget,
                                     batch_size=min(cfg.batch_size, cap), seed=cfg.seed)
        extra["n_communities"] = len(book)
        extra["cog_s"] = float(sum(cog_t.values()))
        log.info(f"COG: {len(book)} communities in {extra['cog_s']:.2f}s")

    cfg, g, model = preprocess_features(cfg, g, model, n_class, trial_seed, extra, dev)
    cache = fetch = None
    if cfg.cached_percent > 0:
        from dgll_tpu_torch.cache import HBMFeatureCache

        host_feats = g.node_feat.cpu().numpy().astype(np.float32)
        cache = HBMFeatureCache(host_feats, device=dev)
        k = int(cfg.cached_percent / 100.0 * g.n_real_node)
        cache.auto_cache(g.out_degrees_np(), k * host_feats.shape[1] * host_feats.itemsize)
        fetch = cache.fetch
        log.info(f"cache: {cache.k}/{g.n_real_node} rows resident")
    return cfg, g, model, book, cache, fetch


def run_device_trial(cfg, g, trial_seed: int, dev: torch.device, model, n_class: int,
                     timer, extra: dict, log) -> tuple:
    """The device-sampling path (``--device_sampling``): the CSR, the features
    (widened by ``--preprocess``) and the labels on the device, each epoch
    ``DeviceEpochRunner``'s (a CUDA-graph replay a batch on a CUDA device), validation
    and test by the device-sampled sweep or, with ``--exact_eval``, the test by exact
    inference. Returns ``(test_acc, micro_f1, best_val, epochs run)``, with the
    per-epoch losses and times in ``extra``."""
    from dgll_tpu_torch.train import GRAPH_ADAM, DeviceEpochRunner, micro_f1

    if cfg.n_parts > 1 or cfg.cached_percent > 0:
        raise ValueError("--device_sampling keeps the graph and features in device "
                         "memory; it composes with neither --n_parts nor "
                         "--cached_nPercent (use the host pipeline for those)")
    cfg, g, model = preprocess_features(cfg, g, model, n_class, trial_seed, extra, dev)
    dgraph, sizes = device_sampling_graph(cfg, g, dev, log)
    opt = make_optimizer(cfg, **(GRAPH_ADAM if dev.type == "cuda" else {}))
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    runner = DeviceEpochRunner(model.to(dev), opt, dgraph, sizes, cfg.batch_size,
                               g.get_train_nodes(), seed=trial_seed,
                               window=cfg.window_sampling, sampler=cfg.sampler)
    state = runner.init_state(feats)
    labels_np = g.labels.numpy()
    val_nodes = g.get_validation_nodes()
    best_val, bad, losses, secs = -np.inf, 0, [], []
    for epoch in range(cfg.n_epochs):
        with timer.phase("train"):
            t0 = time.perf_counter()
            state, loss = runner.run_epoch(state, feats, labels)
            losses.append(float(loss))
            secs.append(time.perf_counter() - t0)
        with timer.phase("validate"):
            val = runner.evaluate_nodes(state, feats, labels_np, val_nodes,
                                        seed=trial_seed + 1)
        if val > best_val:
            best_val, bad = val, 0
        else:
            bad += 1
        log.info(f"[device] epoch {epoch} loss {losses[-1]:.4f} val {val:.4f}")
        if cfg.n_stops and bad >= cfg.n_stops:
            break
    test_nodes = g.get_test_nodes().astype(np.int64)
    if cfg.exact_eval:
        pred = runner.predict_nodes_exact(state, g, feats, test_nodes)
    else:
        pred = runner.predict_nodes(state, feats, test_nodes, seed=trial_seed + 2)
    y = labels_np[test_nodes]
    test_acc = float((pred == y).mean()) if len(pred) else 0.0
    extra["device_sampling"] = True
    extra["window_sampling"] = bool(cfg.window_sampling)
    extra["exact_eval"] = bool(cfg.exact_eval)
    extra["epoch_loss"], extra["epoch_s"] = losses, secs
    return test_acc, micro_f1(pred, y), best_val, len(losses)


def run_minibatch_trial(cfg, g, trial_seed: int, dev: torch.device, model, n_class: int,
                        timer, extra: dict, log) -> tuple:
    """The host minibatch path: ``(test_acc, micro_f1, best_val, epochs run)``, with
    the per-epoch losses and times and the cache's counters in ``extra``; with
    ``--exact_eval`` the test is by exact inference."""
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.sampling import CommunityNeighborSampler
    from dgll_tpu_torch.train import MiniBatchTrainer, exact_predict, micro_f1

    cfg, g, model, book, cache, fetch = prepare_pipeline(cfg, g, model, n_class,
                                                         trial_seed, timer, extra, dev, log)
    sampler = build_sampler(cfg, g)
    train_nodes = g.get_train_nodes()
    if book is not None:
        loaders = []
        for lo, hi in book.values():
            seeds_c = train_nodes[(train_nodes >= lo) & (train_nodes < hi)]
            if len(seeds_c) == 0:
                continue
            cs = CommunityNeighborSampler(cfg.fanouts, (lo, hi), seed=cfg.seed)
            loaders.append(DataLoader(g, seeds_c, cs, min(cfg.batch_size, len(seeds_c)),
                                      seed=trial_seed, device=dev))
    else:
        loaders = [DataLoader(g, train_nodes, sampler, cfg.batch_size, seed=trial_seed,
                              device=dev)]

    tr = MiniBatchTrainer(model, make_optimizer(cfg), seed=trial_seed, device=dev)
    # the JAX CLI samples a first batch for its model's init; the port's model holds
    # its parameters already, and the draw keeps the sampler's seed stream the same
    l0 = loaders[0]
    l0.sampler.sample(l0.host_g, l0.seeds[: l0.batch_size], pad_to=l0.batch_size)
    state = tr.init_state()
    # with the cache, only its rows are on the device: the features stay on the host
    feats = None if fetch is not None else g.node_feat.to(dev)
    labels = g.labels.to(dev)
    val_loader = DataLoader(g, g.get_validation_nodes(), sampler, cfg.batch_size,
                            shuffle=False, seed=trial_seed + 1, device=dev)
    best_val, bad, losses, secs = -np.inf, 0, [], []
    for epoch in range(cfg.n_epochs):
        with timer.phase("train"):
            parts, dt = [], 0.0
            for loader in loaders:
                state, loss, d = tr.run_epoch(state, loader, feats, labels, fetch_fn=fetch)
                parts.append(loss)
                dt += d
            losses.append(float(np.mean(parts)))
            secs.append(dt)
        with timer.phase("validate"):
            val = tr.evaluate_nodes(state, val_loader, feats, labels, fetch_fn=fetch)
        if val > best_val:
            best_val, bad = val, 0
        else:
            bad += 1
        log.info(f"epoch {epoch} loss {losses[-1]:.4f} val {val:.4f} ({dt:.2f}s)")
        if cfg.n_stops and bad >= cfg.n_stops:
            break
    if cfg.exact_eval:
        test_nodes = g.get_test_nodes().astype(np.int64)
        pred = exact_predict(state.model, g, g.node_feat.to(dev) if feats is None
                             else feats, test_nodes)
        y = g.labels.numpy()[test_nodes]
        extra["exact_eval"] = True
    else:
        test_loader = DataLoader(g, g.get_test_nodes(), sampler, cfg.batch_size,
                                 shuffle=False, seed=trial_seed + 2, device=dev)
        pred, y = tr.predict_nodes(state, test_loader, feats, labels, fetch_fn=fetch)
    test_acc = float((pred == y).mean()) if len(pred) else 0.0
    if cache is not None:
        rate, lookups, _ = cache.miss_rate()
        extra["cache_miss_rate"] = float(rate)
        extra["cache_lookups"] = int(lookups)
        extra["cached_rows"] = int(cache.k)
    extra["epoch_loss"], extra["epoch_s"] = losses, secs
    return test_acc, micro_f1(pred, y), best_val, len(losses)


def run_trial(cfg, g, trial_seed: int, dev: torch.device) -> dict:
    """One trial of a configuration ``main`` has checked, on the device it resolved."""
    from dgll_tpu_torch.train import FullBatchTrainer, accuracy, micro_f1
    from dgll_tpu_torch.utils import PhaseTimer, get_logger

    log = get_logger(cfg.log_file)
    timer = PhaseTimer()
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = build_model(cfg, n_class, g.node_feat.shape[1],
                        generator=torch.Generator().manual_seed(trial_seed))

    t_start = time.perf_counter()
    extra: dict = {}
    if cfg.sampler != "full":
        trial = run_device_trial if cfg.device_sampling else run_minibatch_trial
        test_acc, f1, best_val, n_epochs = trial(cfg, g, trial_seed, dev, model, n_class,
                                                 timer, extra, log)
        return _finalize_trial(cfg, timer, t_start, extra, test_acc, f1, best_val,
                               n_epochs)
    if dev.type == "cuda":
        g, extra = attach_kernel_layouts(cfg, g)
    g = g.to(dev)

    tr = FullBatchTrainer(model, make_optimizer(cfg), seed=trial_seed, device=dev)
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
