"""Training CLI: ``python -m dgll_tpu_torch.run --Model GCN|GAT|GraphSAGE|GIN ...``

Counterpart of ``dgll_tpu/run.py``, for the part of it this package has ported, on
one device: the synthetic dataset, a saved graph (``--dataset <path>.graph`` or
``.pkl``, ``data.save_graph``'s pickle) or a planetoid directory (``--dataset
<dir>/<name>``, ``<name>.content`` and ``<name>.cites``); full-batch GCN, GAT,
GraphSAGE and GIN (``--samp_type full``), and the minibatch paths for all four, with
the uniform neighbour sampler (``--samp_type neighbor``, the default) or the
layer-wise FastGCN and LADIES samplers (``--samp_type fastgcn|ladies``, layer sizes
from ``--n_samp`` and ``--samp_growth_rate``, with ``--flatten`` and ``--wrs``). The
host path samples
on the host, a prefetching ``DataLoader`` moves each batch's blocks to the device and
``MiniBatchTrainer`` steps, with the device feature cache (``--cached_nPercent``)
and the community pipeline (``--n_parts``). The device path (``--device_sampling``)
keeps the CSR (or, for the layer-wise samplers, the normalised Laplacian), features
and labels on the device and runs ``DeviceEpochRunner``'s epochs, a CUDA-graph
replay a batch; its neighbour draws are per-slot or ``--window_sampling``, its
layer-wise draws with replacement (``--wrs`` is the host path's).
``--exact_eval`` takes the test accuracy of either minibatch path by exact
full-graph inference, on features cast to the compute type. ``--dtype bfloat16``
sets every model's compute type, GAT's included. ``--checkpoint_dir`` saves the
trained parameters at step ``epochs + resumed_from`` (``train.CheckpointManager``)
and ``--resume`` starts from the latest step there, on every branch.
``--preprocess`` precomputes each node's neighbour-mean features, concatenates them
to the raw ones and drops the outermost sampled hop and one layer, on either
minibatch path. It prints the same JSON keys.

Data parallelism (``--n_devices D`` > 1, a minibatch sampler) runs D ranks on
``torch.distributed`` (``parallel/``): started without a launcher, ``main`` starts D
copies of itself through ``launch_local`` and returns (and prints) rank 0's result;
under a launcher (``DGLL_NUM_PROCESSES`` set) it joins the group. Rank ``r`` runs on
``cuda:(r % device_count)`` (over gloo where ranks share a card) or the CPU. The host
path (``--samp_type neighbor``) samples every sub-batch of a step on every rank and
keeps its own, with the synchronous or the one-step-stale step (``--async_dp``), COG
routing (``--n_parts``, one per-device batch for all communities) and a cache on
each rank (``--cached_nPercent``; its counters summed over the ranks); the device
path (``--device_sampling``, neighbor, FastGCN or LADIES) runs
``DeviceDPEpochRunner``. Every rank evaluates alike and takes rank 0's validation
accuracy, so all stop together; only rank 0 writes a checkpoint. ``--samp_type
full`` trains on one device, as the JAX CLI does.

On a CUDA device the graph gets the kernel layouts, whatever its size. A GCN or GIN
run attaches ``g.with_windowed(reorder=True).with_chunked()`` as the JAX CLI does:
where the graph has source locality, or a relabelling gives it some, every layer
aggregates through the windowed kernel K2 and K1 on the residual edges; where it
declines, through K1 alone. Every GAT layer runs the fused attention op (K3-K7 and
K1) on ``with_chunked()`` only, since GAT never reads the windowed layout. The JAX
package's 100k-edge threshold is the TPU's launch-overhead rule; the port's layers
have no plain version on the card. A full-batch GraphSAGE run attaches no layout:
its mean and sum run K1 on layouts built from the graph's edges on the device at the
first step (``Graph.mean_chunked``), its max plain PyTorch (XLA in the JAX
package).

On the host minibatch path the graph stays on the host for the sampler, and the
features and labels live on the device; with the cache only the cached rows do, and
the misses come from the host store.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import re
import time

import numpy as np
import torch

# The port's names for its SpMM kernels (K1, and K2 composed with K1 on the
# residual) and its fused GAT op, reported as ``spmm_kernel`` and ``gat_kernel``.
SPMM_KERNEL = "spmm_csr_cuda"
WINDOWED_KERNEL = "spmm_windowed_cuda"
GAT_KERNEL = "gat_attention_fused"
N_PARTS_NEEDS_NEIGHBOR = ("--n_parts > 1 requires --samp_type neighbor "
                          "(community-restricted neighbour sampling)")
DEVICE_SAMPLING_ALONE = ("--device_sampling keeps the graph and features in device "
                         "memory; it composes with neither --n_parts nor "
                         "--cached_nPercent (use the host pipeline for those)")


def is_data_parallel(cfg) -> bool:
    """``--n_devices`` > 1 on a minibatch path (full batch trains on one device)."""
    return cfg.n_devices > 1 and cfg.sampler != "full"


def check_supported(cfg) -> None:
    """Raise ``ValueError`` for a configuration the JAX CLI refuses: an unknown model
    or sampler, and, before any rank starts, the data-parallel branch's refusals."""
    if cfg.model.upper() not in ("GCN", "GAT", "GRAPHSAGE", "SAGE", "GIN"):
        raise ValueError(f"unknown model {cfg.model!r}")
    if cfg.sampler not in ("full", "neighbor", "fastgcn", "ladies"):
        raise ValueError(f"unknown sampler {cfg.sampler!r}")
    if is_data_parallel(cfg):
        if cfg.sampler != "neighbor" and not (
                cfg.device_sampling and cfg.sampler in ("fastgcn", "ladies")):
            raise ValueError("--n_devices > 1 requires --samp_type neighbor (host "
                             "sampling), or --device_sampling with neighbor|fastgcn|ladies")
        if cfg.device_sampling and (cfg.n_parts > 1 or cfg.cached_percent > 0):
            raise ValueError(DEVICE_SAMPLING_ALONE)


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
    """The synthetic graph, a saved graph (a path ending in ``.graph`` or ``.pkl``)
    or a planetoid directory (``<dir>/<name>``), GCN-normalised."""
    from dgll_tpu_torch.data import (
        gcn_normalize,
        load_graph,
        load_planetoid,
        synthetic_classification_graph,
    )

    if cfg.dataset == "synthetic":
        g = synthetic_classification_graph(
            n_node=cfg.n_node, avg_degree=cfg.avg_degree, n_class=cfg.n_class,
            feat_dim=cfg.feat_dim, power_law=1.0, seed=cfg.seed,
        )
    elif cfg.dataset.endswith((".graph", ".pkl")):
        g = load_graph(cfg.dataset)
    else:
        path, name = os.path.split(cfg.dataset.rstrip("/"))
        g = load_planetoid(path or ".", name)
    return gcn_normalize(g)


def _dtype(cfg):
    return {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16}.get(cfg.dtype)


def build_model(cfg, n_class: int, in_features: int, generator=None):
    from dgll_tpu_torch.nn import GAT, GCN, GINNode, GraphSAGE

    if cfg.model.upper() == "GAT":
        return GAT(in_features, hidden=cfg.nhid, n_class=n_class, num_heads=cfg.n_heads,
                   n_layers=cfg.n_layers, dropout=cfg.dropout, dtype=_dtype(cfg),
                   generator=generator)
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


def maybe_restore(cfg, model, extra: dict) -> None:
    """``--resume``: load the latest checkpointed parameters of ``--checkpoint_dir``
    into ``model`` in place and record the step as ``extra["resumed_from"]``; nothing
    without the flags or a saved step (the JAX CLI's ``_maybe_restore_params``)."""
    if not (cfg.resume and cfg.checkpoint_dir):
        return
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.train import CheckpointManager

    meshes.barrier(meshes.make_mesh())  # every rank reads what rank 0 wrote
    mgr = CheckpointManager(cfg.checkpoint_dir)
    step = mgr.latest_step()
    if step is not None:
        model.load_state_dict(mgr.restore(model.state_dict(), step))
        extra["resumed_from"] = int(step)
    mgr.close()


def _finalize_trial(cfg, timer, t_start, extra, test_acc, f1, best_val,
                    n_epochs_run, model):
    """Shared trial epilogue: the checkpoint of ``model``'s parameters at step
    ``epochs + resumed_from`` (``--checkpoint_dir``), the per-dataset headline metric
    and the result dict."""
    from dgll_tpu_torch.parallel.launch import is_primary
    from dgll_tpu_torch.train.metrics import metric_for_dataset

    total = time.perf_counter() - t_start
    if cfg.checkpoint_dir and is_primary():
        from dgll_tpu_torch.train import CheckpointManager

        mgr = CheckpointManager(cfg.checkpoint_dir)
        mgr.save(n_epochs_run + (extra.get("resumed_from") or 0), model.state_dict(),
                 wait=True)
        mgr.close()
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
        return g, extra  # its layers derive their layouts on the device
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
        if cfg.sampler != "neighbor":
            raise ValueError(N_PARTS_NEEDS_NEIGHBOR)
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
    ``DeviceEpochRunner``'s (a CUDA-graph replay a batch on a CUDA device; with
    ``--n_devices`` > 1 this rank's ``DeviceDPEpochRunner``), validation
    and test by the device-sampled sweep or, with ``--exact_eval``, the test by exact
    inference. Returns ``(test_acc, micro_f1, best_val, epochs run, model)``, the
    model as trained (``--preprocess`` rebuilds it), with the per-epoch losses and
    times in ``extra``."""
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.train import (
        GRAPH_ADAM,
        DeviceDPEpochRunner,
        DeviceEpochRunner,
        exact_predict,
        micro_f1,
    )

    if cfg.n_parts > 1 or cfg.cached_percent > 0:
        raise ValueError(DEVICE_SAMPLING_ALONE)
    cfg, g, model = preprocess_features(cfg, g, model, n_class, trial_seed, extra, dev)
    maybe_restore(cfg, model, extra)
    dgraph, sizes = device_sampling_graph(cfg, g, dev, log)
    opt = make_optimizer(cfg, **(GRAPH_ADAM if dev.type == "cuda" else {}))
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    mesh = meshes.make_mesh()
    common = dict(seed=trial_seed, window=cfg.window_sampling, sampler=cfg.sampler)
    if is_data_parallel(cfg):
        runner = DeviceDPEpochRunner(model.to(dev), opt, dgraph, sizes,
                                     max(cfg.batch_size // mesh.size, 1),
                                     g.get_train_nodes(), mesh, **common)
        extra.update(n_devices=mesh.size, async_dp=False,
                     resumed_from=extra.get("resumed_from"))
    else:
        runner = DeviceEpochRunner(model.to(dev), opt, dgraph, sizes, cfg.batch_size,
                                   g.get_train_nodes(), **common)
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
            val = meshes.broadcast_value(mesh, runner.evaluate_nodes(
                state, feats, labels_np, val_nodes, seed=trial_seed + 1))
        if val > best_val:
            best_val, bad = val, 0
        else:
            bad += 1
        log.info(f"[device] epoch {epoch} loss {losses[-1]:.4f} val {val:.4f}")
        if cfg.n_stops and bad >= cfg.n_stops:
            break
    test_nodes = g.get_test_nodes().astype(np.int64)
    if cfg.exact_eval:
        pred = exact_predict(state.model, g, feats, test_nodes, _dtype(cfg))
    else:
        pred = runner.predict_nodes(state, feats, test_nodes, seed=trial_seed + 2)
    y = labels_np[test_nodes]
    test_acc = float((pred == y).mean()) if len(pred) else 0.0
    extra["device_sampling"] = True
    extra["window_sampling"] = bool(cfg.window_sampling)
    extra["exact_eval"] = bool(cfg.exact_eval)
    extra["epoch_loss"], extra["epoch_s"] = losses, secs
    return test_acc, micro_f1(pred, y), best_val, len(losses), model


def run_minibatch_trial(cfg, g, trial_seed: int, dev: torch.device, model, n_class: int,
                        timer, extra: dict, log) -> tuple:
    """The host minibatch path: ``(test_acc, micro_f1, best_val, epochs run, model)``,
    with the per-epoch losses and times and the cache's counters in ``extra``; with
    ``--exact_eval`` the test is by exact inference."""
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.sampling import CommunityNeighborSampler
    from dgll_tpu_torch.train import MiniBatchTrainer, exact_predict, micro_f1

    cfg, g, model, book, cache, fetch = prepare_pipeline(cfg, g, model, n_class,
                                                         trial_seed, timer, extra, dev, log)
    maybe_restore(cfg, model, extra)
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
                             else feats, test_nodes, _dtype(cfg))
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
    return test_acc, micro_f1(pred, y), best_val, len(losses), model


def run_dp_trial(cfg, g, trial_seed: int, dev: torch.device, model, n_class: int,
                 timer, extra: dict, log) -> tuple:
    """The host minibatch path over ``--n_devices`` ranks (the JAX CLI's
    ``_run_dp_trial``), on this rank: each step's sub-batches sampled on every rank,
    this rank's trained, the gradients averaged (or, with ``--async_dp``, applied one
    step stale); COG's communities each through a loader of one shared per-device
    batch; each rank's cache counters summed over the ranks at the end. Returns
    ``(test_acc, micro_f1, best_val, epochs run, model)``."""
    from dgll_tpu_torch.dataloader import DataLoader
    from dgll_tpu_torch.parallel import dp
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.sampling import CommunityNeighborSampler, HostGraph
    from dgll_tpu_torch.train import MiniBatchTrainer, create_train_state, micro_f1

    mesh = meshes.make_mesh()
    cfg, g, model, book, cache, fetch = prepare_pipeline(cfg, g, model, n_class,
                                                         trial_seed, timer, extra, dev, log)
    d = mesh.size
    hg = HostGraph.from_graph(g)
    sampler = build_sampler(cfg, g)
    per_dev = max(cfg.batch_size // d, 1)
    train_nodes = g.get_train_nodes()
    if book is not None:
        # one per-device batch for every community, so that every step has the same
        # shapes; communities with fewer seeds than a step are skipped (logged)
        per_comm = [train_nodes[(train_nodes >= lo) & (train_nodes < hi)]
                    for lo, hi in book.values()]
        bc = max(1, min(per_dev, max((len(sc) for sc in per_comm), default=0) // d))
        loaders, skipped = [], 0
        for (lo, hi), seeds_c in zip(book.values(), per_comm):
            if len(seeds_c) < bc * d:
                skipped += len(seeds_c)
                continue
            cs = CommunityNeighborSampler(cfg.fanouts, (lo, hi), seed=cfg.seed)
            loaders.append(dp.ShardedDataLoader(hg, seeds_c, cs, bc, d, seed=trial_seed,
                                                rank=mesh.rank))
        if skipped:
            log.info(f"community DP: skipped {skipped} train seeds in communities "
                     f"smaller than one step ({bc * d}); one shared per-device batch "
                     f"{bc} keeps one step shape")
    else:
        loaders = [dp.ShardedDataLoader(hg, train_nodes, sampler, per_dev, d,
                                        seed=trial_seed, rank=mesh.rank)]
    loaders = [ld for ld in loaders if len(ld) > 0]
    if not loaders:
        raise ValueError(
            f"batch_size {cfg.batch_size} over {d} devices needs at least {per_dev * d} "
            f"train seeds per (community) loader; have {len(train_nodes)} — lower "
            f"--batch_size or raise the train split")
    # with the cache only its rows are on the device: the features stay on the host
    feats = None if fetch is not None else g.node_feat.to(dev)
    labels = g.labels.to(dev)
    # the JAX CLI samples a first step for its model's init, and gathers device 0's
    # features through the cache: the draws keep the samplers' and the loader's
    # streams the same, the fetch the cache's counters
    _, blocks0 = next(iter(loaders[0]))
    if fetch is not None and mesh.rank == 0:
        fetch(blocks0[0].src_ids)
    maybe_restore(cfg, model, extra)
    opt = make_optimizer(cfg)
    state = create_train_state(model.to(dev), opt)
    if cfg.async_dp:
        step, init_grads = dp.make_async_dp_block_step(mesh)
        pending = init_grads(state)
    else:
        step = dp.make_dp_block_step(mesh)
    ev = MiniBatchTrainer(model, opt, seed=trial_seed, device=dev)
    val_loader = DataLoader(g, g.get_validation_nodes(), sampler, cfg.batch_size,
                            shuffle=False, seed=trial_seed + 1, device=dev)

    def primary_counts(fn):
        """``fn()`` with the cache's counters kept only on rank 0: every rank
        evaluates the same batches, which the JAX controller counts once."""
        before = None if cache is None else (cache.lookups, cache.misses)
        out = fn()
        if before is not None and mesh.rank != 0:
            cache.lookups, cache.misses = before
        return out

    best_val, bad, losses, secs = -np.inf, 0, [], []
    for epoch in range(cfg.n_epochs):
        with timer.phase("train"):
            t0 = time.perf_counter()
            batch_losses, last = [], None
            for loader in loaders:
                for _, blocks in loader:
                    x = None if fetch is None else fetch(blocks[0].src_ids)
                    blocks, x, y, m = ev.batch_inputs(blocks, feats, labels, x)
                    if cfg.async_dp:
                        state, pending = step(state, pending, blocks, x, y, m, ev.generator)
                        if last is not None:  # applied by this step: its mean is ready
                            batch_losses.append(last.loss.clone())
                        last = pending
                    else:
                        state, loss = step(state, blocks, x, y, m, ev.generator)
                        batch_losses.append(loss.clone())
            if last is not None:
                batch_losses.append(last.loss.clone())
            losses.append(float(torch.stack(batch_losses).mean()))
            secs.append(time.perf_counter() - t0)
        with timer.phase("validate"):
            val = meshes.broadcast_value(mesh, primary_counts(
                lambda: ev.evaluate_nodes(state, val_loader, feats, labels,
                                          fetch_fn=fetch)))
        if val > best_val:
            best_val, bad = val, 0
        else:
            bad += 1
        log.info(f"[dp x{d}{' async' if cfg.async_dp else ''}] epoch {epoch} "
                 f"loss {losses[-1]:.4f} val {val:.4f}")
        if cfg.n_stops and bad >= cfg.n_stops:
            break
    if cfg.async_dp:
        state = dp.apply_grads(state, pending)  # the last step's gradients
    test_loader = DataLoader(g, g.get_test_nodes(), sampler, cfg.batch_size,
                             shuffle=False, seed=trial_seed + 2, device=dev)
    pred, y = primary_counts(lambda: ev.predict_nodes(state, test_loader, feats, labels,
                                                      fetch_fn=fetch))
    if cache is not None:
        counts = meshes.sum_values(mesh, [cache.lookups, cache.misses])
        cache.lookups, cache.misses = int(counts[0]), int(counts[1])
        rate, lookups, _ = cache.miss_rate()
        extra.update(cache_miss_rate=float(rate), cache_lookups=int(lookups),
                     cached_rows=int(cache.k))
    extra.update(n_devices=d, async_dp=bool(cfg.async_dp),
                 resumed_from=extra.get("resumed_from"), epoch_loss=losses, epoch_s=secs)
    test_acc = float((pred == y).mean()) if len(pred) else 0.0
    return test_acc, micro_f1(pred, y), best_val, len(losses), model


def run_trial(cfg, g, trial_seed: int, dev: torch.device) -> dict:
    """One trial of a configuration ``main`` has checked, on the device it resolved."""
    from dgll_tpu_torch.train import FullBatchTrainer, accuracy, micro_f1
    from dgll_tpu_torch.utils import PhaseTimer, get_logger

    log = get_logger(cfg.log_file, rank=torch.distributed.get_rank()
                     if torch.distributed.is_initialized() else None)
    timer = PhaseTimer()
    n_class = int(g.labels[: g.n_real_node].max()) + 1
    model = build_model(cfg, n_class, g.node_feat.shape[1],
                        generator=torch.Generator().manual_seed(trial_seed))

    t_start = time.perf_counter()
    extra: dict = {}
    if cfg.sampler != "full":
        trial = (run_device_trial if cfg.device_sampling else
                 run_dp_trial if is_data_parallel(cfg) else run_minibatch_trial)
        test_acc, f1, best_val, n_epochs, model = trial(cfg, g, trial_seed, dev, model,
                                                        n_class, timer, extra, log)
        return _finalize_trial(cfg, timer, t_start, extra, test_acc, f1, best_val,
                               n_epochs, model)
    if dev.type == "cuda":
        g, extra = attach_kernel_layouts(cfg, g)
    g = g.to(dev)
    maybe_restore(cfg, model, extra)

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
                           hist.best_val, len(hist.epochs), state.model)


def launch_ranks(cfg, argv, timeout=None) -> dict:
    """Start ``--n_devices`` ranks of this CLI (``launch_local``) and return rank 0's
    result. A ``ValueError`` that ends a rank is raised here again, as the JAX CLI
    raises it; any other failure of a rank raises ``RankFailed``."""
    import sys

    from dgll_tpu_torch.parallel.launch import RankFailed, launch_local

    argv = list(sys.argv[1:] if argv is None else argv)
    try:
        done = launch_local(cfg.n_devices, [sys.executable, "-m", "dgll_tpu_torch.run",
                                            *argv], timeout=timeout)
    except RankFailed as e:
        # the traceback's last line, which torch.distributed prefixes with the rank
        last = re.match(r"(?:\[rank\d+\]: )?ValueError: (.*)",
                        (e.stderr.strip().splitlines() or [""])[-1])
        if last:
            raise ValueError(last.group(1)) from e
        raise
    return json.loads(done[0].stdout.strip().splitlines()[-1])


def main(argv=None, timeout=None) -> dict:
    """Parse the flags, train and print one JSON line, which it returns. With
    ``--n_devices`` > 1 on a minibatch path and no launcher, it starts the ranks
    (``timeout``: their limit in seconds, default none) and returns rank 0's line."""
    from dgll_tpu_torch.parallel.launch import (
        ENV_NPROC,
        initialize_distributed,
        is_primary,
        rank_device,
    )
    from dgll_tpu_torch.utils import parse_train_config

    cfg = parse_train_config(argv)
    check_supported(cfg)
    if is_data_parallel(cfg):
        if ENV_NPROC not in os.environ:
            out = launch_ranks(cfg, argv, timeout)
            print(json.dumps(out, default=str))
            return out
        initialize_distributed(device=cfg.device)
        world = torch.distributed.get_world_size()
        if world != cfg.n_devices:
            raise ValueError(f"--n_devices {cfg.n_devices}, but {world} ranks joined")
        dev = resolve_device(str(rank_device(cfg.device)))
    else:
        dev = resolve_device(cfg.device)
    g = build_dataset(cfg)
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
    if is_primary():
        print(json.dumps(out, default=str))
    return out


if __name__ == "__main__":
    main()
