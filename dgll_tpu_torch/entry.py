"""Entry points for a quick check of the flagship model, ``entry(device="cuda")``, and
of the multi-rank paths, ``dryrun_multichip(n_devices, device="cuda")``.

Counterpart of ``entry()`` in the JAX package's entry hooks (``__graft_entry__.py``):
the flagship model, minibatch GraphSAGE, on blocks sampled on the host from the same
graph with the same sampler seed and sizes (2,000 nodes of average degree 8, 8
classes, 64 features, ``gcn_normalize``; fanouts [10, 5], a batch of the first 64
nodes; hidden width 128, dropout 0; weights from seed 0). ``entry`` returns
``(forward, args)``; ``forward(*args)`` is the model's output on the batch in eval
mode, ``[64, 8]`` log-probabilities.

``dryrun_multichip(n)`` is the counterpart of ``dryrun_multichip`` there: one step (or
epoch, or forward) of each of the package's nine multi-rank flows, on ``n`` ranks
(``parallel.launch_local``, or the ranks of the process group it is called in) over
the flagship's graph at ``64 n`` nodes: (1) data-parallel GraphSAGE, (2) the
graph-partition GCN through the halo exchange, (3) the tensor-parallel GCN forward,
(4) the one-step-stale DP step, (5) ``make_partitioned_spmm``'s automatic choice,
(6) ``DeviceEpochRunner``, (7) ``DeviceDPEpochRunner`` with block-window draws, (8)
the same with FastGCN on ``build_device_lap``, (9) the graph-partition GCN's loss
through the windowed halo SpMM. Rank 0 prints the JAX package's line. On one card the
ranks share it over gloo.

    python -m dgll_tpu_torch.entry [--n_devices 2] [--device cpu]
"""
from __future__ import annotations

import functools
import os
import sys

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


def _gp_apply(params, spmm, x, generator=None):
    """The dry run's graph-partition GCN: two layers, ReLU between, log-softmax."""
    h = torch.relu(spmm(x @ params["w1"]))
    return torch.log_softmax(spmm(h @ params["w2"]), dim=-1)


def _dryrun_rank(n_devices: int, device) -> str:
    """This rank's share of the nine flows; the line (rank 0 prints it)."""
    from dgll_tpu_torch.nn import GCN, GraphSAGE
    from dgll_tpu_torch.parallel import dp, gp, halo, tp
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.parallel.launch import is_primary, rank_device
    from dgll_tpu_torch.parallel.partition import partition_graph
    from dgll_tpu_torch.sampling import DeviceCSR, NeighborSampler, build_device_lap
    from dgll_tpu_torch.train import (GRAPH_ADAM, DeviceDPEpochRunner, DeviceEpochRunner,
                                      create_train_state)

    mesh = meshes.make_mesh()
    if mesh.size != n_devices:
        raise ValueError(f"dryrun_multichip({n_devices}) in a group of {mesh.size} ranks")
    dev = rank_device(device, mesh.rank)
    g, hg, _, model, _, _ = flagship(dev, n_node=64 * n_devices, batch=4 * n_devices)
    adam = functools.partial(torch.optim.Adam, lr=1e-2)
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    all_nodes = np.arange(g.n_real_node)

    # 1) data-parallel minibatch GraphSAGE: this rank's sub-batch of one step
    loader = dp.ShardedDataLoader(hg, all_nodes, NeighborSampler([4, 3], seed=0), 4,
                                  n_devices, seed=0, rank=mesh.rank)
    _, blocks = next(iter(loader))
    blocks = [b.to(dev) for b in blocks]
    x = feats.index_select(0, blocks[0].src_ids)
    y = labels.index_select(0, blocks[-1].dst_ids)
    m = blocks[-1].dst_mask
    state = create_train_state(model, adam)
    state, loss = dp.make_dp_block_step(mesh)(state, blocks, x, y, m)

    # 2) graph-partition full-graph GCN step, halo rows exchanged in one all-to-all
    pg = partition_graph(g, n_devices)
    shard = gp.shard_partitioned_graph(pg, mesh, dev)
    plan = halo.build_halo_plan(pg)
    spmm = halo.make_halo_spmm(mesh, shard, plan)
    d_in = pg.node_feat.shape[1]
    rng = np.random.default_rng(0)
    gp_params = torch.nn.ParameterDict({
        "w1": torch.from_numpy(rng.normal(0, 0.1, (d_in, 32)).astype(np.float32)),
        "w2": torch.from_numpy(rng.normal(0, 0.1, (32, 8)).astype(np.float32))}).to(dev)
    gp_state = create_train_state(gp_params, adam)
    gp_step = gp.make_gp_gcn_train_step(mesh, shard, _gp_apply, spmm)
    gp_state, gp_loss = gp_step(gp_state, shard.node_feat, shard.labels, shard.train_mask)

    # 3) tensor-parallel 2-layer GCN forward: column- then row-parallel weights, one
    #    all-reduce, SpMMs on this rank's feature columns
    n = g.n_real_node
    src, dst = g.src[: g.n_real_edge].numpy(), g.dst[: g.n_real_edge].numpy()
    ew = g.edge_weight[: g.n_real_edge].numpy()
    tp_mesh = meshes.make_mesh(("model",))
    tp_params = tp.init_tp_gcn_params(tp_mesh, d_in, hidden=8 * n_devices, n_class=8,
                                      seed=0, device=dev)
    with torch.no_grad():
        tp_out = tp.make_tp_gcn_apply(tp_mesh, src, dst, ew, n, device=dev)(
            tp_params, feats[:n])

    # 4) one-step-stale DP step from the DP step's parameters
    a_step, a_init = dp.make_async_dp_block_step(mesh)
    state = create_train_state(model, adam)
    state, pending = a_step(state, a_init(state), blocks, x, y, m)
    a_loss = pending.loss

    # 5) the partitioned SpMM with the automatic choice of exchange
    auto_spmm, auto_strategy = halo.make_partitioned_spmm(mesh, pg, d_in, "auto", dev)
    with torch.no_grad():
        auto_spmm(shard.node_feat)

    # the device epochs replay a CUDA graph on the card: a capturable Adam there
    graph_adam = functools.partial(torch.optim.Adam, lr=1e-2,
                                   **(GRAPH_ADAM if dev.type == "cuda" else {}))

    def sage():  # the flagship's model, fresh from its seed
        return GraphSAGE(d_in, 128, 8, dropout=0.0,
                         generator=torch.Generator().manual_seed(0))

    # 6) one device-resident epoch (sampling on the device)
    csr = DeviceCSR.from_graph(g, dev)
    runner = DeviceEpochRunner(sage(), graph_adam, csr, [4, 3], 4 * n_devices, all_nodes,
                               seed=0)
    _, dev_loss = runner.run_epoch(runner.init_state(), feats, labels)

    # 7) data parallel over device sampling: each rank samples its sub-batch
    drunner = DeviceDPEpochRunner(sage(), graph_adam, csr, [4, 3], 4, all_nodes, mesh,
                                  seed=0, window=True)
    _, dpd_loss = drunner.run_epoch(drunner.init_state(), feats, labels)

    # 8) data parallel over device-resident layer-wise (FastGCN) sampling
    lap = build_device_lap(g, k=16, device=dev)
    n_class = int(g.labels.max()) + 1
    gcn = GCN(d_in, 16, n_class, dropout=0.0, generator=torch.Generator().manual_seed(0))
    lrunner = DeviceDPEpochRunner(gcn, graph_adam, lap, [12, 8], 4, all_nodes, mesh,
                                  seed=0, sampler="fastgcn")
    _, lw_loss = lrunner.run_epoch(lrunner.init_state(), feats, labels)

    # 9) the graph-partition GCN's loss through the windowed halo SpMM: each rank's
    #    captured local edges through K2, the rest through the halo exchange and K1
    sw = halo.build_shard_windowed(pg, mesh.rank)
    win_spmm = halo.make_halo_spmm_windowed(mesh, shard, plan, sw)
    with torch.no_grad():
        logp = _gp_apply(gp_params, win_spmm, shard.node_feat)
        nll = -logp.gather(-1, shard.labels[:, None].long())[:, 0]
        mask = shard.train_mask.to(nll.dtype)
        sums = torch.stack([(nll * mask).sum(), mask.sum()]).double()
        meshes.all_reduce(mesh, sums)
        win_loss = sums[0] / sums[1].clamp_min(1.0)

    line = (f"dryrun_multichip({n_devices}): dp_loss={float(loss):.4f} "
            f"async_dp_loss={float(a_loss):.4f} gp_loss={float(gp_loss):.4f} "
            f"tp_out={tuple(tp_out.shape)} auto_strategy={auto_strategy} "
            f"device_epoch_loss={float(dev_loss):.4f} "
            f"dp_device_sampling_loss={float(dpd_loss):.4f} "
            f"dp_device_fastgcn_loss={float(lw_loss):.4f} "
            f"windowed_halo_loss={float(win_loss):.4f} "
            f"(windowed_fraction={sw.windowed_fraction:.2f}) OK")
    if is_primary():
        print(line, flush=True)
    return line


def dryrun_multichip(n_devices: int, device="cuda", timeout: float = 600.0) -> str:
    """The nine multi-rank flows on ``n_devices`` ranks on ``device`` (the ranks' cards
    by default, ``"cpu"`` in the tests): in the process group this is called in, or
    in ``n_devices`` ranks started by ``launch_local``, whose rank 0's line this
    prints. Returns the line, which ends in ``OK``; a failed flow raises."""
    import torch.distributed as dist

    from dgll_tpu_torch.parallel.launch import launch_local

    if dist.is_initialized():
        return _dryrun_rank(n_devices, device)
    done = launch_local(n_devices, [sys.executable, "-m", "dgll_tpu_torch.entry",
                                    "--n_devices", str(n_devices), "--device", str(device)],
                        timeout=timeout)
    line = done[0].stdout.strip().splitlines()[-1]
    print(line)
    return line


def main(argv=None) -> str:
    import argparse

    from dgll_tpu_torch.parallel.launch import ENV_NPROC, initialize_distributed

    p = argparse.ArgumentParser(description="the multi-rank dry run")
    p.add_argument("--n_devices", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ENV_NPROC not in os.environ:
        return dryrun_multichip(args.n_devices, args.device)
    if args.device == "cpu":
        torch.set_num_threads(1)  # the ranks share the host's cores
    initialize_distributed(device=args.device)
    try:
        return _dryrun_rank(args.n_devices, args.device)
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
