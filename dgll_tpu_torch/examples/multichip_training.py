"""Multi-rank training: data-parallel minibatch GraphSAGE, then graph-partition
full-graph GCN (the counterpart of the JAX package's ``examples/multichip_training.py``):

    python -m dgll_tpu_torch.examples.multichip_training [--n_ranks 2] [--device cpu]

It starts ``--n_ranks`` copies of itself (``parallel.launch_local``), one a device
(``cuda:(rank % device_count)``; ranks that share a card talk over gloo), and prints
rank 0's lines. Each rank trains GraphSAGE on its sub-batch of every step, the
gradients averaged over the ranks (``make_dp_block_step``), then a 2-layer GCN on its
shard of the partitioned graph, whose SpMM is kernel K1 on the shard (its plain
version on the CPU) fed by an all-gather of the ranks' rows (``make_sharded_spmm``).
"""
from __future__ import annotations

import argparse
import functools
import os
import sys

import numpy as np
import torch


def _rank_main(args) -> dict:
    from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph
    from dgll_tpu_torch.nn import GraphSAGE
    from dgll_tpu_torch.parallel import dp, gp, launch
    from dgll_tpu_torch.parallel import mesh as meshes
    from dgll_tpu_torch.parallel.partition import partition_graph
    from dgll_tpu_torch.run import resolve_device
    from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
    from dgll_tpu_torch.train import MiniBatchTrainer, create_train_state

    launch.initialize_distributed(device=args.device)
    dev = resolve_device(str(launch.rank_device(args.device)))
    mesh = meshes.make_mesh()
    d = mesh.size
    g = gcn_normalize(synthetic_classification_graph(
        n_node=256 * d, avg_degree=8, n_class=4, feat_dim=16, seed=0))
    out = {"ranks": d, "backend": mesh.backend}

    # ---- data-parallel minibatch GraphSAGE ----
    loader = dp.ShardedDataLoader(HostGraph.from_graph(g), np.arange(g.n_real_node),
                                  NeighborSampler([4, 4], seed=0), 16, d, seed=0,
                                  rank=mesh.rank)
    model = GraphSAGE(16, 32, 4, dropout=0.0, generator=torch.Generator().manual_seed(0))
    opt = functools.partial(torch.optim.Adam, lr=1e-2)
    state = create_train_state(model.to(dev), opt)
    tr = MiniBatchTrainer(model, opt, device=dev)
    step = dp.make_dp_block_step(mesh)
    feats, labels = g.node_feat.to(dev), g.labels.to(dev)
    out["dp_loss"] = []
    for _ in range(args.epochs):
        for _, blocks in loader:
            blocks, x, y, m = tr.batch_inputs(blocks, feats, labels)
            state, loss = step(state, blocks, x, y, m, tr.generator)
        out["dp_loss"].append(float(loss))

    # ---- graph-partition full-graph GCN ----
    shard = gp.shard_partitioned_graph(partition_graph(g, d), mesh, dev)
    rng = np.random.default_rng(0)
    gcn = torch.nn.ParameterDict({
        "w1": torch.from_numpy(rng.normal(0, 0.1, (16, 32)).astype(np.float32)),
        "w2": torch.from_numpy(rng.normal(0, 0.1, (32, 4)).astype(np.float32))}).to(dev)

    def apply(model, spmm, x, generator=None):
        h = torch.relu(spmm(x @ model["w1"]))
        return torch.log_softmax(spmm(h @ model["w2"]), dim=-1)

    gp_state = create_train_state(gcn, opt)
    gp_step = gp.make_gp_gcn_train_step(mesh, shard, apply)
    for _ in range(10):
        gp_state, gp_loss = gp_step(gp_state, shard.node_feat, shard.labels, shard.train_mask)
    out["gp_loss"] = float(gp_loss)
    return out


def main(argv=None) -> dict:
    import json

    from dgll_tpu_torch.parallel.launch import ENV_NPROC, is_primary, launch_local

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_ranks", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.add_argument("--epochs", type=int, default=3)
    args = p.parse_args(argv)
    if ENV_NPROC in os.environ:  # a rank
        out = _rank_main(args)
        if is_primary():
            print(json.dumps(out))
        torch.distributed.destroy_process_group()
        return out
    argv = list(sys.argv[1:] if argv is None else argv)
    done = launch_local(args.n_ranks, [sys.executable, "-m",
                                       "dgll_tpu_torch.examples.multichip_training", *argv],
                        timeout=None)
    out = json.loads(done[0].stdout.strip().splitlines()[-1])
    for e, loss in enumerate(out["dp_loss"]):
        print(f"dp epoch {e} loss {loss:.4f}")
    print(f"gp loss after 10 steps: {out['gp_loss']:.4f} ({out['ranks']} ranks, "
          f"{out['backend']})")
    return out


if __name__ == "__main__":
    main()
