"""One rank of the port's multi-rank parity tests, on the CPU over gloo:

    python _torch_dp_child.py <mode> <inputs.npz> <out_dir>

started by ``dgll_tpu_torch.parallel.launch_local`` (which sets the rank's
variables). It imports the port only: JAX and the JAX package are blocked, so an
import of either fails the rank. Inputs come as an ``.npz`` made with numpy from a
seed; the rank writes ``<out_dir>/rank<r>.npz``. Modes: ``dp_step`` (3 synchronous
or one-step-stale DP steps, ``async`` in the inputs), ``device_epoch`` (one epoch of
``DeviceDPEpochRunner`` on the given draws), ``gp`` (the sharded SpMM's forward and
gradient, then 3 steps of ``make_gp_gcn_train_step``), ``fail`` (rank 1 exits 1 at
once, rank 0 waits in a barrier).
"""
import sys

for _name in ("jax", "jaxlib", "flax", "optax", "dgll_tpu"):
    sys.modules[_name] = None  # any import of these now raises ImportError

import functools  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgll_tpu_torch.data import gcn_normalize, synthetic_classification_graph  # noqa: E402
from dgll_tpu_torch.parallel import dp, gp, launch, mesh as meshes  # noqa: E402
from dgll_tpu_torch.parallel.partition import partition_graph  # noqa: E402


def graph(inp):
    return gcn_normalize(synthetic_classification_graph(
        n_node=int(inp["n_node"]), avg_degree=int(inp["avg_degree"]),
        n_class=int(inp["n_class"]), feat_dim=int(inp["feat_dim"]), power_law=1.0,
        seed=int(inp["graph_seed"]), train_frac=float(inp["train_frac"])))


def sage(inp):
    from dgll_tpu_torch.nn import GraphSAGE

    model = GraphSAGE(int(inp["feat_dim"]), int(inp["hidden"]), int(inp["n_class"]),
                      dropout=0.0)
    model.load_state_dict({k[len("p:"):]: torch.from_numpy(inp[k])
                           for k in inp.files if k.startswith("p:")})
    return model


def optimizer(inp):
    cls = torch.optim.SGD if str(inp["opt"]) == "sgd" else torch.optim.Adam
    return functools.partial(cls, lr=float(inp["lr"]))


def params(model) -> dict:
    return {f"p:{k}": v.detach().numpy() for k, v in model.state_dict().items()}


def dp_step(inp, mesh) -> dict:
    from dgll_tpu_torch.sampling import HostGraph, NeighborSampler
    from dgll_tpu_torch.train import MiniBatchTrainer, create_train_state

    g = graph(inp)
    fanouts = [int(f) for f in inp["fanouts"]]
    loader = dp.ShardedDataLoader(HostGraph.from_graph(g), g.get_train_nodes(),
                                  NeighborSampler(fanouts, seed=0), int(inp["batch"]),
                                  mesh.size, seed=0, rank=mesh.rank)
    model = sage(inp)
    state = create_train_state(model, optimizer(inp))
    tr = MiniBatchTrainer(model, None, device="cpu")
    losses, outs = [], []
    if bool(inp["async"]):
        step, init_grads = dp.make_async_dp_block_step(mesh)
        pending, it = init_grads(state), iter(loader)
        for _ in range(int(inp["steps"])):
            out, blocks = next(it)
            outs.append(out)
            blocks, x, y, m = tr.batch_inputs(blocks, g.node_feat, g.labels)
            state, pending = step(state, pending, blocks, x, y, m)
            losses.append(float(pending.loss))
        dp.apply_grads(state, pending)
    else:
        step, it = dp.make_dp_block_step(mesh), iter(loader)
        for _ in range(int(inp["steps"])):
            out, blocks = next(it)
            outs.append(out)
            blocks, x, y, m = tr.batch_inputs(blocks, g.node_feat, g.labels)
            state, loss = step(state, blocks, x, y, m)
            losses.append(float(loss))
    return {"losses": np.array(losses), "outs": np.stack(outs), **params(model)}


def device_epoch(inp, mesh) -> dict:
    from dgll_tpu_torch.sampling import DeviceCSR
    from dgll_tpu_torch.train import DeviceDPEpochRunner, EpochDraws

    g = graph(inp)
    fanouts = [int(f) for f in inp["fanouts"]]
    r = mesh.rank
    uniforms = []
    for li in range(len(fanouts)):
        key = f"u{r}_{li}"
        uniforms.append(tuple(torch.from_numpy(inp[f"{key}_{j}"]) for j in (0, 1))
                        if f"{key}_0" in inp.files else torch.from_numpy(inp[key]))
    draws = EpochDraws(torch.from_numpy(inp["order"]), uniforms)
    model = sage(inp)
    runner = DeviceDPEpochRunner(model, optimizer(inp),
                                 DeviceCSR.from_graph(g, "cpu"), fanouts, int(inp["batch"]),
                                 g.get_train_nodes(), mesh, window=bool(inp["window"]))
    state, loss = runner.run_epoch(runner.init_state(), g.node_feat, g.labels, draws=draws)
    return {"loss": np.array(float(loss)), "batch_losses": runner.batch_losses.numpy(),
            "seeds": runner._seeds.numpy(), "mask": runner._mask.numpy(),
            "n_batches": np.array(runner.n_batches), **params(model)}


class TwoLayer(torch.nn.Module):
    def __init__(self, w1, w2):
        super().__init__()
        self.w1 = torch.nn.Parameter(torch.from_numpy(w1))
        self.w2 = torch.nn.Parameter(torch.from_numpy(w2))


def two_layer_apply(model, spmm, x, generator=None):
    h = torch.relu(spmm(x @ model.w1))
    return torch.log_softmax(spmm(h @ model.w2), dim=-1)


def gp_run(inp, mesh) -> dict:
    from dgll_tpu_torch.train import create_train_state

    pg = partition_graph(graph(inp), mesh.size, strategy=str(inp["strategy"]))
    shard = gp.shard_partitioned_graph(pg, mesh, device="cpu")
    spmm = gp.make_sharded_spmm(mesh, shard)
    x = shard.node_feat.clone().requires_grad_(True)
    out = spmm(x)
    (out * meshes.sharded_dim0(mesh, torch.from_numpy(inp["cot"]))).sum().backward()
    model = TwoLayer(inp["w1"], inp["w2"])
    state = create_train_state(model, optimizer(inp))
    step = gp.make_gp_gcn_train_step(mesh, shard, two_layer_apply)
    losses = []
    with torch.no_grad():
        logits = two_layer_apply(model, spmm, shard.node_feat)
    for _ in range(int(inp["steps"])):
        state, loss = step(state, shard.node_feat, shard.labels, shard.train_mask)
        losses.append(float(loss))
    return {"out": out.detach().numpy(), "dx": x.grad.numpy(), "logits": logits.numpy(),
            "losses": np.array(losses), "w1": model.w1.detach().numpy(),
            "w2": model.w2.detach().numpy()}


def fail(inp, mesh) -> dict:
    if mesh.rank == 1:
        sys.exit(1)
    meshes.barrier(mesh)  # never returns: rank 1 is gone
    return {}


MODES = {"dp_step": dp_step, "device_epoch": device_epoch, "gp": gp_run, "fail": fail}


def main() -> None:
    torch.set_num_threads(1)
    mode, path, out_dir = sys.argv[1:4]
    launch.initialize_distributed(device="cpu")
    mesh = meshes.make_mesh()
    out = MODES[mode](np.load(path), mesh)
    np.savez(f"{out_dir}/rank{mesh.rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
