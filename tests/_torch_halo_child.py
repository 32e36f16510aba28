"""One rank of the port's halo-exchange and tensor-parallel parity tests, on the CPU
over gloo:

    python _torch_halo_child.py <mode> <inputs.npz> <out_dir>

started by ``dgll_tpu_torch.parallel.launch_local``, as ``_torch_dp_child.py`` is. It
imports the port only: JAX and the JAX package are blocked. The rank writes
``<out_dir>/rank<r>.npz``. Modes: ``halo`` (the partitioned graph's arrays in the
inputs, ``pg:<field>``: the halo SpMM's forward and its gradient for the cotangent
``cot``, the all-gather SpMM's forward, the windowed halo SpMM's forward and
gradient), ``tp`` (the feature-sharded SpMM with and without weights, the TP GCN's
log-probs and the gradients of a masked NLL loss in this rank's parameter slices).
"""
import sys

for _name in ("jax", "jaxlib", "flax", "optax", "dgll_tpu"):
    sys.modules[_name] = None  # any import of these now raises ImportError

import numpy as np  # noqa: E402
import torch  # noqa: E402

from dgll_tpu_torch.parallel import gp, halo, launch, tp  # noqa: E402
from dgll_tpu_torch.parallel import mesh as meshes  # noqa: E402
from dgll_tpu_torch.parallel.partition import PartitionedGraph  # noqa: E402

PG_INTS = ("n_shard", "rows_per_shard", "e_shard", "n_real_node")


def partitioned(inp) -> PartitionedGraph:
    fields = {k[3:]: inp[k] for k in inp.files if k.startswith("pg:")}
    return PartitionedGraph(**{k: int(v) if k in PG_INTS else v for k, v in fields.items()})


def _out_and_grad(spmm, x, cot):
    x = x.clone().requires_grad_(True)
    out = spmm(x)
    (out * cot).sum().backward()
    return out.detach().numpy(), x.grad.numpy()


def halo_run(inp, mesh) -> dict:
    pg = partitioned(inp)
    shard = gp.shard_partitioned_graph(pg, mesh, device="cpu")
    plan = halo.build_halo_plan(pg)
    cot = meshes.sharded_dim0(mesh, torch.from_numpy(inp["cot"]))
    x = shard.node_feat
    out, dx = _out_and_grad(halo.make_halo_spmm(mesh, shard, plan), x, cot)
    with torch.no_grad():
        out_ag = gp.make_sharded_spmm(mesh, shard)(x).numpy()
    sw = halo.build_shard_windowed(pg, mesh.rank)
    out_win, dx_win = _out_and_grad(halo.make_halo_spmm_windowed(mesh, shard, plan, sw),
                                    x, cot)
    return {"out": out, "dx": dx, "out_ag": out_ag, "out_win": out_win, "dx_win": dx_win,
            "captured": np.array(sw.win is not None),
            "windowed_fraction": np.array(sw.windowed_fraction),
            "halo_size": np.array(plan.halo_size)}


def tp_run(inp, mesh) -> dict:
    from dgll_tpu_torch.nn import tp_params_from_numpy
    from dgll_tpu_torch.train import masked_nll_loss

    src, dst, w, n = inp["src"], inp["dst"], inp["w"], int(inp["n"])
    xs = tp.shard_features(mesh, torch.from_numpy(inp["xs"]))
    with torch.no_grad():
        weighted = tp.make_feature_sharded_spmm(mesh, src, dst, w, n, device="cpu")(xs)
        unit = tp.make_feature_sharded_spmm(mesh, src, dst, None, n, device="cpu")(xs)
    full = {k: inp[k] for k in ("w1", "w2", "b2")}
    params = {k: v.requires_grad_(True) for k, v in tp_params_from_numpy(full, mesh).items()}
    init = tp.init_tp_gcn_params(mesh, full["w1"].shape[0], full["w1"].shape[1],
                                 full["w2"].shape[1], seed=int(inp["seed"]), device="cpu")
    apply = tp.make_tp_gcn_apply(mesh, src, dst, w, n, device="cpu")
    logp = apply(params, torch.from_numpy(inp["x"]))
    loss = masked_nll_loss(logp, torch.from_numpy(inp["labels"]),
                           torch.from_numpy(inp["mask"]))
    loss.backward()
    return {"weighted": weighted.numpy(), "unit": unit.numpy(),
            "logp": logp.detach().numpy(), "loss": np.array(loss.item()),
            **{f"init_{k}": v.numpy() for k, v in init.items()},
            **{f"d{k}": v.grad.numpy() for k, v in params.items()}}


MODES = {"halo": halo_run, "tp": tp_run}


def main() -> None:
    torch.set_num_threads(1)
    mode, path, out_dir = sys.argv[1:4]
    launch.initialize_distributed(device="cpu")
    mesh = meshes.make_mesh(("model",) if mode == "tp" else ("data",))
    out = MODES[mode](np.load(path), mesh)
    np.savez(f"{out_dir}/rank{mesh.rank}.npz", **out)
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
