"""The ranks as a mesh: counterpart of ``dgll_tpu/parallel/mesh.py``.

The JAX package's mesh is a grid of devices that one controller drives; the port's
is the process group of its ranks, one device each (``parallel/launch.py``). A
``Mesh`` names the group, its size and this process's rank; its collectives are
``torch.distributed``'s over that group and do nothing on a one-rank mesh (a process
outside any group). What JAX says with a sharding, each rank here holds:
``replicated`` everything, ``sharded_dim0`` its slice of dim 0.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist


@dataclass(frozen=True)
class Mesh:
    """``size`` ranks along the axis ``axis_names[0]``; ``group`` None is the default
    group."""

    axis_names: Tuple[str, ...]
    size: int
    rank: int
    group: Optional[object] = None

    @property
    def backend(self) -> Optional[str]:
        return dist.get_backend(self.group) if self.size > 1 else None


def make_mesh(axis_names: Sequence[str] = ("data",), group=None) -> Mesh:
    """The mesh of every rank of ``group`` (default: the default group; one rank,
    this process, where no group is up)."""
    if dist.is_initialized():
        return Mesh(tuple(axis_names), dist.get_world_size(group), dist.get_rank(group),
                    group)
    return Mesh(tuple(axis_names), 1, 0, group)


def replicated(mesh: Mesh, x):
    """What each rank holds of a replicated array: all of it."""
    return x


def sharded_dim0(mesh: Mesh, x):
    """What rank ``mesh.rank`` holds of an array sharded on dim 0: its slice of
    ``len(x) // mesh.size`` rows (``len(x)`` a multiple of the mesh's size)."""
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split over {mesh.size} ranks")
    rows = n // mesh.size
    return x[mesh.rank * rows:(mesh.rank + 1) * rows]


def all_reduce(mesh: Mesh, t: torch.Tensor, async_op: bool = False):
    """Sum ``t`` over the ranks in place; the work handle with ``async_op``, and None
    on a one-rank mesh, where nothing is summed."""
    if mesh.size == 1:
        return None
    return dist.all_reduce(t, group=mesh.group, async_op=async_op)


def all_gather_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """Every rank's ``x`` stacked on dim 0, in rank order (``all_gather(tiled=True)``).
    Over NCCL one all-gather; gloo has none for CUDA tensors, so there each rank's rows
    go into a zero buffer that is summed over the ranks (exact: the other ranks add
    zeros)."""
    if mesh.size == 1:
        return x
    x = x.contiguous()
    n = x.shape[0]
    if mesh.backend == "nccl":
        out = torch.empty((mesh.size * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return out
    out = torch.zeros((mesh.size * n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = x
    dist.all_reduce(out, group=mesh.group)
    return out


def _all_to_all(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=mesh.group)
    return out


class _AllToAllRows(torch.autograd.Function):
    """The all-to-all and its gradient: the same all-to-all of the gradient, since
    moving slot q of rank p to slot p of rank q is its own transpose."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return _all_to_all(mesh, x)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(ctx.mesh, g.contiguous()), None


def all_to_all_rows(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """``x [D, ...]``'s slot q sent to rank q: the result's slot p is what rank p sent
    to this rank (``jax.lax.all_to_all`` with ``split_axis=concat_axis=0``,
    ``tiled=False``). One ``all_to_all_single``, over NCCL or gloo; differentiable in
    ``x``. The identity on a one-rank mesh."""
    if x.shape[0] != mesh.size:
        raise ValueError(f"{x.shape[0]} slots over a mesh of {mesh.size} ranks")
    if mesh.size == 1:
        return x
    return _AllToAllRows.apply(x.contiguous(), mesh)


def broadcast_value(mesh: Mesh, value: float) -> float:
    """Rank 0's ``value`` on every rank (a decision all ranks must take alike)."""
    return sum_values(mesh, [value if mesh.rank == 0 else 0.0])[0]


def sum_values(mesh: Mesh, values) -> list:
    """Each of ``values`` (numbers) summed over the ranks."""
    t = torch.tensor([float(v) for v in values], dtype=torch.float64,
                     device="cuda" if mesh.backend == "nccl" else "cpu")
    all_reduce(mesh, t)
    return t.tolist()


def barrier(mesh: Mesh) -> None:
    if mesh.size > 1:
        dist.barrier(group=mesh.group)
