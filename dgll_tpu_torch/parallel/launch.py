"""Multi-process launch and process-group set-up on ``torch.distributed``.

Counterpart of ``dgll_tpu/parallel/launch.py``. The JAX package runs one controller
over D mesh devices; the port runs D ranks, one process each, rank ``r`` on device
``cuda:(r % device_count)`` (or the CPU). Every rank calls
:func:`initialize_distributed`, which reads the same variables as the JAX package
(``DGLL_COORDINATOR``, ``DGLL_NUM_PROCESSES``, ``DGLL_PROCESS_ID``) and joins the
process group over ``tcp://<coordinator>``. The backend is NCCL where the ranks are
on CUDA and the host has a card for each of them, else gloo: the CPU, and several
ranks sharing one card (NCCL refuses two ranks on one GPU).

``launch_local`` is the ``mp.spawn`` twin for one host: it starts N copies of a
command with those variables set, each child's output in a temporary file (never a
pipe). Unlike the JAX package's, which waits for the children in order, it kills the
others as soon as one exits non-zero, so that a dead rank does not leave the rest
blocked in a collective until the group's timeout.

    python -m dgll_tpu_torch.parallel.launch [--n_processes 2] [--device cpu]

runs the smoke: an all-reduce of ``rank + 1`` over the ranks.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import torch

ENV_COORD = "DGLL_COORDINATOR"
ENV_NPROC = "DGLL_NUM_PROCESSES"
ENV_PID = "DGLL_PROCESS_ID"
PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TIMEOUT_S = 60.0  # a collective that waits longer than this raises


def choose_backend(device, world_size: int) -> str:
    """``nccl`` where the ranks are on CUDA and the host has a card for each of them,
    else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world_size:
        return "nccl"
    return "gloo"


def rank_device(device, rank: Optional[int] = None) -> torch.device:
    """The device rank ``rank`` (default: this process's) runs on: ``cuda:(rank %
    device_count)`` for a CUDA ``device`` without an index, else ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"--device {device}: no CUDA device is available")
    if rank is None:
        rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device="cuda",
    timeout_s: float = TIMEOUT_S,
) -> bool:
    """Join the process group (``init_process_group`` over
    ``tcp://<coordinator_address>``), the arguments defaulting to the variables that
    ``launch_local`` or a scheduler sets. Returns False, and does nothing, where there
    is one process and no coordinator; True once the group is up. ``device`` is where
    the ranks run (it picks the backend, and a CUDA rank's current device); a group
    that cannot be set up raises."""
    coordinator_address = coordinator_address or os.environ.get(ENV_COORD)
    if num_processes is None:
        num_processes = int(os.environ.get(ENV_NPROC, "1"))
    if process_id is None:
        process_id = int(os.environ.get(ENV_PID, "0"))
    if num_processes <= 1 and coordinator_address is None:
        return False
    if torch.distributed.is_initialized():
        return True
    if coordinator_address is None:
        raise ValueError(f"{num_processes} processes need a coordinator address "
                         f"(${ENV_COORD})")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank_device(dev, process_id))
    torch.distributed.init_process_group(
        backend=choose_backend(dev, num_processes),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    return True


def is_primary() -> bool:
    """True on the process that logs and writes checkpoints (rank 0, or the only
    process)."""
    return not torch.distributed.is_initialized() or torch.distributed.get_rank() == 0


class RankFailed(RuntimeError):
    """A child of ``launch_local`` exited non-zero: its rank, exit code and standard
    error."""

    def __init__(self, rank: int, returncode: int, stderr: str):
        super().__init__(f"process {rank} exited with {returncode}; "
                         f"stderr:\n{stderr[-4000:]}")
        self.rank, self.returncode, self.stderr = rank, returncode, stderr


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _read(f) -> str:
    f.seek(0)
    return f.read()


def launch_local(
    n_processes: int,
    argv: Sequence[str],
    env: Optional[dict] = None,
    timeout: Optional[float] = 300.0,
) -> List[subprocess.CompletedProcess]:
    """Start ``n_processes`` copies of ``argv`` (e.g. ``[sys.executable, script]``)
    with the coordination variables set, and wait for them.

    Returns the completed processes, their output read back. When a child exits
    non-zero the others are killed at once and ``RankFailed`` (a ``RuntimeError``)
    is raised with its standard error; when ``timeout`` seconds pass, all are killed
    and ``subprocess.TimeoutExpired`` is raised. Each child should call
    :func:`initialize_distributed` early.
    """
    port = _free_port()
    procs, files = [], []
    try:
        for pid in range(n_processes):
            child_env = dict(os.environ)
            if env:
                child_env.update(env)
            child_env[ENV_COORD] = f"127.0.0.1:{port}"
            child_env[ENV_NPROC] = str(n_processes)
            child_env[ENV_PID] = str(pid)
            # a child started as ``python -m dgll_tpu_torch...`` finds the package
            child_env["PYTHONPATH"] = os.pathsep.join(
                [PACKAGE_ROOT, *filter(None, [child_env.get("PYTHONPATH")])])
            # temporary files, never pipes: a child blocked on a full pipe while the
            # others wait for it in a collective would hang the launch
            fo = tempfile.TemporaryFile(mode="w+")
            fe = tempfile.TemporaryFile(mode="w+")
            files.append((fo, fe))
            procs.append(subprocess.Popen(list(argv), env=child_env, stdout=fo,
                                          stderr=fe, text=True))
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            codes = [p.poll() for p in procs]
            failed = next((i for i, c in enumerate(codes) if c not in (None, 0)), None)
            if failed is not None:  # the others are killed on the way out
                raise RankFailed(failed, codes[failed], _read(files[failed][1]))
            if all(c == 0 for c in codes):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise subprocess.TimeoutExpired(list(argv), timeout)
            time.sleep(0.05)
        return [subprocess.CompletedProcess(list(argv), p.returncode, _read(fo), _read(fe))
                for p, (fo, fe) in zip(procs, files)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for fo, fe in files:
            fo.close()
            fe.close()


def _smoke(device: str) -> None:
    """Each rank contributes ``rank + 1``; the all-reduce must see every rank's."""
    initialize_distributed(device=device)
    dev = rank_device(device)
    rank, world = torch.distributed.get_rank(), torch.distributed.get_world_size()
    x = torch.tensor([rank + 1.0], device=dev)
    torch.distributed.all_reduce(x)
    expect = world * (world + 1) / 2
    if float(x) != expect:
        raise RuntimeError(f"all-reduce of rank + 1 gave {float(x)}, not {expect}")
    if is_primary():
        print(f"MULTIPROC_OK procs={world} backend={torch.distributed.get_backend()} "
              f"sum={float(x)}")
    torch.distributed.destroy_process_group()


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--n_processes", type=int, default=2)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if ENV_NPROC in os.environ:
        _smoke(args.device)
        return 0
    done = launch_local(args.n_processes, [sys.executable, "-m",
                                           "dgll_tpu_torch.parallel.launch",
                                           "--device", args.device])
    print(done[0].stdout, end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
