"""Phase timing and device traces. Counterpart of ``dgll_tpu/utils/profiling.py``:
``PhaseTimer``'s named wall-clock phases, each also a
``torch.profiler.record_function`` range, so that a profiler trace shows the same
phases; ``device_trace``, a ``torch.profiler`` trace written to a directory (the JAX
package's ``jax.profiler`` trace)."""
from __future__ import annotations

import contextlib
import csv
import os
import statistics
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator

import torch


def cuda_median_ms(fn: Callable[[], object], warmup: int = 3, reps: int = 15) -> float:
    """Median milliseconds of ``fn()`` on the current CUDA stream, timed with CUDA
    events after ``warmup`` untimed calls."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


class PhaseTimer:
    """Accumulates wall-clock per named phase; nestable via context manager.

    With ``sync=True`` a phase that names a CUDA ``result`` waits for the device
    before it stops its clock.
    """

    def __init__(self, sync: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, result=None) -> Iterator[None]:
        with torch.profiler.record_function(name):
            t0 = time.perf_counter()
            yield
            if self.sync and isinstance(result, torch.Tensor) and result.is_cuda:
                torch.cuda.synchronize(result.device)
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        return self.totals[name] / max(self.counts[name], 1)

    def summary(self) -> Dict[str, float]:
        return dict(self.totals)

    def to_csv(self, path: str) -> None:
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["phase", "total_s", "count", "mean_s"])
            for k in self.totals:
                w.writerow([k, self.totals[k], self.counts[k], self.mean(k)])

    def report(self) -> str:
        lines = ["phase                 total(s)   count   mean(ms)"]
        for k in sorted(self.totals, key=lambda k: -self.totals[k]):
            lines.append(
                f"{k:<20} {self.totals[k]:9.3f} {self.counts[k]:7d} "
                f"{self.mean(k)*1e3:9.3f}"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block on the host and, where CUDA is available, on the device,
    and write a Chrome trace (``trace_<pid>_<ns>.json``, readable by Perfetto or
    ``chrome://tracing``) into ``log_dir``, which is created. Yields the profiler,
    whose ``key_averages()`` the caller may read after the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
