"""A bounded slice of training under ``torch.profiler``, reduced to what the per-layer
metrics read: the device's busy seconds (the union of its traced operations, which
the port runs on one stream) over the traced window, each operation's device seconds
by name, and a breakdown: the operations that took most device time, and the idle
gaps of the device summed by what the host was doing (the innermost host range open
at the gap's middle, such as the harness's own ``gnnbench.*`` ranges, a CUDA runtime
call or an ATen operator)."""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence

import torch

TOP = 10  # entries of each list of the breakdown
RANGE = "gnnbench.traced"
# The port's own kernels (``dgll_tpu_torch/csrc/<family>.cu``) by family, as a trace
# names them; ``modes.launch_counts`` counts each family's launches under its key.
PORT = {
    "segment_matmul": ("spmm_csr_kernel", "spmm_bf16_kernel", "combine_kernel"),  # K1
    "spmm_windowed": ("spmm_windowed_kernel",),                                   # K2
    "gat_csr": ("gat_stats_kernel", "gat_stats_combine_kernel", "edges_heads4_kernel",
                "edges_quads_kernel", "edges_one_kernel", "edges_to_rows_kernel",
                "gat_bwd_softmax_kernel", "combine_segments_kernel", "expand_rows_kernel",
                "sddmm_kernel"),                                                  # K3-K7
    "quantize": ("quantize_kernel", "colmax_kernel"),
    "probes": ("copy_kernel", "dynread_kernel", "onehot_kernel", "dynacc_kernel",
               "gather_rows_kernel", "bucket_count_kernel", "bucket_starts_kernel",
               "bucket_scatter_kernel"),
}


@dataclass
class Trace:
    window_s: float               # the traced range of the slice
    busy_s: float                 # device time in operations, within it
    ops: Dict[str, float]         # device seconds by operation name
    gaps: Dict[str, float]        # idle device seconds by host activity
    # the port's launch counts over the slice: {family of PORT: {counter: launches}}
    counters: Dict[str, Dict[str, int]] = field(default_factory=dict)

    @property
    def idle_pct(self) -> float:
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def breakdown(self) -> dict:
        def top(d):
            return [[k[:120], v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(self.ops), "idle_gaps": top(self.gaps)}

    def seconds_of(self, match: Callable[[str], bool]) -> float:
        return sum(s for name, s in self.ops.items() if match(name))

    def launches(self, family: str, counter: Optional[str] = None) -> int:
        """The port's launches of ``family`` over the slice (of one ``counter``)."""
        c = self.counters.get(family, {})
        return sum(c.values()) if counter is None else c.get(counter, 0)

    def port_seconds(self, family: str, names: Sequence[str] = ()) -> float:
        """Device seconds of the port's kernels of ``family`` (of its kernels ``names``
        alone, where given). Raises where the family's counters launched a kernel in
        the slice and the trace names none of its kernels: a kernel renamed, or a
        route added under a name that ``PORT`` lacks, would otherwise read as no time
        of the port's own."""
        if self.launches(family) > 0 and self.seconds_of(kernels(*PORT[family])) <= 0:
            raise RuntimeError(
                f"the port launched {self.launches(family)} kernel(s) of {family} in the "
                f"traced slice and the trace names none of {PORT[family]}: a kernel of "
                f"that family runs under a name the benchmark does not know")
        return self.seconds_of(kernels(*(names or PORT[family])))

    def check_port(self) -> None:
        """``port_seconds``'s check on every family."""
        for family in PORT:
            self.port_seconds(family)


def _is_device(e) -> bool:
    return e.device_type != torch.autograd.DeviceType.CPU


def _is_range(e, host_names: set) -> bool:
    """A host range's image on the device's timeline (a ``record_function`` range
    around device work), which is no device operation."""
    return getattr(e, "is_user_annotation", False) or e.name in host_names


def traced(fn: Callable[[], None]) -> Trace:
    """Run ``fn`` (which ends in a read of its result) under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with record_function(RANGE):
            fn()
            torch.cuda.synchronize()
    events = list(prof.events())
    rng = [e for e in events if e.name == RANGE and not _is_device(e)]
    if not rng:
        raise RuntimeError("the profiler lost the traced range")
    lo, hi = rng[0].time_range.start, rng[0].time_range.end
    host_names = {e.name for e in events if not _is_device(e)}
    dev = sorted((max(e.time_range.start, lo), min(e.time_range.end, hi), e.name)
                 for e in events if _is_device(e) and not _is_range(e, host_names))
    ops: Dict[str, float] = defaultdict(float)
    merged: List[list] = []
    for s, t, name in dev:
        if t <= s:
            continue
        ops[name] += (t - s) * 1e-6
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) * 1e-6
    return Trace((hi - lo) * 1e-6, busy, dict(ops), _gaps(events, merged, lo, hi))


def _gaps(events, merged: List[list], lo: float, hi: float) -> Dict[str, float]:
    """Idle device time between ``lo`` and ``hi`` by the innermost host range open at
    each gap's middle."""
    host = sorted(((e.time_range.start, e.time_range.end, e.name) for e in events
                   if not _is_device(e) and e.name != RANGE), key=lambda x: x[0])
    starts = [h[0] for h in host]
    edges = [lo] + [x for s, t in merged for x in (s, t)] + [hi]
    out: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[0::2], edges[1::2]):
        if b <= a:
            continue
        mid, name = 0.5 * (a + b), "host idle"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 256, -1), -1):  # the innermost open range
            if host[j][1] >= mid:
                name = host[j][2]
                break
        out[name] += (b - a) * 1e-6
    return dict(out)


def kernels(*names: str) -> Callable[[str], bool]:
    """A test of a traced operation's name: one of the port's kernels ``names`` (they
    live in an anonymous namespace of ``dgll_tpu_torch/csrc``, as
    ``(anonymous namespace)::<name><...>(...)`` or ``...::<name>(...)``)."""
    import re

    pattern = re.compile(r"::(?:%s)[<(]" % "|".join(map(re.escape, names)))
    return lambda op: bool(pattern.search(op))
