"""Tracing, phase timing and device traces. Counterpart of
``dgll_tpu/utils/profiling.py``.

The tracer: spans and counters at the boundaries of the port's layers, kept in
memory and read with ``report()``. Tracing is on while a ``torch.profiler`` session
records, and inside ``tracing()``; off, a span or counter site does nothing but that
check (``torch._C._autograd._profiler_enabled``, about 0.1 us). On, a span

* opens a ``record_function`` range named ``dgll.<layer>.<part>`` where the profiler
  records, so that its host timeline, and the kernels it ties to that range, name
  the port's layer;
* records a start and an end timing event on the current stream of a CUDA
  ``where`` (events from a pool the tracer reuses, resolved by ``report()``, never
  inside a step);
* adds its host seconds and counts one.

Spans record nothing while the stream captures a CUDA graph: a replay runs no
Python. ``PhaseTimer``'s named wall-clock phases open spans too, and ``device_trace``
is a ``torch.profiler`` trace written to a directory (the JAX package's
``jax.profiler`` trace).
"""
from __future__ import annotations

import contextlib
import os
import statistics
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Iterator, List, Optional

import torch

_profiler_enabled = torch._C._autograd._profiler_enabled
# A ``record_function`` range opened from C++: the same range on the profiler's
# timeline, in about 1 us where ``torch.profiler.record_function`` takes 7-8 (an H100
# machine's host, the profiler recording).
_range = getattr(torch._C._profiler, "_RecordFunctionFast",
                 torch.profiler.record_function)
_OFF = contextlib.nullcontext()
# Closed spans between two tries to keep them and resolve the done ones. A try holds
# the host about 8.5 us a span (query and elapsed time of its events, on an H100
# machine), so rarer tries stall a loop of graph replays longer (4096: the flagship's
# epoch rate 3.8% lower under ``tracing()``; 256: 1.0%), while a benchmark's traced
# slice (390 spans a minibatch slice) should hold none.
RESOLVE_AT = 512


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


class _Stat:
    __slots__ = ("count", "host_s", "device_ms")

    def __init__(self):
        self.count, self.host_s, self.device_ms = 0, 0.0, []


class Tracer:
    """The spans' totals, the counters and the timing events not yet resolved. A
    span closes by appending its record to ``closed`` (atomic; a backward pass's
    spans close on autograd's thread), so that little runs between a loop's spans;
    ``_keep`` adds the records to the totals in closing order, under the lock that
    guards the rest."""

    def __init__(self):
        self.forced = 0  # open ``tracing()`` blocks
        self.lock = threading.Lock()
        self.pool: List[torch.cuda.Event] = []
        self.reset()

    def reset(self) -> None:
        with self.lock:
            self.spans: Dict[str, _Stat] = defaultdict(_Stat)
            self.counters: Dict[str, int] = defaultdict(int)
            self.closed: List[tuple] = []  # (span, gap, t0, t1, start, end) not kept yet
            self.pending: List[tuple] = []  # (span, start event, end event)
            self.last: Dict[str, tuple] = {}  # gap -> (end event or None, host clock)

    def event(self, stream) -> Optional[torch.cuda.Event]:
        """A timing event recorded on ``stream``, or None where it is None."""
        if stream is None:
            return None
        try:
            ev = self.pool.pop()  # atomic
        except IndexError:
            ev = torch.cuda.Event(enable_timing=True)
        ev.record(stream)
        return ev

    def close(self, record: tuple) -> None:
        """A span's ``(name, gap, t0, t1, start, end)``: host clock and timing events
        (or None) at its start and end."""
        self.closed.append(record)
        if len(self.closed) >= RESOLVE_AT:
            with self.lock:
                self._keep()
                self._resolve(wait=False)

    def _keep(self) -> None:
        """Add the closed spans to the totals. A span with a ``gap`` also adds the
        interval from the last span of that ``gap`` to it. A span's events join the
        pending pairs only here, so an event that an open span, a pending pair or
        ``last`` holds never goes back to the pool."""
        n = len(self.closed)
        batch = self.closed[:n]
        del self.closed[:n]  # spans closed meanwhile stay
        for name, gap, t0, t1, start, end in batch:
            if gap is not None:
                prev = self.last.get(gap)
                self.last[gap] = (end, t1)
                if prev is not None:
                    both = prev[0] is not None and start is not None
                    self._add(gap, t0 - prev[1], (prev[0], start) if both else None)
            self._add(name, t1 - t0, None if start is None else (start, end))

    def _add(self, name: str, host_s: float, pair: Optional[tuple]) -> None:
        st = self.spans[name]
        st.count += 1
        st.host_s += host_s
        if pair is not None:
            self.pending.append((name, *pair))

    def count(self, name: str, n: int) -> None:
        with self.lock:
            self.counters[name] += n

    def _resolve(self, wait: bool) -> None:
        """Read the device time of the pending spans in order, up to the first whose
        end the device has not reached (all of them with ``wait``), and put their
        events back in the pool, except those a pending span or gap still holds."""
        done = 0
        for name, start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                break
            self.spans[name].device_ms.append(start.elapsed_time(end))
            done += 1
        if done == 0:
            return
        left = self.pending[done:]
        held = {id(e) for _, a, b in left for e in (a, b)}
        held |= {id(e) for e, _ in self.last.values() if e is not None}
        free = {id(e): e for _, a, b in self.pending[:done] for e in (a, b)}
        self.pool.extend(e for k, e in free.items() if k not in held)
        self.pending = left

    def report(self) -> dict:
        with self.lock:
            self._keep()
            self._resolve(wait=True)
            spans = {n: {"count": s.count, "host_s": s.host_s,
                         "device_ms": sum(s.device_ms) if s.device_ms else None,
                         "device_ms_median": (statistics.median(s.device_ms)
                                              if s.device_ms else None)}
                     for n, s in self.spans.items()}
            return {"spans": spans, "counters": dict(self.counters)}


TRACER = Tracer()


def enabled() -> bool:
    """Whether span and counter sites record: a profiler records, or ``tracing()``."""
    return TRACER.forced > 0 or _profiler_enabled()


@contextlib.contextmanager
def tracing() -> Iterator[None]:
    """Tracing on inside the block, with or without a profiler (to read ``report()``
    at the cost of the spans alone)."""
    with TRACER.lock:
        TRACER.forced += 1
    try:
        yield
    finally:
        with TRACER.lock:
            TRACER.forced -= 1


_STREAMS: Dict[tuple, torch.cuda.Stream] = {}  # (device, raw stream) -> its Stream


def _stream(where):
    """The current stream of ``where``'s device (a tensor or a device) where it is a
    CUDA device, else None; False while that stream captures a CUDA graph. Streams
    are looked up by their raw handle: ``torch.cuda.current_stream`` builds a new
    ``Stream`` a call (5-6 us on an H100 machine's host)."""
    if where is None:
        return None
    dev = where.device if isinstance(where, torch.Tensor) else torch.device(where)
    if dev.type != "cuda":
        return None
    if torch.cuda.is_current_stream_capturing():
        return False
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    key = (idx, torch._C._cuda_getCurrentRawStream(idx))
    stream = _STREAMS.get(key)
    if stream is None:
        stream = _STREAMS[key] = torch.cuda.current_stream(idx)
    return stream


class _Span:
    __slots__ = ("name", "stream", "gap", "rf", "t0", "start")

    def __init__(self, name: str, stream, gap: Optional[str]):
        self.name, self.stream, self.gap = name, stream, gap

    def __enter__(self):
        self.rf = None
        if _profiler_enabled():
            self.rf = _range(self.name)
            self.rf.__enter__()
        self.start = TRACER.event(self.stream)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        end = TRACER.event(self.stream)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        TRACER.close((self.name, self.gap, self.t0, t1, self.start, end))
        return False


def span(name: str, where=None, gap: Optional[str] = None):
    """A context manager: the span ``name`` (``dgll.<layer>.<part>``) around the
    block while tracing is on, else nothing. ``where``: a tensor or device whose CUDA
    stream the span's timing events go on (none elsewhere). ``gap``: also keep, under
    that name, the interval from the end of the last span given the same ``gap`` to
    the start of this one (the host's and, with events, the device's). The span may
    be entered again, one block after another: a loop's spans, whose stream is then
    looked up once."""
    if not (TRACER.forced or _profiler_enabled()):
        return _OFF
    stream = _stream(where)
    if stream is False:
        return _OFF
    return _Span(name, stream, gap)


def spanned(name: str, fn: Callable, *args):
    """``fn(*args)`` inside ``span(name)``. While tracing, its backward also gets a
    span, ``name + "_bwd"``: from the moment autograd reaches ``fn``'s output to the
    moment it leaves the last of ``fn``'s tensor arguments that need a gradient. The
    hooks that mark those moments are registered only while tracing is on (the
    arguments then reach ``fn`` as views of themselves, whose nodes end the span)."""
    if not (TRACER.forced or _profiler_enabled()):
        return fn(*args)
    where = next((a for a in args if isinstance(a, torch.Tensor)), None)
    stream = _stream(where)
    if stream is False:
        return fn(*args)
    marks = []
    if torch.is_grad_enabled():
        args = tuple(a.view_as(a) if isinstance(a, torch.Tensor) and a.requires_grad
                     else a for a in args)
        marks = [a.grad_fn for a in args
                 if isinstance(a, torch.Tensor) and a.requires_grad]
    with _Span(name, stream, None):
        out = fn(*args)
    if marks and out.grad_fn is not None:
        # the device alone: the hooks live until the backward, and a tensor they held
        # would stay allocated that long (64 layers' inputs in a deep model)
        _backward_span(name + "_bwd", out.grad_fn, marks, where.device)
    return out


def _backward_span(name: str, out_node, in_nodes: list, where) -> None:
    state: list = []

    def reached(grad_outputs):
        s = span(name, where)
        s.__enter__()
        state[:] = [s, len(in_nodes)]

    def left(grad_inputs, grad_outputs):
        if state:
            state[1] -= 1
            if state[1] == 0:
                state.pop(0).__exit__(None, None, None)
                state.clear()

    out_node.register_prehook(reached)
    for node in in_nodes:
        node.register_hook(left)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing is on."""
    if TRACER.forced or _profiler_enabled():
        TRACER.count(name, n)


def report() -> dict:
    """Everything traced since the last ``reset()``, the device's work waited for:
    ``{"spans": {name: {"count", "host_s", "device_ms", "device_ms_median"}},
    "counters": {name: n}}``. ``device_ms`` is the sum over the span's timing events
    and None where it recorded none (no CUDA ``where``)."""
    return TRACER.report()


def reset() -> None:
    """Forget every span and counter."""
    TRACER.reset()


class PhaseTimer:
    """Accumulates wall-clock per named phase; nestable via context manager. Each
    phase is also the span ``dgll.phase.<name>``.

    With ``sync=True`` a phase that names a CUDA ``result`` waits for the device
    before it stops its clock.
    """

    def __init__(self, sync: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync = sync

    @contextlib.contextmanager
    def phase(self, name: str, result=None) -> Iterator[None]:
        with span(f"dgll.phase.{name}", result):
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
    whose ``key_averages()`` the caller may read after the block. The port's spans
    record inside it."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(
        os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))
