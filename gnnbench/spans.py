"""The port's own spans and counters over the traced slice: what
``dgll_tpu_torch.utils.profiling.report()`` holds after ``run.traced()``, since the
program traces while the profiler records and the slice is the only profiled part of
a run. Each reader gives None where the slice did not run, where the program has no
tracer, or where the span did not run."""
from __future__ import annotations

from typing import Optional


def report(run) -> Optional[dict]:
    if run.trace is None:
        return None
    try:
        from dgll_tpu_torch.utils.profiling import report as program_report
    except ImportError:  # a program without the tracer
        return None
    return program_report()


def device_ms(run, *names: str) -> Optional[float]:
    """The device ms of the spans ``names`` over the slice, summed; None where none
    of them recorded device time."""
    rep = report(run)
    if rep is None:
        return None
    got = [rep["spans"][n]["device_ms"] for n in names if n in rep["spans"]]
    got = [v for v in got if v is not None]
    return sum(got) if got else None


def per(run, counter: str, *names: str) -> Optional[float]:
    """``device_ms(run, *names)`` over the program's counter ``counter``."""
    total = device_ms(run, *names)
    n = report(run)["counters"].get(counter, 0) if total is not None else 0
    return total / n if n > 0 else None


def median_ms(run, name: str) -> Optional[float]:
    """The median device ms of one instance of the span ``name``."""
    rep = report(run)
    s = None if rep is None else rep["spans"].get(name)
    return None if s is None else s["device_ms_median"]
