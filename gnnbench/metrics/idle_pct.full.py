"""Share (%) of the traced slice (full-batch steps, then a read of the last loss) in
which no operation ran on the card: 1 - busy / window."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "full-batch step"
MOVES = "full_epoch_ms"


def read(run):
    if run.trace is None or run.traffic.mode != "full":
        return None
    return run.trace.idle_pct
