"""Share (%) of the traced slice (whole epochs of ``run_epoch``, each ending in a read
of its loss) in which no operation ran on the card: 1 - busy / window."""
UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "device epoch runner"
MOVES = "train_seeds_per_s"


def read(run):
    if run.trace is None or run.traffic.mode != "minibatch":
        return None
    return run.trace.idle_pct
