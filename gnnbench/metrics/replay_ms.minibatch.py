"""Median device ms of one replay of the captured batch step in the traced epochs:
the span ``dgll.runner.replay`` that ``DeviceEpochRunner.run_epoch`` opens around
each ``graph.replay()`` while tracing (CUDA events recorded just before and just
after it, so the launch's latency is in it)."""
from gnnbench import spans

UNIT = "ms/batch"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device epoch runner"
MOVES = "train_seeds_per_s"


def read(run):
    if run.traffic.mode != "minibatch":
        return None
    return spans.median_ms(run, "dgll.runner.replay")
