"""Device ms a batch between the replays of the traced epochs: the span
``dgll.runner.between_replays``, from one replay's end event to the next one's start
event, across epochs (so the epoch boundary's draws and the loss read fall in it),
summed and divided by the replays (the program's ``runner.replay``). The device
waits on the host there, or runs the epoch boundary's work."""
from gnnbench import spans

UNIT = "ms/batch"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device epoch runner"
MOVES = "train_seeds_per_s"


def read(run):
    if run.traffic.mode != "minibatch":
        return None
    return spans.per(run, "runner.replay", "dgll.runner.between_replays")
