"""Device ms a batch of the optimizer step (with the batch loss's store and the
index's advance): the runner's phase events (``capture(..., marks)``), averaged
over an epoch of replays."""
UNIT = "ms/batch"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "optimizer step"
MOVES = "train_seeds_per_s"


def read(run):
    return None if run.phases is None else run.phases["optimizer"]
