"""Device ms a batch of the model's forward pass and loss and its backward pass:
the runner's phase events (``capture(..., marks)``), averaged over an epoch of
replays."""
UNIT = "ms/batch"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "model, forward and backward"
MOVES = "train_seeds_per_s"


def read(run):
    return None if run.phases is None else run.phases["forward"] + run.phases["backward"]
