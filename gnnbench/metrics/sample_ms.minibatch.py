"""Device ms a batch of the batch's block sampling on the card: CUDA events that the
runner's capture(..., marks) records around the step's phases, averaged over an
epoch of replays, each waited for."""
UNIT = "ms/batch"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "device sampler"
MOVES = "train_seeds_per_s"


def read(run):
    return None if run.phases is None else run.phases["sampling"]
