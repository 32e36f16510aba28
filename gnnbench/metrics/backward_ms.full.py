"""Device ms a full-batch step of its backward pass: the span ``dgll.step.backward``,
which ``train.make_full_batch_step`` opens while tracing (CUDA events just around the
phase), summed over the traced steps and divided by the program's count of them
(``step.full_batch``)."""
from gnnbench import spans

UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "full-batch step"
MOVES = "full_epoch_ms"


def read(run):
    if run.traffic.mode != "full":
        return None
    return spans.per(run, "step.full_batch", "dgll.step.backward")
