"""Share (%) of the card's busy time in the traced full-batch steps spent in
operations that are not the port's own kernels (``dgll_tpu_torch/csrc/*.cu``, by
family in ``trace.PORT``): the PyTorch operators between them, cuBLAS, copies and
fills. The run fails where a family launched and the trace names none of its
kernels (``Trace.port_seconds``), since their time would read as PyTorch's."""
from gnnbench.trace import PORT

UNIT = "%"
BETTER = "lower"
SOURCE = "device_trace"
LAYER = "ops"
MOVES = "full_epoch_ms"


def read(run):
    if run.trace is None or run.traffic.mode != "full":
        return None
    busy = sum(run.trace.ops.values())
    if busy <= 0:
        return None
    return 100.0 * (busy - sum(run.trace.port_seconds(f) for f in PORT)) / busy
