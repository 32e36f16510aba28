"""Device ms a full-batch step of GCNII's initial residual and identity mapping,
forward and backward: the spans ``dgll.conv.identity_map`` (``nn/conv.py``
``GCN2Conv``: ``s = (1 - alpha) P x + alpha x0`` and ``beta s W + (1 - beta) s``,
after the aggregation ``P x``) and ``dgll.conv.identity_map_bwd`` (autograd from its
output to ``P x`` and ``x0``), summed over the traced steps and divided by the
program's count of them (``step.full_batch``). Nothing where no such layer ran."""
from gnnbench import spans

UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "GCNII initial residual and identity mapping"
MOVES = "full_epoch_ms"


def read(run):
    if run.traffic.mode != "full":
        return None
    return spans.per(run, "step.full_batch", "dgll.conv.identity_map",
                     "dgll.conv.identity_map_bwd")
