"""Device ms a full-batch step of the layers' neighbour aggregations, forward and
backward: the spans ``dgll.conv.aggregate`` (``nn/conv.py``: ``spmm_mean_coo`` in
GraphSAGE, the fused attention in GAT) and ``dgll.conv.aggregate_bwd`` (autograd
from the aggregation's output to its inputs; in GAT the fused op's backward), summed
over the traced steps and divided by the program's count of them
(``step.full_batch``). A first layer that aggregates the input features has no
backward. Autograd runs the nodes made after an aggregation (GraphSAGE's self
branch) before it reaches the aggregation's output, so the backward span holds no
dense layer's work (``tests/test_torch_tracing.py`` checks the order)."""
from gnnbench import spans

UNIT = "ms/step"
BETTER = "lower"
SOURCE = "program_span"
LAYER = "message passing"
MOVES = "full_epoch_ms"


def read(run):
    if run.traffic.mode != "full":
        return None
    return spans.per(run, "step.full_batch", "dgll.conv.aggregate",
                     "dgll.conv.aggregate_bwd")
