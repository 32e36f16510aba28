"""Kernel K1's share (%) of its roofline in the traced full-batch steps: the bytes
its sums need (``counts.edge_sum_bytes`` for each sum the model's step asks of it,
``reference/<arch>.py`` ``k1_sums``, at the graph's nodes and edges), times its
launches (the port's counters) over the sums a step asks for, over K1's traced
device time at 3.35 TB/s (``counts.PEAKS``). Nothing where K1 did not run; the run
fails where K1 ran under a name the trace does not show (``Trace.port_seconds``)."""
from gnnbench import counts

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernel K1"
MOVES = "full_epoch_ms"


def read(run):
    if (run.trace is None or run.peaks is None or run.traffic.mode != "full"
            or not hasattr(run.ref, "k1_sums")):
        return None
    launches = run.trace.launches("segment_matmul")
    sums = run.ref.k1_sums(run.cfg, run.traffic.n_feat, run.traffic.n_class)
    if launches <= 0 or not sums:
        return None
    n, e = run.traffic.n_node, run.data.n_edge
    per_sum = sum(counts.edge_sum_bytes(n, e, w, perm) for w, perm in sums) / len(sums)
    return counts.roofline_pct(per_sum * launches, run.trace.port_seconds("segment_matmul"),
                               run.peaks["hbm_bytes_per_s"])
