"""Kernels K3-K7's share (%) of their roofline in the traced full-batch steps: the
bytes the attention's row work needs (``counts.attention_bytes`` for each layer of
``reference/<arch>.py`` ``attention_heads``), times K3's launches (the port's
counters) over the layers, over the traced device time of K3-K7 at 3.35 TB/s.
Nothing where they did not run; the run fails where the port's ``gat_csr`` kernels
ran under names the trace does not show (``Trace.port_seconds``)."""
from gnnbench import counts

UNIT = "%"
BETTER = "higher"
SOURCE = "device_trace"
LAYER = "kernels K3-K7"
MOVES = "full_epoch_ms"

K3_K7 = ("gat_stats_kernel", "gat_stats_combine_kernel",                # K3
         "edges_heads4_kernel", "edges_quads_kernel", "edges_one_kernel",   # K4
         "gat_bwd_softmax_kernel", "combine_segments_kernel",               # K5, K6
         "edges_to_rows_kernel",                                             # K6
         "expand_rows_kernel")                                               # K7


def read(run):
    if (run.trace is None or run.peaks is None or run.traffic.mode != "full"
            or not hasattr(run.ref, "attention_heads")):
        return None
    layers = run.ref.attention_heads(run.cfg, run.traffic.n_feat, run.traffic.n_class)
    steps = run.trace.launches("gat_csr", "gat_stats") / max(len(layers), 1)
    if steps <= 0:
        return None
    n, e = run.traffic.n_node, run.data.n_edge
    per_step = sum(counts.attention_bytes(n, e, h, w) for h, w in layers)
    return counts.roofline_pct(per_step * steps, run.trace.port_seconds("gat_csr", K3_K7),
                               run.peaks["hbm_bytes_per_s"])
