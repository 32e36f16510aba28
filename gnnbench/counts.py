"""The yardstick's arithmetic: the card's peaks, and the operations and bytes that the
work of a cell needs, counted from the operation's shapes (the graph's nodes and
edges, the widths) and never from what an implementation reads, pads or computes
again. So a roofline share reads the same work whatever kernel does it.

Bytes are float32 values and int32 indices, each input read once and each output
written once (the port's ``chip_smoke.py`` ``bound``/``k1_reads`` rule). A sum over a
destination-major CSR reads its row pointers, ``(n + 1)`` indices; a sum that reads
its messages through a column permutation also reads that permutation.
"""
from __future__ import annotations

from typing import List, Optional

F32 = 4
I32 = 4

# NVIDIA's data sheet, H100 SXM, dense rates at the full 700 W: float32 outside the
# tensor cores (TF32 is off in every cell), HBM3 bandwidth
PEAKS = {"H100": {"f32_ops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}}


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of the card named ``device_name``, or None for a card the
    table does not hold."""
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


def edge_sum_bytes(n_node: int, n_edge: int, width: int, permuted: bool) -> int:
    """One sum of ``n_edge`` per-edge messages of ``width`` floats into ``n_node`` rows:
    the messages, the row pointers, the output (and the permutation where the
    messages are read through one)."""
    return (n_edge * width * F32 + (n_node + 1) * I32 + n_node * width * F32
            + (n_edge * I32 if permuted else 0))


def attention_bytes(n_node: int, n_edge: int, heads: int, width: int) -> int:
    """What the row kernels K3-K7 of one fused GAT layer need in one step, each over
    the row pointers of the graph, ``E`` edges and ``N`` rows at ``H`` heads:

    * K3, the softmax statistics: per-edge source scores ``[E, H]`` and per-row
      destination scores ``[N, H]`` in, the row max and sum ``2 x [N, H]`` out;
    * K4, alpha: the scores and the row's destination score, max and sum in
      (``[E, H] + 3 x [N, H]``), alpha and the LeakyReLU slope ``2 x [E, H]`` out;
    * K7, the gradient's rows spread to the edges: ``[N, width]`` in, ``[E, width]``
      out;
    * K6, the sum of ``alpha * dalpha`` a row: ``[E, H]`` in, ``[N, H]`` out;
    * K5, the softmax's backward: alpha, dalpha, the slope ``3 x [E, H]`` and the row
      sums ``[N, H]`` in, ``dz [E, H]`` and ``dsd [N, H]`` out.
    """
    e_h, n_h, ptr = n_edge * heads * F32, n_node * heads * F32, (n_node + 1) * I32
    k3 = e_h + n_h + 2 * n_h + ptr
    k4 = e_h + 3 * n_h + 2 * e_h + ptr
    k7 = n_node * width * F32 + n_edge * width * F32 + ptr
    k6 = e_h + n_h + ptr
    k5 = 3 * e_h + n_h + e_h + n_h + ptr
    return k3 + k4 + k7 + k6 + k5


def roofline_pct(bytes_needed: float, device_s: float, hbm_bytes_per_s: float) -> Optional[float]:
    """The least time the card could move ``bytes_needed`` in, as a share (%) of the
    traced device time; None where nothing was traced."""
    if device_s <= 0 or bytes_needed <= 0:
        return None
    return 100.0 * bytes_needed / hbm_bytes_per_s / device_s


def block_rows(batch_size: int, fanouts: List[int]) -> List[tuple]:
    """``(destinations, draws)`` of each sampled layer at full batch, outermost first
    (fanouts outermost first)."""
    from gnnbench.traffic import layer_sizes

    sizes = layer_sizes(batch_size, fanouts)  # innermost first
    return [(n, n * int(f)) for n, f in zip(reversed(sizes), fanouts)]
