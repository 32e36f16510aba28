from dgll_tpu_torch.ops.chunked import (
    ChunkedCSR,
    build_chunked,
    build_chunked_pair,
    spmm_chunked_reference,
)
from dgll_tpu_torch.ops.gat_csr import gat_attention_coo
from dgll_tpu_torch.ops.segment import (
    segment_max,
    segment_mean,
    segment_min,
    segment_softmax,
    segment_sum,
)
from dgll_tpu_torch.ops.spmm import fused_gcn_layer, sddmm_coo, spmm_coo
from dgll_tpu_torch.ops.gat import (
    gat_attention_chunked,
    gat_attention_chunked_fused,
    gat_attention_chunked_multihead,
)

__all__ = [
    "ChunkedCSR",
    "build_chunked",
    "fused_gcn_layer",
    "build_chunked_pair",
    "gat_attention_chunked",
    "gat_attention_chunked_fused",
    "gat_attention_chunked_multihead",
    "gat_attention_coo",
    "sddmm_coo",
    "segment_max",
    "segment_mean",
    "segment_min",
    "segment_softmax",
    "segment_sum",
    "spmm_chunked_reference",
    "spmm_coo",
]
