from dgll_tpu_torch.ops.chunked import (
    ChunkedCSR,
    build_chunked,
    build_chunked_pair,
    spmm_chunked_reference,
)
from dgll_tpu_torch.ops.gat_csr import gat_attention_coo
from dgll_tpu_torch.ops.spmm import spmm_coo

__all__ = [
    "ChunkedCSR",
    "build_chunked",
    "build_chunked_pair",
    "gat_attention_coo",
    "spmm_chunked_reference",
    "spmm_coo",
]
