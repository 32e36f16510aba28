from dgll_tpu_torch.sampling.base import (
    BaseSampler,
    Block,
    HostGraph,
    sample_neighbors_padded,
)
from dgll_tpu_torch.sampling.neighbor import (
    CommunityNeighborSampler,
    DGLLNeighborSampler,
    NeighborSampler,
)

__all__ = [
    "BaseSampler",
    "Block",
    "HostGraph",
    "sample_neighbors_padded",
    "NeighborSampler",
    "CommunityNeighborSampler",
    "DGLLNeighborSampler",
]
