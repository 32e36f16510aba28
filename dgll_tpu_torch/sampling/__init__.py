from dgll_tpu_torch.sampling.base import (
    BaseSampler,
    Block,
    HostGraph,
    sample_neighbors_padded,
)
from dgll_tpu_torch.sampling.device_sampler import (
    DeviceCSR,
    DeviceNeighborSampler,
    sample_blocks_device,
    sample_layer_device,
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
    "DeviceCSR",
    "DeviceNeighborSampler",
    "sample_blocks_device",
    "sample_layer_device",
    "NeighborSampler",
    "CommunityNeighborSampler",
    "DGLLNeighborSampler",
]
