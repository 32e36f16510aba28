from dgll_tpu_torch.sampling.base import (
    BaseSampler,
    Block,
    HostGraph,
    SparseBlock,
    WeightedBlock,
    sample_neighbors_padded,
)
from dgll_tpu_torch.sampling.device_layerwise import (
    DeviceLap,
    DeviceLayerWiseSampler,
    alias_draw,
    build_alias_table,
    build_device_lap,
    sample_blocks_device_layerwise,
)
from dgll_tpu_torch.sampling.device_sampler import (
    DeviceCSR,
    DeviceNeighborSampler,
    sample_blocks_device,
    sample_layer_device,
)
from dgll_tpu_torch.sampling.layerwise import (
    FastGCNSampler,
    LadiesSampler,
    LayerWiseSampler,
    geometric_layer_sizes,
    normalized_laplacian,
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
    "SparseBlock",
    "WeightedBlock",
    "sample_neighbors_padded",
    "DeviceLap",
    "DeviceLayerWiseSampler",
    "alias_draw",
    "build_alias_table",
    "build_device_lap",
    "sample_blocks_device_layerwise",
    "FastGCNSampler",
    "LadiesSampler",
    "LayerWiseSampler",
    "geometric_layer_sizes",
    "normalized_laplacian",
    "DeviceCSR",
    "DeviceNeighborSampler",
    "sample_blocks_device",
    "sample_layer_device",
    "NeighborSampler",
    "CommunityNeighborSampler",
    "DGLLNeighborSampler",
]
