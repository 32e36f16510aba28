from dgll_tpu_torch.data.datasets import synthetic_classification_graph
from dgll_tpu_torch.data.transforms import (
    gcn_normalize,
    precompute_neighbor_features,
    row_normalize_adj,
    row_normalize_features,
)

__all__ = [
    "synthetic_classification_graph",
    "gcn_normalize",
    "precompute_neighbor_features",
    "row_normalize_adj",
    "row_normalize_features",
]
