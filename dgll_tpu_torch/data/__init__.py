from dgll_tpu_torch.data.datasets import (
    S2VGraph,
    load_dataP,
    load_graph,
    load_planetoid,
    load_ppi_split,
    s2v_to_tuples,
    save_graph,
    separate_graphs,
    synthetic_classification_graph,
    synthetic_graph_classification,
    synthetic_power_law_graph,
)
from dgll_tpu_torch.data.registry import DATASETS, dataset_metric, load_dataset
from dgll_tpu_torch.data.transforms import (
    gcn_normalize,
    precompute_neighbor_features,
    row_normalize_adj,
    row_normalize_features,
)
from dgll_tpu_torch.data.utils import create_khop_index, multihop_sampling, separate_data

__all__ = [
    "DATASETS",
    "load_dataset",
    "dataset_metric",
    "multihop_sampling",
    "create_khop_index",
    "separate_data",
    "S2VGraph",
    "load_dataP",
    "s2v_to_tuples",
    "separate_graphs",
    "synthetic_classification_graph",
    "synthetic_power_law_graph",
    "synthetic_graph_classification",
    "load_planetoid",
    "load_ppi_split",
    "save_graph",
    "load_graph",
    "gcn_normalize",
    "precompute_neighbor_features",
    "row_normalize_adj",
    "row_normalize_features",
]
