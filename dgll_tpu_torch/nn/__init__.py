from dgll_tpu_torch.nn.conv import GATConv, GCNConv, GINConv, SAGEConv
from dgll_tpu_torch.nn.convert import params_from_flax
from dgll_tpu_torch.nn.models import GAT, GCN, GIN, GINNode, GraphSAGE
from dgll_tpu_torch.nn.pooling import (
    Pooling,
    batch_graphs,
    max_pooling,
    mean_pooling,
    sum_pooling,
)

__all__ = ["GATConv", "GCNConv", "GINConv", "SAGEConv", "GAT", "GCN", "GIN", "GINNode",
           "GraphSAGE", "Pooling", "batch_graphs", "max_pooling", "mean_pooling",
           "sum_pooling", "params_from_flax"]
