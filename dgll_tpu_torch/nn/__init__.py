from dgll_tpu_torch.nn.conv import GATConv, GCN2Conv, GCNConv, GINConv, SAGEConv
from dgll_tpu_torch.nn.convert import params_from_flax, skipgram_from_jax, tp_params_from_numpy
from dgll_tpu_torch.nn.models import GAT, GCN, GCNII, GIN, GINNode, GraphSAGE
from dgll_tpu_torch.nn.pooling import (
    Pooling,
    batch_graphs,
    max_pooling,
    mean_pooling,
    sum_pooling,
)

__all__ = ["GATConv", "GCN2Conv", "GCNConv", "GINConv", "SAGEConv", "GAT", "GCN", "GCNII",
           "GIN", "GINNode", "GraphSAGE", "Pooling", "batch_graphs", "max_pooling",
           "mean_pooling", "sum_pooling", "params_from_flax", "skipgram_from_jax",
           "tp_params_from_numpy"]
