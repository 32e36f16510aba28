from dgll_tpu_torch.nn.conv import GATConv, GCNConv, SAGEConv
from dgll_tpu_torch.nn.convert import params_from_flax
from dgll_tpu_torch.nn.models import GAT, GCN, GraphSAGE

__all__ = ["GATConv", "GCNConv", "SAGEConv", "GAT", "GCN", "GraphSAGE",
           "params_from_flax"]
