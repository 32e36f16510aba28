from dgll_tpu_torch.nn.conv import GATConv, GCNConv
from dgll_tpu_torch.nn.convert import params_from_flax
from dgll_tpu_torch.nn.models import GAT, GCN

__all__ = ["GATConv", "GCNConv", "GAT", "GCN", "params_from_flax"]
