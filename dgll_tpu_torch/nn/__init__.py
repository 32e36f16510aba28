from dgll_tpu_torch.nn.conv import GCNConv
from dgll_tpu_torch.nn.convert import params_from_flax
from dgll_tpu_torch.nn.models import GCN

__all__ = ["GCNConv", "GCN", "params_from_flax"]
