from dgll_tpu_torch.utils.config import TrainConfig, add_train_flags, parse_train_config
from dgll_tpu_torch.utils.logging import get_logger
from dgll_tpu_torch.utils.profiling import PhaseTimer, device_trace

__all__ = [
    "get_logger",
    "PhaseTimer",
    "device_trace",
    "TrainConfig",
    "add_train_flags",
    "parse_train_config",
]
