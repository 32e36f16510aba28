from dgll_tpu_torch.train.device_pipeline import (
    GRAPH_ADAM,
    DeviceEpochRunner,
    EpochDraws,
    draw_epoch,
    make_device_eval_fn,
    make_sample_fn,
)
from dgll_tpu_torch.train.exact_infer import exact_accuracy, exact_predict
from dgll_tpu_torch.train.metrics import (
    METRIC_FOR_DATASET,
    accuracy,
    masked_nll_loss,
    metric_for_dataset,
    micro_f1,
)
from dgll_tpu_torch.train.trainer import (
    EpochStats,
    FullBatchTrainer,
    History,
    MiniBatchTrainer,
    TrainState,
    create_train_state,
    make_block_eval,
    make_block_step,
    make_full_batch_eval,
    make_full_batch_step,
)

__all__ = [
    "GRAPH_ADAM",
    "DeviceEpochRunner",
    "EpochDraws",
    "draw_epoch",
    "make_device_eval_fn",
    "make_sample_fn",
    "exact_accuracy",
    "exact_predict",
    "METRIC_FOR_DATASET",
    "accuracy",
    "masked_nll_loss",
    "metric_for_dataset",
    "micro_f1",
    "EpochStats",
    "FullBatchTrainer",
    "History",
    "MiniBatchTrainer",
    "TrainState",
    "create_train_state",
    "make_block_eval",
    "make_block_step",
    "make_full_batch_eval",
    "make_full_batch_step",
]
