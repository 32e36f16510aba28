"""The whole training step's share (%) of the card's float32 peak: the model's
operations an epoch (``reference/<arch>.py`` ``train_flops`` on the graph's nodes
and edges) times the window's epochs a second, over 67 TFLOP/s (``counts.PEAKS``)."""
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole training step"
MOVES = "full_epoch_ms"


def read(run):
    if run.peaks is None or run.traffic.mode != "full" or not run.win:
        return None
    rate = run.flops_per_epoch() * run.win["epochs"] / run.win["seconds"]
    return 100.0 * rate / run.peaks["f32_ops_per_s"]
