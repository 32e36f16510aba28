"""The whole training step's share (%) of the card's float32 peak: the model's
operations a train seed (``reference/<arch>.py`` ``train_flops`` on the sampled
blocks' sizes, over the batch) times the window's train seeds a second, over
67 TFLOP/s (``counts.PEAKS``; TF32 is off)."""
UNIT = "%"
BETTER = "higher"
SOURCE = "host_clock"
LAYER = "whole training step"
MOVES = "train_seeds_per_s"


def read(run):
    if run.peaks is None or run.traffic.mode != "minibatch" or not run.win:
        return None
    rate = run.flops_per_seed() * run.win["seeds"] / run.win["seconds"]
    return 100.0 * rate / run.peaks["f32_ops_per_s"]
