"""The whole train step's share of the card's float32 peak: the model FLOPs
of the slice's valid frames (forward, and twice that for the backward;
products only, no recomputation) over the slice's time at 67 TFLOP/s."""

LAYER = "whole step"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(r):
    window = r.view.window_s
    return 100.0 * r.model_flops / (window * r.peak_flops) if window > 0 and r.units else None
