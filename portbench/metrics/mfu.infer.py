"""The whole request's share of the card's float32 peak: the model's
forward FLOPs of the slice's valid frames (products only) over the slice's
time at 67 TFLOP/s."""

LAYER = "whole step"
UNIT = "%"
MOVES = "infer_frames_per_s"


def read(r):
    window = r.view.window_s
    return 100.0 * r.model_flops / (window * r.peak_flops) if window > 0 and r.units else None
