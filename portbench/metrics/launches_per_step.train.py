"""Kernel launches a train step: the traced slice's kernels over its steps."""

LAYER = "train step host (train/step.py)"
UNIT = "launches"
MOVES = "train_frames_per_s"


def read(r):
    kernels = r.view.kernels()
    return len(kernels) / r.units if kernels and r.units else None
