"""Kernel launches a synthesis request: the traced slice's kernels over its
requests."""

LAYER = "synthesis step host (synth/pipeline.py)"
UNIT = "launches"
MOVES = "infer_frames_per_s"


def read(r):
    kernels = r.view.kernels()
    return len(kernels) / r.units if kernels and r.units else None
