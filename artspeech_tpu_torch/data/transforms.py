"""Normalization transforms (copy of artspeech_tpu/data/transforms.py;
reference phoneme_to_articulation/transforms.py:1-33)."""

import numpy as np


class Normalize:
    """(x - mean) / std with an exact inverse; works on numpy arrays or
    torch tensors."""

    def __init__(self, mean, std):
        self.mean = mean
        self.std = std

    def __call__(self, x):
        return (x - self.mean) / self.std

    def inverse(self, x_norm):
        return x_norm * self.std + self.mean


def load_articulator_norm_stats(stats_dir: str, articulators):
    """Load per-articulator mean/std npy files produced by
    calculate_normalization_statistics (reference scripts/...:16-83):
    ``{stats_dir}/{articulator}_{mean,std}.npy``."""
    norms = {}
    for articulator in articulators:
        mean = np.load(f"{stats_dir}/{articulator}_mean.npy")
        std = np.load(f"{stats_dir}/{articulator}_std.npy")
        norms[articulator] = Normalize(mean.astype(np.float32), std.astype(np.float32))
    return norms
