"""Bucketed fixed-shape batching (copy of artspeech_tpu/data/batching.py:
``DEFAULT_BUCKETS``, ``pick_bucket``, ``pad_to``).

Sentences are padded up to a small set of bucket lengths, so the synthesis
step sees a few shapes only.
"""

from typing import Sequence

import numpy as np

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to(arr: np.ndarray, length: int, pad_value=0.0) -> np.ndarray:
    """Pad (or truncate) axis 0 of arr to ``length``."""
    if arr.shape[0] >= length:
        return arr[:length]
    pad_width = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)
