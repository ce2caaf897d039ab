"""Batched contour distances (counterpart of artspeech_tpu/ops/distances.py:
``pairwise_distances``, ``mean_p2cp``, ``mean_p2cp_channel_major``,
``euclidean_distance``).

Shape-polymorphic over leading batch dims. ``mean_p2cp_channel_major`` on a
CUDA tensor launches the P2CP kernel (ops/hopper_p2cp.py); on a CPU tensor it
runs the plain formula. ``min_distance`` and its channel-major form come with
the tract-variables slice, together with their kernel.
"""

import torch

from artspeech_tpu_torch.ops import hopper_p2cp


def pairwise_distances(u, v):
    """(..., N, D) and (..., M, D) point sets -> (..., N, M) Euclidean
    distances (``torch.cdist`` semantics)."""
    diff = u[..., :, None, :] - v[..., None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=0.0))


def mean_p2cp(u, v):
    """Mean point-to-closest-point distance, both directions.

    Args:
        u: (..., N, 2); v: (..., M, 2) point-major.
    Returns:
        (...,) mean P2CP (reference phoneme_to_articulation/metrics.py:27-46).
    """
    return mean_p2cp_channel_major(u.transpose(-1, -2), v.transpose(-1, -2))


def mean_p2cp_channel_major(u, v):
    """mean_p2cp for channel-major (..., 2, N) / (..., 2, M) contours — the
    model-tensor layout (B, T, Nart, 2, n_samples), read without a transpose.
    CUDA: the P2CP kernel (forward only); CPU: the plain formula."""
    return hopper_p2cp.mean_p2cp_channel_major(u, v)


def euclidean_distance(outputs, targets):
    """(..., 2, D) contours -> (..., D) per-sample-point Euclidean distances
    (reference phoneme_to_articulation/metrics.py:5-24, reduction "none")."""
    diff = outputs - targets
    return torch.sqrt(torch.clamp((diff * diff).sum(dim=-2), min=0.0))
