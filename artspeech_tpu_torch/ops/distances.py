"""Batched contour distances (counterpart of artspeech_tpu/ops/distances.py:
``pairwise_distances``, ``min_distance``, ``mean_p2cp``,
``mean_p2cp_channel_major``, ``min_pairwise_distance_channel_major``,
``euclidean_distance``, ``pearson_correlation``).

Shape-polymorphic over leading batch dims. On a CUDA tensor
``mean_p2cp_channel_major`` launches the P2CP kernel (ops/hopper_p2cp.py) and
``min_distance`` / ``min_distance_channel_major`` the min-distance kernel
(ops/hopper_min_dist.py); on a CPU tensor each runs its plain formula.
``min_pairwise_distance_channel_major`` is a plain differentiable formula on
every device, as the JAX package computes it outside any Pallas kernel.
"""

import torch

from artspeech_tpu_torch.ops import hopper_min_dist, hopper_p2cp


def pairwise_distances(u, v):
    """(..., N, D) and (..., M, D) point sets -> (..., N, M) Euclidean
    distances (``torch.cdist`` semantics)."""
    diff = u[..., :, None, :] - v[..., None, :, :]
    return torch.sqrt(torch.clamp((diff * diff).sum(dim=-1), min=0.0))


def min_distance(u, v):
    """Minimum pairwise distance and its argmin pair.

    Args:
        u: (..., N, 2); v: (..., M, 2) point-major.
    Returns:
        (dist, idx_u, idx_v), each (...,); ties go to the smallest flat index
        ``idx_u * M + idx_v`` (reference tract_variables.py:23-35).
    """
    return min_distance_channel_major(u.transpose(-1, -2), v.transpose(-1, -2))


def min_distance_channel_major(u, v):
    """min_distance for channel-major (..., 2, N) / (..., 2, M) contours.
    CUDA: the min-distance kernel (a gradient through the plain formula's
    VJP); CPU: the plain formula."""
    return hopper_min_dist.min_distance_channel_major(u, v)


def min_pairwise_distance_channel_major(u, v):
    """(...,) min_{i,j} |u_i - v_j| for channel-major (..., 2, N) / (..., 2, M)
    contours: the min over both point axes of the squared distances
    (``torch.amin``, whose gradient splits evenly among ties as JAX's ``min``
    does), then a sqrt of the winner. Differentiable; the critical loss of
    the latent RNN takes its gradient."""
    dx = u[..., 0, :, None] - v[..., 0, None, :]
    dy = u[..., 1, :, None] - v[..., 1, None, :]
    sq = torch.amin(dx * dx + dy * dy, dim=(-2, -1))
    return torch.sqrt(torch.clamp(sq, min=0.0))


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
    CUDA: the P2CP kernel (a gradient through the plain formula's VJP, as
    JAX's ``_mean_p2cp_fast``); CPU: the plain formula."""
    return hopper_p2cp.mean_p2cp_channel_major(u, v)


def euclidean_distance(outputs, targets):
    """(..., 2, D) contours -> (..., D) per-sample-point Euclidean distances
    (reference phoneme_to_articulation/metrics.py:5-24, reduction "none")."""
    diff = outputs - targets
    return torch.sqrt(torch.clamp((diff * diff).sum(dim=-2), min=0.0))


def pearson_correlation(outputs, targets, mask=None, axis=1, eps=1e-8):
    """Pearson correlation along ``axis`` (time), optionally masked: False
    entries of the broadcastable ``mask`` are ignored. The target deviations
    are taken around the target mean (reference metrics.py:9-35 subtracts the
    output mean there, a bug the JAX package does not replicate either)."""
    if mask is not None:
        w = mask.to(outputs.dtype)
        denom = torch.clamp(torch.sum(w, dim=axis, keepdim=True), min=1.0)
        mean_o = torch.sum(outputs * w, dim=axis, keepdim=True) / denom
        mean_t = torch.sum(targets * w, dim=axis, keepdim=True) / denom
        vo = (outputs - mean_o) * w
        vt = (targets - mean_t) * w
    else:
        vo = outputs - outputs.mean(dim=axis, keepdim=True)
        vt = targets - targets.mean(dim=axis, keepdim=True)
    num = torch.sum(vo * vt, dim=axis)
    den = torch.sqrt(torch.sum(vo * vo, dim=axis) * torch.sum(vt * vt, dim=axis))
    return num / torch.clamp(den, min=eps)
