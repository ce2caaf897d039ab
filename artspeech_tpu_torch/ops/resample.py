"""Contour / signal resampling (counterpart of artspeech_tpu/ops/resample.py).

The numpy resamplers are copies of the JAX package's host-side ones. The torch
functions batch over leading axes: where the JAX package ``vmap``s a per-frame
function, these take the frames as a leading axis.
"""

import numpy as np
import torch


def resample_nearest_np(points: np.ndarray, n_out: int) -> np.ndarray:
    """Nearest-neighbour index-space resample of (N, C) -> (n_out, C).

    Matches ``torch.nn.functional.interpolate(mode="nearest")`` semantics:
    ``src = floor(dst * N / n_out)``.
    """
    n_in = points.shape[0]
    idx = np.floor(np.arange(n_out) * (n_in / n_out)).astype(np.int64)
    idx = np.clip(idx, 0, n_in - 1)
    return points[idx]


def resample_linear_np(points: np.ndarray, n_out: int) -> np.ndarray:
    """Linear index-space resample of (N, C) -> (n_out, C) (align_corners=True)."""
    n_in = points.shape[0]
    if n_in == 1:
        return np.repeat(points, n_out, axis=0)
    src = np.linspace(0.0, n_in - 1.0, n_out)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    w = (src - lo)[:, None]
    return points[lo] * (1.0 - w) + points[hi] * w


def linspace(start: torch.Tensor, stop: torch.Tensor, num: int) -> torch.Tensor:
    """Batched ``jnp.linspace(start, stop, num)`` along a new last axis, with
    the same formula: ``start * (1 - i/div) + stop * (i/div)``, the last sample
    exactly ``stop``."""
    div = num - 1
    step = torch.arange(div, dtype=start.dtype, device=start.device) / div
    out = start[..., None] * (1 - step) + stop[..., None] * step
    return torch.cat([out, stop[..., None]], dim=-1)


def interp1d(x_new: torch.Tensor, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Piecewise-linear interpolation (clamped at the ends).

    Args:
        x_new: (..., K) query points.
        x: (..., N) sample locations, non-decreasing; its leading axes match
            ``x_new``'s (or both are 1-D).
        y: (..., N) sample values; extra leading axes broadcast over ``x``.
    Returns:
        (..., K). The segment index is ``count(x <= x_new) - 1`` clamped to
        ``[0, N-2]``; a zero-width segment (``x1 == x0``) takes weight 0.
    """
    n = x.shape[-1]
    idx = torch.searchsorted(x.contiguous(), x_new.contiguous(), right=True) - 1
    idx = idx.clamp(0, n - 2)
    x0 = torch.gather(x, -1, idx)
    x1 = torch.gather(x, -1, idx + 1)
    w = torch.where(x1 > x0, (x_new - x0) / torch.clamp(x1 - x0, min=1e-12),
                    torch.zeros_like(x_new))
    idx_y = idx.expand(*y.shape[:-1], idx.shape[-1])
    y0 = torch.gather(y, -1, idx_y)
    y1 = torch.gather(y, -1, idx_y + 1)
    return y0 * (1.0 - w) + y1 * w


def arclength_resample(points: torch.Tensor, n_out: int) -> torch.Tensor:
    """Resample polylines (..., N, 2) to (..., n_out, 2) points evenly spaced
    in arc length (x and y interpolated as functions of cumulative length)."""
    seg = points[..., 1:, :] - points[..., :-1, :]
    seglen = torch.sqrt(torch.clamp((seg * seg).sum(dim=-1), min=0.0))
    s = torch.cat([torch.zeros_like(seglen[..., :1]), torch.cumsum(seglen, dim=-1)], dim=-1)
    s_new = linspace(s[..., 0], s[..., -1], n_out)
    xs = interp1d(s_new, s, points[..., 0])
    ys = interp1d(s_new, s, points[..., 1])
    return torch.stack([xs, ys], dim=-1)
