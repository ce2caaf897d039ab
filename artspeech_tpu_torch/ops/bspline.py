"""B-spline contour regularization as a fixed linear projection
(counterpart of artspeech_tpu/ops/bspline.py; the basis is a copy).

The reference smooths a 50-point contour with a degree-3 B-spline fit. With
the sample count and spline fixed, the fit-and-evaluate round trip is a
constant N x N operator ``P = B (B^T B + lam * I)^-1 B^T``, built in float64
with numpy and applied as one float32 product over every contour.
"""

from functools import lru_cache

import numpy as np
import torch


def bspline_basis(n_points: int, n_ctrl: int, degree: int = 3) -> np.ndarray:
    """Clamped uniform B-spline design matrix of shape (n_points, n_ctrl).

    Evaluated at uniformly spaced parameters in [0, 1] via Cox-de Boor.
    """
    if n_ctrl <= degree:
        raise ValueError("n_ctrl must exceed degree")
    # Clamped uniform knot vector.
    n_knots = n_ctrl + degree + 1
    interior = n_knots - 2 * (degree + 1)
    knots = np.concatenate(
        [
            np.zeros(degree + 1),
            np.linspace(0.0, 1.0, interior + 2)[1:-1],
            np.ones(degree + 1),
        ]
    )
    ts = np.linspace(0.0, 1.0, n_points)
    # Cox-de Boor recursion, degree 0 base case.
    basis = np.zeros((len(ts), len(knots) - 1))
    for i in range(len(knots) - 1):
        basis[:, i] = (ts >= knots[i]) & (ts < knots[i + 1])
    # Make the last parameter value fall in the final span.
    basis[-1, :] = 0.0
    last_span = np.max(np.nonzero(knots < 1.0)[0])
    basis[-1, last_span] = 1.0
    for d in range(1, degree + 1):
        next_basis = np.zeros((len(ts), len(knots) - 1 - d))
        for i in range(len(knots) - 1 - d):
            left_den = knots[i + d] - knots[i]
            right_den = knots[i + d + 1] - knots[i + 1]
            left = 0.0
            if left_den > 0:
                left = (ts - knots[i]) / left_den * basis[:, i]
            right = 0.0
            if right_den > 0:
                right = (knots[i + d + 1] - ts) / right_den * basis[:, i + 1]
            next_basis[:, i] = left + right
        basis = next_basis
    return basis[:, :n_ctrl]


@lru_cache(maxsize=None)
def bspline_projection(
    n_points: int = 50, n_ctrl: int = 12, degree: int = 3, lam: float = 1e-6
) -> np.ndarray:
    """Precomputed (n_points, n_points) smoothing projection matrix."""
    basis = bspline_basis(n_points, n_ctrl, degree)
    gram = basis.T @ basis + lam * np.eye(n_ctrl)
    proj = basis @ np.linalg.solve(gram, basis.T)
    return proj.astype(np.float32)


def regularize_bsplines(contours: torch.Tensor, degree: int = 3, n_ctrl: int = 12) -> torch.Tensor:
    """Smooth contours (..., N, 2) with a least-squares B-spline fit."""
    n = contours.shape[-2]
    proj = torch.from_numpy(bspline_projection(n, n_ctrl, degree)).to(contours.device)
    return torch.matmul(proj.to(contours.dtype), contours)
