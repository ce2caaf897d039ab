"""Plain reference of the synthesis geometry: B-spline smoothing of each
contour, the canonical upper incisor, the vocal-tract tube walls and the
area function on a semipolar grid.

A frozen copy of the program's plain torch geometry
(artspeech_tpu_torch/ops/bspline.py, ops/resample.py, geometry/tube.py,
geometry/area_function.py, as they stood when the benchmark was written),
so that later changes to the program are held to these semantics. The copy
keeps the program's order of computation on purpose: the synthesis check
runs each stage on the program's own output of the stage before (walls
from the program's contours, the area function from the program's walls),
and a wall-chain flip or a grid-crossing pick is a discrete choice that a
last-bit difference in its input could turn. The model stage is checked
against ``bigru.forward``, computed independently.
"""

from functools import lru_cache
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from portbench.reference.incisor import CANONICAL_UPPER_INCISOR

ARYTENOID_CARTILAGE = "arytenoid-cartilage"
EPIGLOTTIS = "epiglottis"
LOWER_INCISOR = "lower-incisor"
LOWER_LIP = "lower-lip"
PHARYNX = "pharynx"
SOFT_PALATE_MIDLINE = "soft-palate-midline"
THYROID_CARTILAGE = "thyroid-cartilage"
TONGUE = "tongue"
UPPER_INCISOR = "upper-incisor"
UPPER_LIP = "upper-lip"
VOCAL_FOLDS = "vocal-folds"


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


INTERNAL_WALL_ORDER: List[str] = [
    VOCAL_FOLDS,
    THYROID_CARTILAGE,
    EPIGLOTTIS,
    TONGUE,
    LOWER_INCISOR,
    LOWER_LIP,
]

EXTERNAL_WALL_ORDER: List[str] = [
    ARYTENOID_CARTILAGE,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    UPPER_INCISOR,
    UPPER_LIP,
]


def _dist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return ((a - b) ** 2).sum(dim=-1)


def _chain(contours: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate contours (..., N, 2) into one polyline, flipping for continuity.

    The first contour is oriented so its far end is closest to the next one;
    each later contour continues from the running endpoint.
    """
    first = contours[0]
    if len(contours) > 1:
        nxt = contours[1]
        approach = torch.minimum(_dist(nxt[..., 0, :], first[..., -1, :]),
                                 _dist(nxt[..., -1, :], first[..., -1, :]))
        approach_flipped = torch.minimum(_dist(nxt[..., 0, :], first[..., 0, :]),
                                         _dist(nxt[..., -1, :], first[..., 0, :]))
        flip = (approach_flipped < approach)[..., None, None]
        first = torch.where(flip, torch.flip(first, dims=[-2]), first)

    pieces = [first]
    end = first[..., -1, :]
    for contour in contours[1:]:
        flip = (_dist(contour[..., -1, :], end) < _dist(contour[..., 0, :], end))[..., None, None]
        oriented = torch.where(flip, torch.flip(contour, dims=[-2]), contour)
        pieces.append(oriented)
        end = oriented[..., -1, :]
    return torch.cat(pieces, dim=-2)


def generate_vocal_tract_tube(
    articulators_dict: Dict[str, torch.Tensor],
    wall_points: int = 100,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Internal and external walls, each (..., wall_points, 2), from
    articulator name -> (..., 50, 2) contours."""
    internal = _chain([articulators_dict[a] for a in INTERNAL_WALL_ORDER])
    external = _chain([articulators_dict[a] for a in EXTERNAL_WALL_ORDER])
    return (
        arclength_resample(internal, wall_points),
        arclength_resample(external, wall_points),
    )


def generate_vocal_tract_tube_batch(stack: torch.Tensor, articulators: Sequence[str],
                                    wall_points: int = 100):
    """Tube walls for a batch of frames.

    Args:
        stack: (..., Nart, 2, 50) contour stacks in model-output layout.
        articulators: names matching the Nart axis.
    Returns:
        (internal, external): each (..., wall_points, 2).
    """
    contours = {name: stack[..., i, :, :].transpose(-1, -2) for i, name in enumerate(articulators)}
    return generate_vocal_tract_tube(contours, wall_points)


_BIG = 1e30


def _cross2(a, b):
    return a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]


def _crossing_ts(p0, d, wall):
    """Line parameter t of every (grid line, wall segment) crossing.

    p0, d: (L, 2) line origins and directions; wall: (..., W, 2).
    Returns t, valid: (..., L, W-1).
    """
    q0 = wall[..., :-1, :]
    e = (wall[..., 1:, :] - wall[..., :-1, :])[..., None, :, :]  # (..., 1, S, 2)
    dl = d[:, None, :]  # (L, 1, 2)
    rel = q0[..., None, :, :] - p0[:, None, :]  # (..., L, S, 2)
    denom = _cross2(dl, e)  # (..., L, S)
    nonzero = torch.abs(denom) > 1e-12
    safe = torch.where(nonzero, denom, torch.ones_like(denom))
    t = _cross2(rel, e) / safe
    u = _cross2(rel, dl) / safe
    valid = nonzero & (t >= 0.0) & (t <= 1.0) & (u >= 0.0) & (u <= 1.0)
    return t, valid


def _compact(t, valid, k_cand):
    """The first ``k_cand`` valid ts of each line, in segment order, into
    slots (..., L, K) (0 where a slot is empty), and the slot occupancy."""
    rank = torch.cumsum(valid.to(torch.int64), dim=-1) - 1
    slot = torch.where(valid & (rank < k_cand), rank, torch.full_like(rank, k_cand))
    tc = torch.zeros(*t.shape[:-1], k_cand + 1, dtype=t.dtype, device=t.device)
    tc = tc.scatter(-1, slot, t)[..., :k_cand]
    count = valid.sum(dim=-1, keepdim=True)
    occupied = torch.arange(k_cand, device=t.device) < count
    return tc, occupied


def _select_min_t(tc, dist):
    """t at the first slot achieving each line's minimum distance."""
    hit = dist <= dist.min(dim=-1, keepdim=True).values
    first = hit.to(torch.int32).argmax(dim=-1, keepdim=True)
    return torch.gather(tc, -1, first)[..., 0]


def intersect_semipolar_grid(internal_wall, external_wall, semipolar_grid,
                             max_crossings: int = 16):
    """Intersect both walls with every grid line, pairing crossings by the
    reference's rules (area_function.py:176-223):

    - both walls crossed: the mutually nearest pair of crossings;
    - one wall crossed: its crossing nearest to the other wall's endpoints,
      the other wall contributing that endpoint;
    - neither crossed: the line is invalid; its points are the line origin.

    Args:
        internal_wall, external_wall: (..., W, 2) polylines.
        semipolar_grid: (L, R, 2) grid-line samples (endpoints used).
    Returns:
        (internal_pts (..., L, 2), external_pts (..., L, 2), valid (..., L)).
    """
    p0 = semipolar_grid[:, 0, :]
    p1 = semipolar_grid[:, -1, :]
    d = p1 - p0  # (L, 2)
    d2 = (d * d).sum(dim=-1)  # (L,)

    t_i, raw_val_i = _crossing_ts(p0, d, internal_wall)
    t_e, raw_val_e = _crossing_ts(p0, d, external_wall)
    k_cand = min(max_crossings, t_i.shape[-1])
    tc_i, val_i = _compact(t_i, raw_val_i, k_cand)
    tc_e, val_e = _compact(t_e, raw_val_e, k_cand)

    def point_at(t):
        return p0 + t[..., None] * d

    big = torch.tensor(_BIG, dtype=tc_i.dtype, device=tc_i.device)
    # Mutual-nearest pair: |pi - pj| = |ti - tj| * |d| -> scalar table.
    dt = torch.abs(tc_i[..., :, None] - tc_e[..., None, :])  # (..., L, K, K)
    dt = torch.where(val_i[..., :, None] & val_e[..., None, :], dt, big)
    int_pair = point_at(_select_min_t(tc_i, dt.min(dim=-1).values))
    ext_pair = point_at(_select_min_t(tc_e, dt.min(dim=-2).values))

    def one_wall(tc, val, other_wall):
        # dist^2(t, ep) on the line: |rel|^2 - 2 t (rel.d) + t^2 |d|^2.
        endpoints = torch.stack([other_wall[..., 0, :], other_wall[..., -1, :]], dim=-2)
        rel = endpoints[..., None, :, :] - p0[:, None, :]  # (..., L, 2, 2)
        rel_d = (rel * d[:, None, :]).sum(dim=-1)  # (..., L, 2)
        rel2 = (rel * rel).sum(dim=-1)
        dist = (
            rel2[..., None, :]
            - 2.0 * tc[..., :, None] * rel_d[..., None, :]
            + (tc**2 * d2[:, None])[..., :, None]
        )  # (..., L, K, 2)
        dist = torch.where(val[..., None], dist, big)
        own = point_at(_select_min_t(tc, dist.min(dim=-1).values))
        d_end = dist.min(dim=-2).values  # (..., L, 2)
        pick_last = (d_end[..., 1] < d_end[..., 0])[..., None]
        other = torch.where(pick_last, endpoints[..., None, 1, :], endpoints[..., None, 0, :])
        return own, other

    int_only_own, int_only_other = one_wall(tc_i, val_i, external_wall)
    ext_only_own, ext_only_other = one_wall(tc_e, val_e, internal_wall)

    hit_i = val_i.any(dim=-1)
    hit_e = val_e.any(dim=-1)
    both = (hit_i & hit_e)[..., None]
    only_i = (hit_i & ~hit_e)[..., None]
    only_e = (hit_e & ~hit_i)[..., None]
    valid = hit_i | hit_e

    internal_pts = torch.where(
        both, int_pair,
        torch.where(only_i, int_only_own, torch.where(only_e, ext_only_other, p0)))
    external_pts = torch.where(
        both, ext_pair,
        torch.where(only_e, ext_only_own, torch.where(only_i, int_only_other, p0)))
    return internal_pts, external_pts, valid


def area_function(internal_wall, external_wall, alpha: float = float(np.pi),
                  beta: float = 2.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Midline distance axis and area values from matched wall points.

    Args:
        internal_wall, external_wall: (..., L, 2) matched cross-section points.
    Returns:
        dists: (..., L) cumulative distance along the tube midline.
        fx: (..., L) area values ``alpha * radius ** beta``.
    """
    mid = (internal_wall + external_wall) / 2.0
    radius = torch.sqrt(torch.clamp(((internal_wall - external_wall) ** 2).sum(dim=-1), min=0.0)) / 2.0
    fx = alpha * radius**beta
    step = torch.sqrt(torch.clamp(((mid[..., 1:, :] - mid[..., :-1, :]) ** 2).sum(dim=-1), min=0.0))
    dists = torch.cat([torch.zeros_like(step[..., :1]), torch.cumsum(step, dim=-1)], dim=-1)
    return dists, fx


def evenly_spaced_fx(x, fx, n_samples: int = 200):
    """Resample (x, fx) (..., L) onto an evenly spaced x axis: (..., 2, n_samples)."""
    xs = linspace(x[..., 0], x[..., -1], n_samples)
    vals = interp1d(xs, x, fx)
    return torch.stack([xs, vals], dim=-2)


def tube_area_function(internal_wall, external_wall, semipolar_grid=None,
                       n_samples: int = 200, alpha: float = float(np.pi),
                       beta: float = 2.0):
    """Walls (..., W, 2) -> (grid-matched sections) -> (..., 2, n_samples)
    evenly spaced (position, area) samples.

    With ``semipolar_grid`` (L, R, 2) the wall points are matched through the
    grid; grid lines that touch neither wall collapse onto the nearest valid
    line (forward fill, backfilled at the head), which the even resampling
    treats as a removed section. Without it the walls are taken as
    index-matched.
    """
    if semipolar_grid is not None:
        grid = torch.as_tensor(semipolar_grid, dtype=internal_wall.dtype,
                               device=internal_wall.device)
        internal_wall, external_wall, valid = intersect_semipolar_grid(
            internal_wall, external_wall, grid)
        n_lines = valid.shape[-1]
        lines = torch.arange(n_lines, device=valid.device)
        fwd = torch.cummax(torch.where(valid, lines, -1), dim=-1).values  # last valid <= i
        bwd = torch.flip(
            torch.cummin(torch.flip(torch.where(valid, lines, n_lines), dims=[-1]), dim=-1).values,
            dims=[-1])  # first valid >= i (n_lines if none)
        take = torch.where(fwd >= 0, fwd, torch.clamp(bwd, max=n_lines - 1))
        take = take[..., None].expand(*take.shape, 2)
        internal_wall = torch.gather(internal_wall, -2, take)
        external_wall = torch.gather(external_wall, -2, take)
    dists, fx = area_function(internal_wall, external_wall, alpha=alpha, beta=beta)
    return evenly_spaced_fx(dists, fx, n_samples=n_samples)


def with_incisor(contours, articulators):
    """(B, T, Nart, 2, D) smoothed contours of the sorted ``articulators``
    -> (B, T, Nart + 1, 2, D) with the canonical upper incisor in its sorted
    place, and the full articulator list."""
    arts = sorted(articulators)
    if UPPER_INCISOR in arts:
        return contours, arts
    full = sorted(arts + [UPPER_INCISOR])
    i = full.index(UPPER_INCISOR)
    ref = torch.as_tensor(CANONICAL_UPPER_INCISOR, device=contours.device)
    ref = ref.expand(*contours.shape[:2], 1, *ref.shape)
    return torch.cat([contours[:, :, :i], ref, contours[:, :, i:]], dim=2), full


def smoothed(outputs):
    """(..., 2, D) contours -> the same, B-spline smoothed."""
    return regularize_bsplines(outputs.transpose(-1, -2)).transpose(-1, -2)
