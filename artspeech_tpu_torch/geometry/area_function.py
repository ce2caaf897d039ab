"""Area function from air-column walls (counterpart of
artspeech_tpu/geometry/area_function.py).

Frames are a leading batch axis ``...`` of the walls; the semipolar grid
(L, R, 2) is shared. Where the JAX package selects with one-hot einsums and
associative scans (TPU gathers are slow), this uses ``scatter``, ``gather``,
``argmax`` and ``cummax``/``cummin``, with the same semantics: the first K
valid crossings in segment order, the first index achieving a minimum, and a
forward fill with head backfill of grid lines that touch neither wall.
"""

from typing import Tuple

import numpy as np
import torch

from artspeech_tpu_torch.ops.resample import interp1d, linspace

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
