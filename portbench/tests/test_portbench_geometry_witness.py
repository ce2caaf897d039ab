"""A second witness for the synthesis geometry reference.

``reference/geometry.py`` is a frozen copy of the program's geometry, so a
fault that both share would pass the synthesis check. Here the copy is held
to what the geometry means, written out again independently: per frame, in
float64 NumPy with plain loops (the wall chain and its flips, resampling by
arc length, every grid line against every wall segment, the pairing rules,
the forward and backward fill of lines that miss both walls, the area and
its even resampling), and to a case with a closed form. The frames are what
the synthesis cell feeds the geometry: the reference model's smoothed
outputs from the benchmark's seeded weights, with the canonical incisor, on
the cell's semipolar grid.
"""

import numpy as np
import torch

from portbench.harness import inputs, manifest
from portbench.reference import bigru, geometry
from portbench.reference.grid import synthesis_grid


def _sq(a, b):
    return float(np.sum((a - b) ** 2))


def chain(contours):
    """One polyline through the contours (each (N, 2)) in order: the first
    turned so that its far end meets the second, each later one turned so
    that it starts at the end reached so far."""
    first = contours[0]
    if len(contours) > 1:
        nxt = contours[1]
        keep = min(_sq(nxt[0], first[-1]), _sq(nxt[-1], first[-1]))
        turned = min(_sq(nxt[0], first[0]), _sq(nxt[-1], first[0]))
        if turned < keep:
            first = first[::-1]
    pieces, end = [first], first[-1]
    for c in contours[1:]:
        if _sq(c[-1], end) < _sq(c[0], end):
            c = c[::-1]
        pieces.append(c)
        end = c[-1]
    return np.concatenate(pieces)


def interp(q, x, y):
    """Linear interpolation at each of ``q``: the segment whose start is the
    last sample at or below the query (clamped to the first and last
    segments), weight 0 on a segment of no width."""
    out = np.empty(len(q))
    for k, v in enumerate(q):
        i = min(max(int(np.sum(x <= v)) - 1, 0), len(x) - 2)
        w = (v - x[i]) / (x[i + 1] - x[i]) if x[i + 1] > x[i] else 0.0
        out[k] = y[i] * (1.0 - w) + y[i + 1] * w
    return out


def resample(points, n):
    s = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(points, axis=0), axis=1))])
    s_new = np.array([s[0] * (1 - i / (n - 1)) + s[-1] * (i / (n - 1)) for i in range(n)])
    return np.stack([interp(s_new, s, points[:, 0]), interp(s_new, s, points[:, 1])], axis=1)


def tube(frame, arts, n=100):
    """frame (Nart, 2, D) -> internal and external walls (n, 2)."""
    by_name = {a: frame[i].T for i, a in enumerate(arts)}
    return (resample(chain([by_name[a] for a in geometry.INTERNAL_WALL_ORDER]), n),
            resample(chain([by_name[a] for a in geometry.EXTERNAL_WALL_ORDER]), n))


#: The program counts at most this many crossings of a line with a wall,
#: the first in the wall's order (``max_crossings``, as the JAX package).
MAX_CROSSINGS = 16


def crossings(p0, d, wall):
    """The line parameters of the line's crossings with the wall's segments,
    in the wall's order, the first ``MAX_CROSSINGS`` of them."""
    ts = []
    for s in range(len(wall) - 1):
        q0, e = wall[s], wall[s + 1] - wall[s]
        denom = d[0] * e[1] - d[1] * e[0]
        if abs(denom) <= 1e-12:
            continue
        rel = q0 - p0
        t = (rel[0] * e[1] - rel[1] * e[0]) / denom
        u = (rel[0] * d[1] - rel[1] * d[0]) / denom
        if 0.0 <= t <= 1.0 and 0.0 <= u <= 1.0:
            ts.append(t)
    return ts[:MAX_CROSSINGS]


def sections(internal, external, grid):
    """Each grid line's pair of wall points and whether it met a wall: both
    walls met, the mutually nearest crossings; one met, its crossing nearest
    to an end of the other wall, and that end; none, the line's origin."""
    n = len(grid)
    pi, pe, valid = np.zeros((n, 2)), np.zeros((n, 2)), np.zeros(n, bool)
    for line in range(n):
        p0, d = grid[line, 0], grid[line, -1] - grid[line, 0]
        ti, te = crossings(p0, d, internal), crossings(p0, d, external)
        if ti and te:
            _, a, b = min((abs(a - b), a, b) for a in ti for b in te)
            pi[line], pe[line], valid[line] = p0 + a * d, p0 + b * d, True
        elif ti or te:
            ts, other = (ti, external) if ti else (te, internal)
            ends = [other[0], other[-1]]
            _, t = min((min(_sq(p0 + t * d, e) for e in ends), t) for t in ts)
            near = [min(_sq(p0 + t * d, e) for t in ts) for e in ends]
            end = ends[1] if near[1] < near[0] else ends[0]
            own = p0 + t * d
            pi[line], pe[line] = (own, end) if ti else (end, own)
            valid[line] = True
        else:
            pi[line] = pe[line] = p0
    return pi, pe, valid


def area(internal, external, grid, n=200):
    """(2, n): evenly spaced positions along the midline, and pi r^2 there."""
    pi, pe, valid = sections(internal, external, grid)
    lines = np.flatnonzero(valid)
    take = []
    for line in range(len(grid)):
        before = lines[lines <= line]
        after = lines[lines >= line]
        take.append(before[-1] if len(before) else (after[0] if len(after) else len(grid) - 1))
    pi, pe = pi[take], pe[take]
    mid = (pi + pe) / 2.0
    fx = np.pi * (np.linalg.norm(pi - pe, axis=1) / 2.0) ** 2
    x = np.concatenate([[0.0], np.cumsum(np.linalg.norm(np.diff(mid, axis=0), axis=1))])
    xs = np.array([x[0] * (1 - i / (n - 1)) + x[-1] * (i / (n - 1)) for i in range(n)])
    return np.stack([xs, interp(xs, x, fx)])


def cell_frames(n_sentences=2, t=6, seed=2**31 + 17):
    """Smoothed contours with the incisor, as the synthesis cell makes them."""
    m = manifest.load_manifest()
    cfg = manifest.load_config(manifest.config_entry(m, "artspeech_bigru"))
    weights = inputs.draw_weights(bigru.param_spec(cfg), seed, "cpu")
    lengths = torch.full((n_sentences,), t)
    tokens = inputs.tokens(lengths, t, cfg["vocab_size"], torch.Generator().manual_seed(seed))
    with torch.no_grad():
        out = bigru.forward(cfg, weights, tokens.long(), lengths)
    return geometry.with_incisor(geometry.smoothed(out), cfg["articulators"])


def test_walls_and_area_match_an_independent_computation_on_cell_frames():
    stack, arts = cell_frames()
    grid = torch.as_tensor(synthesis_grid())
    internal, external = geometry.generate_vocal_tract_tube_batch(stack, arts)
    got = geometry.tube_area_function(internal, external, grid)
    g = grid.double().numpy()
    frames = stack.reshape(-1, *stack.shape[2:]).double().numpy()
    flat = [x.reshape(-1, *x.shape[2:]).double().numpy() for x in (internal, external, got)]
    met = []
    for k, frame in enumerate(frames):
        want_i, want_e = tube(frame, arts)
        np.testing.assert_allclose(flat[0][k], want_i, atol=2e-6)
        np.testing.assert_allclose(flat[1][k], want_e, atol=2e-6)
        # The area from the copy's walls, so that float32 rounding of the
        # walls cannot turn a pick.
        np.testing.assert_allclose(flat[2][k], area(flat[0][k], flat[1][k], g), atol=2e-5)
        met.append(sections(flat[0][k], flat[1][k], g)[2])
    # The frames take both paths: lines that meet a wall and lines filled in.
    met = np.array(met)
    assert met.any(axis=1).all() and not met.all()


def test_area_of_parallel_walls_is_pi_r_squared():
    # Walls 0.2 apart across every line of a grid that crosses both.
    x = torch.linspace(0.0, 1.0, 100, dtype=torch.float64)
    internal = torch.stack([x, torch.zeros_like(x)], dim=1)
    external = torch.stack([x, torch.full_like(x, 0.2)], dim=1)
    dists, fx = geometry.area_function(internal, external)
    np.testing.assert_allclose(fx.numpy(), np.pi * 0.1 ** 2, rtol=1e-12)
    assert abs(float(dists[-1]) - 1.0) < 1e-12
    ys = np.linspace(0.05, 0.95, 19)
    grid = torch.as_tensor(np.stack([np.stack([ys, np.full_like(ys, -0.5)], 1),
                                     np.stack([ys, np.full_like(ys, 0.5)], 1)], 1))
    got = geometry.tube_area_function(internal, external, grid).numpy()
    np.testing.assert_allclose(got[1], np.pi * 0.1 ** 2, rtol=1e-12)
    np.testing.assert_allclose(got[0], np.linspace(0.0, 0.9, 200), atol=1e-12)


def test_independent_sections_cover_the_pairing_rules():
    # A line that meets both walls, one that meets only the internal wall
    # (the external wall's nearer end stands in), and one that meets neither.
    internal = np.array([[0.0, 2.0], [10.0, 2.0]])
    external = np.array([[0.0, 8.0], [4.0, 8.0]])
    grid = np.zeros((3, 2, 2))
    grid[0] = [[2, 0], [2, 10]]
    grid[1] = [[5, 0], [5, 10]]
    grid[2] = [[20, 0], [20, 10]]
    want = sections(internal, external, grid)
    got = geometry.intersect_semipolar_grid(*(torch.as_tensor(a) for a in
                                              (internal, external, grid)))
    np.testing.assert_allclose(want[0], [[2, 2], [5, 2], [20, 0]])
    np.testing.assert_allclose(want[1], [[2, 8], [4, 8], [20, 0]])
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-12)
