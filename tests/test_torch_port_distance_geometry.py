"""The P2CP and min-distance kernels' launch rules and lane-grid walks, on the CPU.

``csrc/p2cp.cu`` and ``csrc/min_dist.cu`` walk a row's point pairs over the
lane grid of ``csrc/point_pairs.cuh`` with the tiles that
``hopper_p2cp.p2cp_launch_geometry`` and
``hopper_min_dist.min_dist_launch_geometry`` pick. These tests hold:

- the rules to what the kernels need, over N, M in {1, 15, 20, 25, 31, 32,
  33, 40, 50, 64, 400}: whole warps, shared memory within a block's 232,448
  B, every (i, j) pair of a row in exactly one lane's block, the compiled
  shapes where the paths call the kernels, the tile lists the same as the
  sources' X-macros;
- a numpy float32 model of the P2CP walk (points past N or M read the last
  real point, NaN-propagating minima, the reduce-scatter's ownership of the
  winners, the sums in the kernel's order) against JAX's
  ``mean_p2cp_pallas`` in interpret mode and
  ``distances.mean_p2cp_channel_major`` within 1e-5, NaN rows NaN in both;
- the tract variables' table of problems, built from ``ART_SLICES`` and the
  sorted articulator names;
- the grouped plain route (``tract_variables_from_stack`` on the CPU) and a
  numpy model of the grouped min-distance walk (each row's minima, then the
  first least key and its first column) against JAX's tract variables on
  seeded stacks with built-in ties and NaN points, values within 1e-6 and
  places of constriction equal; the model also against
  ``min_distance_pallas`` in interpret mode at each TV shape;
- the wrappers passing the rules' geometry and the table (sources read in
  place by their strides) to the entry points, through a fake library, and
  one launch for a stack's four tract variables.

No card is needed. The models follow the kernels' order of work: change
them together.
"""

import contextlib
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.geometry import tract_variables as jax_tv
from artspeech_tpu.ops import distances as jax_distances
from artspeech_tpu.ops.pallas_kernels import mean_p2cp_pallas, min_distance_pallas
from artspeech_tpu_torch.core.constants import (
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE_MIDLINE,
    TONGUE,
    TUBE_ARTICULATORS,
    UPPER_INCISOR,
    UPPER_LIP,
)
from artspeech_tpu_torch.geometry import tract_variables
from artspeech_tpu_torch.ops import _build, hopper_min_dist, hopper_p2cp, point_pairs
from artspeech_tpu_torch.ops.hopper_min_dist import Window

SIZES = (1, 15, 20, 25, 31, 32, 33, 40, 50, 64, 400)
MAX_SMEM = 232448
TV_SHAPES = {"LA": (50, 50), "TTCD": (15, 25), "TBCD": (20, 40), "VEL": (15, 50)}
ARTS = sorted(TUBE_ARTICULATORS)


def _pair_cover(n, m, tile):
    """How many lane blocks hold each real pair (i, j) of an N x M row."""
    lu, lv, (ku, kv) = point_pairs.LANES_U, point_pairs.LANES_V, tile[:2]
    u_tiles, v_chunks = point_pairs.blocks_of(n, m, tile)
    count = np.zeros((n, m), np.int64)
    for a in range(lu):
        for b in range(lv):
            for t in range(u_tiles):
                i = t * lu * ku + a + lu * np.arange(ku)
                for c in range(v_chunks):
                    j = c * lv * kv + b + lv * np.arange(kv)
                    ii, jj = np.meshgrid(i[i < n], j[j < m], indexing="ij")
                    np.add.at(count, (ii, jj), 1)
    return count


# -- the launch rules -----------------------------------------------------------------

@pytest.mark.parametrize("n", SIZES)
def test_p2cp_rule_fits_the_kernel(n):
    for m in SIZES:
        for rows in (1, 1001, 15360):
            geo = hopper_p2cp.p2cp_launch_geometry(rows, n, m)
            tile = (geo.points_u, geo.points_v)
            assert tile + ((n, m) if geo.exact else (0, 0)) in hopper_p2cp.TILES
            assert geo.exact == ((n, m) == (50, 50))
            assert 1 <= geo.warps <= point_pairs.WARPS and geo.threads == 32 * geo.warps
            per_cta = geo.warps * point_pairs.ROWS_A_WARP
            assert geo.blocks * per_cta >= rows > (geo.blocks - 1) * per_cta
            assert (geo.u_tiles, geo.v_chunks) == point_pairs.blocks_of(n, m, tile)
            # The staged rows, then the column minima where N takes several tiles.
            row_floats = 2 * (n + m) + (m if geo.u_tiles > 1 else 0)
            assert geo.smem_bytes == per_cta * 4 * row_floats <= MAX_SMEM
        assert (_pair_cover(n, m, tile) == 1).all(), (n, m)


@pytest.mark.parametrize("shapes", [list(TV_SHAPES.values()), [(20, 30)], [(1, 400), (400, 1)],
                                    [(64, 33), (31, 40), (50, 50)]])
def test_min_dist_rule_fits_the_kernel(shapes):
    for rows in (1, 1001, 1536):
        geo = hopper_min_dist.min_dist_launch_geometry(rows, shapes)
        assert sorted(p.slot for p in geo.problems) == list(range(len(shapes)))
        assert 1 <= geo.warps <= point_pairs.WARPS and geo.threads == 32 * geo.warps
        per_cta = geo.warps * point_pairs.ROWS_A_WARP
        pairs = []
        for k, p in enumerate(geo.problems):
            n, m = shapes[p.slot]
            tile = hopper_min_dist.TILES[p.tile]
            assert tile[2:] == ((n, m) if (n, m) in TV_SHAPES.values() else (0, 0))
            assert p.blocks * per_cta >= rows > (p.blocks - 1) * per_cta
            assert p.first_block == k * p.blocks
            assert (p.u_tiles, p.v_chunks) == point_pairs.blocks_of(n, m, tile)
            assert (_pair_cover(n, m, tile) == 1).all(), (n, m)
            pairs.append(n * m)
        assert pairs == sorted(pairs, reverse=True)  # the most pairs a row first
        assert geo.blocks == sum(p.blocks for p in geo.problems)
        assert geo.smem_bytes == per_cta * 4 * max(2 * (n + m) for n, m in shapes) <= MAX_SMEM
    if shapes == list(TV_SHAPES.values()):
        assert [p.slot for p in geo.problems] == [0, 2, 3, 1]  # LA, TBCD, VEL, TTCD


def _macro_tiles(name, macro):
    """The tuples of a source's X-macro list of tiles."""
    with open(os.path.join(_build.CSRC_DIR, name)) as f:
        text = f.read()
    body = re.search(rf"#define {macro}\(X\)((?:.*\\\n)*.*)", text).group(1)
    return [tuple(int(x) for x in t.split(",")) for t in re.findall(r"X\(([\d, ]+)\)", body)]


def test_tile_lists_are_the_sources():
    assert _macro_tiles("p2cp.cu", "P2CP_TILES") == list(hopper_p2cp.TILES)
    # min_dist.cu's tiles carry their id first.
    assert _macro_tiles("min_dist.cu", "MIN_DIST_TILES") == [
        (i, *t) for i, t in enumerate(hopper_min_dist.TILES)]
    assert _build.sources("p2cp")[1:] == _build.sources("min_dist")[1:] == [
        os.path.join(_build.CSRC_DIR, "point_pairs.cuh")]


# -- the P2CP walk, emulated -----------------------------------------------------------

def _fma32(a, b, c):
    """a * b + c rounded once to f32 (the kernel's FFMA)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _p2cp_walk(u, v):
    """Mean P2CP of u (R, 2, N), v (R, 2, M) f32 as csrc/p2cp.cu computes it
    at the rule's tile: each lane's pairs, the minima reduced over the
    group, each winner's root added by the lane that owns it, in the
    kernel's order, then the group's butterfly sum."""
    rows, n, m = u.shape[0], u.shape[-1], v.shape[-1]
    geo = hopper_p2cp.p2cp_launch_geometry(rows, n, m)
    lu, lv, ku, kv = point_pairs.LANES_U, point_pairs.LANES_V, geo.points_u, geo.points_v
    group, kup, kvp = lu * lv, point_pairs.padded(ku, lv), point_pairs.padded(kv, lu)
    tiles = n > lu * ku
    u_sum = np.zeros((group, rows), np.float32)
    v_sum = np.zeros((group, rows), np.float32)
    scol = np.full((rows, m), np.nan, np.float32)  # written before it is read
    for i0 in range(0, n, lu * ku):
        i_of = {a: np.minimum(i0 + a + lu * np.arange(ku), n - 1) for a in range(lu)}
        rmin = {}
        for j0 in range(0, m, lv * kv):
            cmin = {}
            for a in range(lu):
                for b in range(lv):
                    j = np.minimum(j0 + b + lv * np.arange(kv), m - 1)
                    dx = u[:, 0][:, i_of[a], None] - v[:, 0][:, None, j]
                    dy = u[:, 1][:, i_of[a], None] - v[:, 1][:, None, j]
                    d = _fma32(dy, dy, dx * dx)  # (R, KU, KV)
                    r = d.min(axis=2)  # NaN-propagating, as min.NaN
                    rmin[a, b] = r if j0 == 0 else np.minimum(rmin[a, b], r)
                    cmin[a, b] = d.min(axis=1)
            for b in range(lv):
                col = np.stack([cmin[a, b] for a in range(lu)]).min(axis=0)
                for a in range(lu):  # lane a owns entries (KVP / LU) a + s
                    for s in range(kvp // lu):
                        l = kvp // lu * a + s
                        j = j0 + b + lv * l
                        if l < kv and j < m:
                            if not tiles:
                                v_sum[a * lv + b] += np.sqrt(col[:, l])
                            else:
                                scol[:, j] = col[:, l] if i0 == 0 else np.minimum(scol[:, j],
                                                                                  col[:, l])
        for a in range(lu):
            row = np.stack([rmin[a, b] for b in range(lv)]).min(axis=0)
            for b in range(lv):  # lane b owns entries (KUP / LV) b + s
                for s in range(kup // lv):
                    k = kup // lv * b + s
                    if k < ku and i0 + a + lu * k < n:
                        u_sum[a * lv + b] += np.sqrt(row[:, k])
    if tiles:
        for lane in range(group):
            for j in range(lane, m, group):
                v_sum[lane] += np.sqrt(scol[:, j])
    off = group // 2
    while off:
        swap = [lane ^ off for lane in range(group)]
        u_sum, v_sum = u_sum + u_sum[swap], v_sum + v_sum[swap]
        off //= 2
    return (u_sum[0] / np.float32(n) + v_sum[0] / np.float32(m)) * np.float32(0.5)


def _p2cp_rows(rows, n, m, seed):
    rng = np.random.default_rng(seed)
    u = rng.random((rows, 2, n)).astype(np.float32)
    v = np.clip(u[..., np.arange(m) % n] + 0.05 * rng.normal(size=(rows, 2, m)), 0, 1)
    return u, v.astype(np.float32)


@pytest.mark.parametrize("rows, n, m", [(13, 50, 50), (5, 37, 61), (3, 400, 300), (9, 7, 5)])
def test_p2cp_walk_matches_jax(rows, n, m):
    u, v = _p2cp_rows(rows, n, m, seed=rows + n + m)
    if (n, m) == (50, 50):  # NaN in a u coordinate, a v coordinate, a whole u point
        u[2, 0, 7] = v[5, 1, 49] = np.nan
        u[8, :, 0] = np.nan
    with np.errstate(invalid="ignore"):
        got = _p2cp_walk(u, v)
    pallas = np.asarray(mean_p2cp_pallas(np.swapaxes(u, -1, -2), np.swapaxes(v, -1, -2),
                                         row_tile=8))
    xla = np.asarray(jax_distances.mean_p2cp_channel_major(jnp.asarray(u), jnp.asarray(v)))
    plain = hopper_p2cp.mean_p2cp_channel_major(torch.from_numpy(u), torch.from_numpy(v)).numpy()
    nan = np.isnan(xla)
    assert nan.sum() == (3 if (n, m) == (50, 50) else 0)
    for ref in (pallas, xla, plain):
        np.testing.assert_array_equal(np.isnan(ref), nan)
        np.testing.assert_array_equal(np.isnan(got), nan)
        np.testing.assert_allclose(got[~nan], ref[~nan], rtol=0, atol=1e-5)


# -- the tract variables' table and the grouped min-distance walk ---------------------

def test_tv_table_from_art_slices():
    names, problems = tract_variables.tv_table({a: 50 for a in ARTS})
    assert names == [LOWER_LIP, UPPER_LIP, TONGUE, UPPER_INCISOR, SOFT_PALATE_MIDLINE, PHARYNX]
    src = {name: k for k, name in enumerate(names)}
    assert problems == [
        (Window(src[LOWER_LIP], 0, 50), (Window(src[UPPER_LIP], 0, 50),)),       # LA
        (Window(src[TONGUE], 30, 15), (Window(src[UPPER_INCISOR], 25, 25),)),    # TTCD
        (Window(src[TONGUE], 10, 20), (Window(src[UPPER_INCISOR], 0, 25),        # TBCD
                                       Window(src[SOFT_PALATE_MIDLINE], 35, 15))),
        (Window(src[SOFT_PALATE_MIDLINE], 0, 15), (Window(src[PHARYNX], 0, 50),)),  # VEL
    ]
    assert list(tract_variables.TV_WINDOWS) == ["LA", "TTCD", "TBCD", "VEL"]
    assert [(p[0].count, sum(w.count for w in p[1])) for p in problems] == list(
        TV_SHAPES.values())


def _key(sq):
    """The kernel's key: every NaN first (0), then the squared distances."""
    return np.where(np.isnan(sq), 0, sq.view(np.uint32).astype(np.int64) + 1)


def _min_dist_walk(u, v, tile):
    """(dist, i, j) of u (R, 2, N), v (R, 2, M) f32 as csrc/min_dist.cu's walk
    finds them: per lane and block each u point's NaN-propagating minimum,
    the first u point with the least key, the first v point of that row with
    that key; then the least (key, flat index) over blocks and lanes."""
    rows, n, m = u.shape[0], u.shape[-1], v.shape[-1]
    lu, lv, (ku, kv) = point_pairs.LANES_U, point_pairs.LANES_V, tile[:2]
    r = np.arange(rows)
    best = np.full(rows, np.iinfo(np.int64).max)
    for i0 in range(0, n, lu * ku):
        for j0 in range(0, m, lv * kv):
            for a in range(lu):
                i = np.minimum(i0 + a + lu * np.arange(ku), n - 1)
                for b in range(lv):
                    j = np.minimum(j0 + b + lv * np.arange(kv), m - 1)
                    dx = u[:, 0][:, i, None] - v[:, 0][:, None, j]
                    dy = u[:, 1][:, i, None] - v[:, 1][:, None, j]
                    sq = dx * dx + dy * dy  # each operation rounded once, no FMA
                    row_key = _key(sq.min(axis=2))
                    k = row_key.argmin(axis=1)  # the first least
                    key = row_key[r, k]
                    l_best = (_key(sq[r, k]) == key[:, None]).argmax(axis=1)  # the first
                    flat = i[k] * m + j[l_best]
                    best = np.minimum(best, key * (n * m) + flat)  # (key, flat) in order
    flat = best % (n * m)
    i, j = flat // m, flat % m
    dx, dy = u[r, 0, i] - v[r, 0, j], u[r, 1, i] - v[r, 1, j]
    return np.sqrt(dx * dx + dy * dy), i, j


def _tv_stack(rows, seed):
    """A seeded (rows, 11, 2, 50) stack: ties built in (a lower-lip point equal
    to two upper-lip points; in rows 0-2 every contour one point), a NaN in
    the tongue tip (row 4) and in the upper lip (row 6)."""
    rng = np.random.default_rng(seed)
    stack = rng.random((rows, len(ARTS), 2, 50)).astype(np.float32)
    at = {a: k for k, a in enumerate(ARTS)}
    stack[:, at[UPPER_LIP], :, 12] = stack[:, at[UPPER_LIP], :, 40] = stack[:, at[LOWER_LIP], :, 7]
    stack[:3] = 0.5
    stack[4, at[TONGUE], 0, 35] = np.nan
    stack[6, at[UPPER_LIP], 1, 0] = np.nan
    return stack


def _model_tvs(stack):
    """The four TVs of a stack through the grouped walk's model, at the rule's tiles."""
    names, problems = tract_variables.tv_table({a: stack.shape[-1] for a in ARTS})
    sources = [stack[:, ARTS.index(name)] for name in names]
    shapes = [(p[0].count, sum(w.count for w in p[1])) for p in problems]
    geo = hopper_min_dist.min_dist_launch_geometry(stack.shape[0], shapes)
    tvs = {}
    for launch in geo.problems:
        u_window, v_windows = problems[launch.slot]
        u = sources[u_window.source][..., u_window.start:u_window.start + u_window.count]
        v = np.concatenate([sources[w.source][..., w.start:w.start + w.count] for w in v_windows],
                           axis=-1)
        value, i, j = _min_dist_walk(u, v, hopper_min_dist.TILES[launch.tile])
        r = np.arange(stack.shape[0])
        tvs[list(tract_variables.TV_WINDOWS)[launch.slot]] = {
            "value": value, "poc_1": u[r, :, i], "poc_2": v[r, :, j]}
    return tvs


def test_grouped_route_and_walk_match_jax_tract_variables():
    stack = _tv_stack(9, seed=5)
    ref = jax_tv.tract_variables_from_stack(jnp.asarray(stack), ARTS)
    with np.errstate(invalid="ignore"):
        model = _model_tvs(stack)
    plain = tract_variables.tract_variables_from_stack(torch.from_numpy(stack), ARTS)
    assert [k for k, d in plain.items() if d is not None] == ["LA", "TTCD", "TBCD", "VEL"]
    assert set(plain) == set(ref) and all(plain[k] is None for k in ("LP", "TTCL", "TBCL", "GLO"))
    for name in tract_variables.TV_WINDOWS:
        want = {k: np.asarray(x) for k, x in ref[name].items()}
        for got in (model[name], {k: t.numpy() for k, t in plain[name].items()}):
            np.testing.assert_allclose(got["value"], want["value"], rtol=0, atol=1e-6,
                                       err_msg=name)
            for poc in ("poc_1", "poc_2"):
                np.testing.assert_array_equal(got[poc], want[poc], err_msg=f"{name} {poc}")
    assert np.isnan(np.asarray(ref["TTCD"]["value"])[4]) and np.isnan(
        np.asarray(ref["LA"]["value"])[6])
    assert (np.asarray(ref["LA"]["value"])[:3] == 0).all()


@pytest.mark.parametrize("tv", sorted(TV_SHAPES))
def test_min_dist_walk_matches_pallas(tv):
    n, m = TV_SHAPES[tv]
    rng = np.random.default_rng(n * m)
    u = rng.random((9, 2, n)).astype(np.float32)
    v = rng.random((9, 2, m)).astype(np.float32)
    v[3, :, 4] = v[3, :, 9] = u[3, :, 2]  # a tie at distance 0: (2, 4) wins
    u[5, 1, 1] = np.nan
    tile = hopper_min_dist.TILES[hopper_min_dist.min_dist_launch_geometry(9, [(n, m)])
                                 .problems[0].tile]
    assert tile[2:] == (n, m)
    with np.errstate(invalid="ignore"):
        dist, i, j = _min_dist_walk(u, v, tile)
    pallas = [np.asarray(x) for x in min_distance_pallas(np.swapaxes(u, -1, -2),
                                                          np.swapaxes(v, -1, -2), row_tile=8)]
    np.testing.assert_allclose(dist, pallas[0], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(i, pallas[1])
    np.testing.assert_array_equal(j, pallas[2])
    assert (i[3], j[3]) == (2, 4) and np.isnan(dist[5]) and (i[5], j[5]) == (1, 0)


# -- the wrappers, through a fake library ------------------------------------------------

class _FakeLibrary:
    """Records each entry point's arguments and returns success."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


@pytest.fixture
def fake_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counters go back to their values after the test.
    monkeypatch.setattr(hopper_p2cp, "launches", hopper_p2cp.launches)
    monkeypatch.setattr(hopper_min_dist, "launches", hopper_min_dist.launches)


def test_p2cp_wrapper_launches_the_rule(monkeypatch, fake_cuda):
    lib = _FakeLibrary()
    monkeypatch.setattr(hopper_p2cp, "_library", lambda: lib)
    monkeypatch.setattr(hopper_p2cp, "_check", lambda u, v: None)
    for lead, n, m in (((12, 128, 10), 50, 50), ((7,), 37, 61), ((3, 2), 400, 300)):
        u, v = torch.zeros(*lead, 2, n), torch.zeros(*lead, 2, m)
        before = hopper_p2cp.launches
        out = hopper_p2cp._launch(u, v)
        assert hopper_p2cp.launches == before + 1 and out.shape == lead
        rows = int(np.prod(lead))
        geo = hopper_p2cp.p2cp_launch_geometry(rows, n, m)
        args = lib.calls["p2cp"]
        assert args[:3] == (u.data_ptr(), v.data_ptr(), out.data_ptr())
        # R, N, M, the tile (KU, KV, exact), warps, shared memory, stream.
        assert args[3:] == (rows, n, m, geo.points_u, geo.points_v, int(geo.exact), geo.warps,
                            geo.smem_bytes, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
def test_min_dist_wrapper_reads_the_stack_in_place(monkeypatch, fake_cuda, dtype):
    # Every storage type the kernel stages (its dtype code 0, 1, 2), never cast.
    lib = _FakeLibrary()
    monkeypatch.setattr(hopper_min_dist, "_library", lambda: lib)
    monkeypatch.setattr(hopper_min_dist, "_check", lambda sources, problems: None)
    stack = torch.zeros(3, 4, len(ARTS), 2, 50, dtype=dtype)
    names, problems = tract_variables.tv_table({a: 50 for a in ARTS})
    sources = [stack[..., ARTS.index(name), :, :] for name in names]
    before = hopper_min_dist.launches
    out, idx = hopper_min_dist._launch(sources, problems, with_idx=False)
    assert hopper_min_dist.launches == before + 1
    assert out.shape == (4, 3, 4, 5) and idx is None
    src, n_src, table, n_problems, rows, code, warps, blocks, smem, out_ptr, idx_ptr, _ = \
        lib.calls["min_dist"]
    assert (n_src, n_problems, rows, code, out_ptr, idx_ptr) == (
        6, 4, 12, [torch.float32, torch.bfloat16, torch.float16].index(dtype), out.data_ptr(),
        None)
    # Each source is the stack itself at its articulator's offset, by its strides: no copy.
    elem = stack.element_size()
    assert [tuple(src[4 * k:4 * k + 4]) for k in range(6)] == [
        (stack.data_ptr() + elem * 100 * ARTS.index(name), 100 * len(ARTS), 50, 1)
        for name in names]
    geo = hopper_min_dist.min_dist_launch_geometry(12, [(50, 50), (15, 25), (20, 40), (15, 50)])
    assert (warps, blocks, smem) == (geo.warps, geo.blocks, geo.smem_bytes)
    assert [tuple(table[12 * k:12 * k + 12]) for k in range(4)] == [
        (p.tile, p.slot, p.first_block, *problems[p.slot][0], *problems[p.slot][1][0],
         *(problems[p.slot][1][1] if len(problems[p.slot][1]) == 2 else (0, 0, 0)))
        for p in geo.problems]


def test_one_launch_for_a_stacks_four_tract_variables(monkeypatch, fake_cuda):
    """Off the CPU the four TVs are one launch of the kernel (on a meta
    stack, through the fake library), the single entry a table of one."""
    lib = _FakeLibrary()
    monkeypatch.setattr(hopper_min_dist, "_library", lambda: lib)
    monkeypatch.setattr(hopper_min_dist, "_check", lambda sources, problems: None)
    before = hopper_min_dist.launches
    tvs = tract_variables.tract_variables_from_stack(
        torch.zeros(2, 5, len(ARTS), 2, 50, device="meta"), ARTS)
    assert hopper_min_dist.launches == before + 1 and lib.calls["min_dist"][3] == 4
    assert tvs["TBCD"]["value"].shape == (2, 5) and tvs["VEL"]["poc_2"].shape == (2, 5, 2)
    dist, i, j = hopper_min_dist.min_distance_channel_major(
        torch.zeros(6, 2, 20, device="meta"), torch.zeros(6, 2, 30, device="meta"))
    assert hopper_min_dist.launches == before + 2 and lib.calls["min_dist"][1:4:2] == (2, 1)
    assert dist.shape == i.shape == j.shape == (6,) and i.dtype == torch.int64
