"""The launch rule of the port's flash decode kernel, and the combine of its
split partials, on the CPU.

``hopper_attention.flash_decode_launch_geometry`` chooses, from the shape and
the card's SM count alone, how ``csrc/flash_decode.cu`` launches: lanes a
thread, CTAs a cluster (the cluster's CTAs split a lane block's rows), warps
a CTA (they split the CTA's share) and shared memory. These tests hold the
rule, over G in {1, 31, 32, 33, 480, 2,560, 4,320, 23,040}, n_rows in {1, 2,
7, 33, 64, 128, 512}, hd in {1, 16, 32, 64}, float32 and bfloat16 caches, at
the H100's 132 SMs and at 66, to what the kernel needs: every (row, lane)
read by exactly one (CTA, warp, thread), clusters of at most 8 CTAs and at
most n_rows, threads and shared memory within a block's limits, no warp
without rows; the decode's shapes on at least 100 CTAs wherever n_rows >= 16;
and the wrapper passing the rule's geometry to the kernel's entry point,
checked through a fake library.

The kernel's combine, done here in numpy: each split's (m, l, acc) over its
rows, the warps' partials rescaled to their CTA's max, then the CTAs'
partials in CTA order, a partial with no rows adding nothing. At the rule's
splits and at geometries with more splits than rows, from numpy-seeded
caches, it is held against JAX's Pallas ``flash_decode_attend`` in interpret
mode within 1e-5, with float32 and bfloat16 caches. No card is needed or
asked for.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops.pallas_attention import flash_decode_attend
from artspeech_tpu_torch.ops import _build, hopper_attention

SMS = 132
GS = (1, 31, 32, 33, 480, 2560, 4320, 23040)
N_ROWS = (1, 2, 7, 33, 64, 128, 512)
HDS = (1, 16, 32, 64)
ELEMS = {"float32": 4, "bfloat16": 2}


def _split_rows(split, splits, n_rows):
    """Rows [begin, end) of row split ``split`` of ``splits``, as
    flash_decode.cu's register instance takes them."""
    return split * n_rows // splits, (split + 1) * n_rows // splits


def _check_geometry(geo, g, n_rows, hd, elem):
    assert not geo.wide
    lb = hopper_attention.LANES * geo.lanes
    assert geo.lane_block == lb and geo.blocks == -(-g // lb)
    assert geo.ctas == geo.blocks * geo.cluster and geo.threads == 32 * geo.warps
    assert 1 <= geo.cluster <= min(hopper_attention.MAX_CLUSTER, n_rows)
    assert geo.cluster & (geo.cluster - 1) == 0  # a power of two
    assert 1 <= geo.warps <= hopper_attention.MAX_WARPS and geo.threads <= 1024
    assert geo.smem_bytes == hopper_attention.register_smem_bytes(hd, geo.warps, geo.lanes)
    assert geo.smem_bytes <= hopper_attention.MAX_SMEM
    if geo.lanes == 2:
        assert hd <= hopper_attention.PAIR_MAX_HD and g % 2 == 0
    # Lanes: block b's thread t reads lanes b * LB + t * lanes + j, j < lanes.
    lanes = (np.arange(geo.blocks)[:, None, None] * lb + np.arange(32)[None, :, None] * geo.lanes
             + np.arange(geo.lanes)[None, None, :]).ravel()
    assert (np.bincount(lanes[lanes < g], minlength=g) == 1).all()
    # Rows: CTA `rank` of a cluster, warp w takes split rank * W + w; every
    # cluster (lane block) splits the same rows.
    rows = np.zeros(n_rows, int)
    sizes = []
    for rank in range(geo.cluster):
        for warp in range(geo.warps):
            begin, end = _split_rows(rank * geo.warps + warp, geo.splits, n_rows)
            rows[begin:end] += 1
            sizes.append(end - begin)
    assert (rows == 1).all()
    assert min(sizes) >= 1 and max(sizes) == geo.rows_per_warp  # no warp without rows
    return geo


@pytest.mark.parametrize("g", GS)
def test_every_row_and_lane_read_once(g):
    for n_rows in N_ROWS:
        for hd in HDS:
            for elem in ELEMS.values():
                for sms in (SMS, SMS // 2):
                    geo = hopper_attention.flash_decode_launch_geometry(g, n_rows, hd, elem, sms)
                    _check_geometry(geo, g, n_rows, hd, elem)


def test_small_launches_cover_every_cell_once():
    """The (CTA, warp, thread) -> (row, lane) map itself, cell by cell."""
    for g, n_rows in ((33, 7), (32, 33), (1, 2), (64, 9)):
        for elem in ELEMS.values():
            geo = hopper_attention.flash_decode_launch_geometry(g, n_rows, 16, elem, 4)
            seen = np.zeros((n_rows, g), int)
            for cta in range(geo.ctas):
                block, rank = divmod(cta, geo.cluster)
                for warp in range(geo.warps):
                    begin, end = _split_rows(rank * geo.warps + warp, geo.splits,
                                                             n_rows)
                    for t in range(32):
                        for j in range(geo.lanes):
                            lane = block * geo.lane_block + t * geo.lanes + j
                            if lane < g:
                                seen[begin:end, lane] += 1
            assert (seen == 1).all(), (g, n_rows, geo)


@pytest.mark.parametrize("b", (12, 64))
def test_decode_shapes_fill_the_card(b):
    """The decode's calls (hd 16; self caches G = B*10*4, cross-channel
    B*10*9*4) run on at least 100 CTAs wherever n_rows >= 16; the large
    cross-channel caches take lane pairs."""
    for g in (b * 40, b * 360):
        for elem in ELEMS.values():
            for n_rows in (1, 16, 64, 128):
                geo = _check_geometry(
                    hopper_attention.flash_decode_launch_geometry(g, n_rows, 16, elem, SMS),
                    g, n_rows, 16, elem)
                if n_rows >= 16:
                    assert geo.ctas >= 100, (g, n_rows, geo)
    assert hopper_attention.flash_decode_launch_geometry(b * 360, 128, 16, 2, SMS).lanes == 2


def test_rule_follows_the_card():
    """On half the SMs the same call takes smaller clusters; a lane block's
    rows are split only as far as the card needs."""
    full = hopper_attention.flash_decode_launch_geometry(4320, 128, 16, 4, SMS)
    half = hopper_attention.flash_decode_launch_geometry(4320, 128, 16, 4, SMS // 2)
    assert (full.lanes, full.cluster, full.warps, full.ctas) == (2, 4, 2, 272)
    assert (half.lanes, half.cluster, half.warps, half.ctas) == (2, 2, 2, 136)
    large = hopper_attention.flash_decode_launch_geometry(23040, 128, 16, 4, SMS)
    assert (large.cluster, large.warps, large.ctas, large.rows_per_warp) == (1, 2, 360, 64)
    small = hopper_attention.flash_decode_launch_geometry(480, 128, 16, 4, SMS)
    assert (small.lanes, small.cluster, small.warps, small.ctas) == (1, 8, 5, 120)
    # 40 lane blocks would want clusters of 7: 4, with 4 warps.
    mid = hopper_attention.flash_decode_launch_geometry(2560, 128, 16, 2, SMS)
    assert (mid.lanes, mid.cluster, mid.warps, mid.ctas) == (2, 4, 4, 160)
    # Lane pairs need an even G and pointers aligned to a pair.
    assert hopper_attention.flash_decode_launch_geometry(23041, 128, 16, 4, SMS).lanes == 1
    assert hopper_attention.flash_decode_launch_geometry(23040, 128, 16, 4, SMS,
                                                         aligned=False).lanes == 1


@pytest.mark.parametrize("hd", (80, 128, 256))
def test_wide_instance_geometry(hd):
    for n_rows in (1, 3, 128):
        geo = hopper_attention.flash_decode_launch_geometry(40, n_rows, hd, 4, SMS)
        warps = min(n_rows, hopper_attention.WIDE_WARPS)
        assert geo.wide and (geo.lanes, geo.cluster, geo.warps, geo.ctas) == (1, 1, warps, 2)
        assert geo.smem_bytes == 4 * 32 * (warps * (hd + 2) + hd) <= hopper_attention.MAX_SMEM


class _FakeEntry:
    """Records the arguments of each call of the kernel's entry point."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


def test_wrapper_passes_the_rule_geometry(monkeypatch):
    fake = _FakeEntry()
    monkeypatch.setattr(hopper_attention, "_flash_entry", lambda: fake)
    monkeypatch.setattr(hopper_attention, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counter goes back to its value after the test.
    monkeypatch.setattr(hopper_attention, "launches", hopper_attention.launches)
    before = hopper_attention.launches
    for g, n_rows, hd, dtype in ((480, 128, 16, torch.float32), (4320, 16, 16, torch.bfloat16),
                                 (23040, 1, 16, torch.float32), (33, 7, 64, torch.bfloat16),
                                 (40, 3, 128, torch.float32), (4320, 16, 16, torch.float16)):
        k = torch.zeros((n_rows, hd, g), dtype=dtype)
        hopper_attention._launch(k, torch.zeros_like(k), torch.zeros((hd, g)), n_rows)
        geo = hopper_attention.flash_decode_launch_geometry(g, n_rows, hd, k.element_size(), SMS)
        # 4 pointers, hd, G, n_rows, the cache dtype (0 f32, 1 bf16, 2 f16), lanes,
        # cluster, warps, smem, stream.
        code = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}[dtype]
        assert fake.calls[-1][4:] == (hd, g, n_rows, code, geo.lanes, geo.cluster, geo.warps,
                                      geo.smem_bytes, 0)
    assert hopper_attention.launches == before + 6
    assert "flash_decode" not in _build._libraries


# -- the combine of split partials, against JAX ----------------------------------

S, HD, G = 64, 16, 256  # a shape JAX's Pallas kernel takes (tests/test_pallas_attention.py)


def _caches(dtype, seed):
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((S, HD, G)).astype(np.float32)).astype(dtype)
    v = jnp.asarray(rng.standard_normal((S, HD, G)).astype(np.float32)).astype(dtype)
    q = jnp.asarray(rng.standard_normal((HD, G)).astype(np.float32) * HD**-0.5)
    return k, v, q


def _partial(k, v, q, begin, end):
    """One split's (m, l, acc) over rows [begin, end): (G,), (G,), (HD, G)."""
    if begin == end:
        return np.full(G, -np.inf, np.float32), np.zeros(G, np.float32), np.zeros((HD, G), np.float32)
    s = np.einsum("rdg,dg->rg", k[begin:end], q).astype(np.float32)
    m = s.max(axis=0)
    p = np.exp(s - m)
    return m, p.sum(axis=0), np.einsum("rg,rdg->dg", p, v[begin:end]).astype(np.float32)


def _merge(parts):
    """The kernel's combine of partials, in their order: each rescaled to the
    largest m; a partial with m = -inf adds nothing."""
    m_all = np.max([m for m, _, _ in parts], axis=0)
    l_all, acc_all = np.zeros(G, np.float32), np.zeros((HD, G), np.float32)
    for m, l, acc in parts:
        scale = np.where(m == -np.inf, 0.0, np.exp(m - m_all)).astype(np.float32)
        l_all += l * scale
        acc_all += acc * scale
    return m_all, l_all, acc_all


def _split_attend(k, v, q, n_rows, cluster, warps):
    """The output the kernel writes at (cluster, warps): the warps' partials
    merged a CTA at a time, then the CTAs' in CTA order."""
    splits = cluster * warps
    ctas = [_merge([_partial(k, v, q, *_split_rows(r * warps + w, splits, n_rows))
                    for w in range(warps)]) for r in range(cluster)]
    _, l_all, acc_all = _merge(ctas)
    return acc_all / l_all


@pytest.mark.parametrize("cache_dtype", [jnp.float32, jnp.bfloat16])
def test_split_partials_merge_to_the_pallas_kernel(cache_dtype):
    k, v, q = _caches(cache_dtype, seed=3)
    kf, vf, qf = (np.asarray(x.astype(jnp.float32)) for x in (k, v, q))
    for n_rows in (1, 3, 37, S):
        ref = np.asarray(flash_decode_attend(k, v, q, n_rows - 1, S))
        geo = hopper_attention.flash_decode_launch_geometry(G, n_rows, HD, 4, SMS)
        # The rule's splits, then more splits than rows (warps and CTAs with none).
        for cluster, warps in ((geo.cluster, geo.warps), (min(n_rows, 2), 8), (min(n_rows, 3), 5)):
            got = _split_attend(kf, vf, qf, n_rows, cluster, warps)
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5,
                                       err_msg=f"n_rows={n_rows} C={cluster} W={warps}")
