"""The launch rule of the port's streamed training-attention kernels, the
route each shape takes, and the plain route at wide head dims, on the CPU.

``hopper_train_attention.train_attention_stream_launch_geometry`` chooses,
from the shape alone, how each of ``csrc/train_attention.cu``'s streamed
kernels (the forward, dQ and dK/dV) launches: a CTA a tile of 32 rows of
one group, the columns a stage streams, and shared memory. These tests hold
the rule, at every L from 1 to 4,096 and every hd from 1 to 128, to what
the kernels need: shared memory within a block's 232,448 bytes and equal to
the kernels' own sum (``stream_cta_floats``), stages of 32 or 64 columns, a
CTA for each tile of each group; and hold the kernels' walk
(``stream::place`` and the chunk bounds, modelled here) to covering every
row of every group exactly once, with the CTAs of one pair's groups next to
each other, every key from 0 through each query row (the forward and dQ)
and every query from each key to L (dK/dV), with every warp of a CTA
walking the same chunks. They also hold the resident route
unchanged (``resident`` and the resident kernels' two launch rules at the
thesis shapes), the wrapper's dispatch (each shape to one entry point, with
its rule's geometry, through a fake library), and the plain route, which a
CPU tensor takes, against JAX's Pallas ``fused_causal_attend`` in interpret
mode at hd 64 and 128 (the forward within 2e-5, gradients within 5e-5, the
tolerances of tests/test_torch_port_train_attention.py). No card is needed
or asked for.
"""

import jax
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import pallas_train_attention
from artspeech_tpu_torch.ops import _build, hopper_train_attention as ta

MAX_SMEM = 232448
CHUNK = 32  # columns of a warp's block
LS = range(1, 4097)
HDS = range(1, 129)


def _tiles(l, rows):
    """First rows of the CTA tiles of one group (stream::place)."""
    return np.arange(0, -(-l // rows) * rows, rows)


@pytest.mark.parametrize("kind", ta.STREAM_KINDS)
def test_rule_fits_the_kernels(kind):
    assert ta.STREAM_THREADS == 4 * ta.STREAM_ROWS  # a warp each 8 rows of the tile
    for hd in HDS:
        for l in LS:
            geo = ta.train_attention_stream_launch_geometry(4320, l, hd, kind)
            assert geo.smem_bytes == 4 * ta.stream_cta_floats(kind, hd, geo.cols) <= MAX_SMEM, (
                l, hd)
            assert geo.cols in (32, 64)
            assert geo.ctas == -(-l // ta.STREAM_ROWS) * 4320


def _place(cta, l, g, last_first):
    """(first row, group) of CTA ``cta`` (train_attention.cu: stream::place)."""
    idx, group = divmod(cta, g)
    n_tiles = -(-l // ta.STREAM_ROWS)
    return (n_tiles - 1 - idx if last_first else idx) * ta.STREAM_ROWS, group


@pytest.mark.parametrize("l", (1, 7, 33, 128, 513, 576, 577, 1024))
def test_every_row_of_every_group_in_one_cta(l):
    rows = ta.STREAM_ROWS
    for g, n_pairs in ((1, 1), (2, 1), (3, 3), (7, 1), (8, 2), (45, 3), (360, 90)):
        for kind in ta.STREAM_KINDS:
            geo = ta.train_attention_stream_launch_geometry(g, l, 16, kind)
            places = [_place(cta, l, g, kind != "dkv") for cta in range(geo.ctas)]
            seen = sorted((x, r) for r0, x in places for r in range(r0, min(r0 + rows, l)))
            assert seen == [(x, r) for x in range(g) for r in range(l)]
            # a tile's CTAs take the groups in order: one pair's groups run together
            for cta in range(0, geo.ctas, g):
                tile = places[cta:cta + g]
                assert [x for _, x in tile] == list(range(g)) and len({r for r, _ in tile}) == 1
            # longest walk first: the last query tiles, the first key tiles
            firsts = [r0 for r0, _ in places[::g]]
            assert firsts == sorted(firsts, reverse=kind != "dkv")


@pytest.mark.parametrize("hd", (16, 33, 64, 128))
def test_walks_cover_every_causal_pair(hd):
    """The forward and dQ walk keys [0, kend) of whole chunks through the
    tile's diagonal chunk, the only one masked; dK/dV walks queries
    [q0, qend) from the key tile's diagonal chunk, the only one masked, to L.
    Every warp of a CTA walks those same chunks (rows divides 32)."""
    rows = ta.STREAM_ROWS
    assert CHUNK % rows == 0
    for kind in ta.STREAM_KINDS:
        for l in LS:
            r0 = _tiles(l, rows)
            last = np.minimum(r0 + rows, l) - 1  # each tile's last row
            if kind == "dkv":
                q0 = r0 // CHUNK * CHUNK
                qend = q0 + -(-(l - q0) // CHUNK) * CHUNK
                # queries from each key to L walked; the chunks before the
                # diagonal's hold no query >= any key of the tile
                assert (q0 <= r0).all() and (qend >= l).all() and (q0 + CHUNK > last).all()
            else:
                kend = (r0 // CHUNK + 1) * CHUNK
                # keys 0 .. each row walked; the chunks before the diagonal's
                # hold no key above any row of the tile
                assert (kend > last).all() and (kend - CHUNK <= r0).all()


def test_resident_route_unchanged():
    """L <= 512 with hd <= 32 keeps the resident kernels, at the launch
    geometries they had before the streamed kernels came; every other shape
    up to hd 128 leaves them."""
    for l in (1, 37, 128, 511, 512):
        for hd in (1, 16, 17, 32):
            assert ta.resident(l, hd)
    for l, hd in ((513, 16), (576, 16), (1024, 1), (128, 33), (1, 64), (512, 128)):
        assert not ta.resident(l, hd)
    f = ta.train_attention_fwd_launch_geometry(4320, 128, 16, 90)
    assert tuple(f) == (2, 16, 128, 2160, 54272)
    f = ta.train_attention_fwd_launch_geometry(23040, 512, 32, 90)
    assert (f.groups, f.tq, f.threads) == (1, 16, 64)
    b = ta.train_attention_bwd_launch_geometry(4320, 128, 16)
    assert tuple(b) == (1, 16, 128, 1, 4320, 4 * ta.bwd_group_floats(128, 16, 16))
    b = ta.train_attention_bwd_launch_geometry(360, 512, 32)
    assert (b.groups, b.tq, b.threads, b.nku) == (1, 16, 256, 4)


def test_thesis_long_bucket_geometry():
    """The long-bucket step's shape (G = 720, L = 576, hd 16): a CTA each 32
    rows of each group, 64-column stages; at hd 64 and 128, 32-column ones."""
    for kind, smem in (("fwd", 36864), ("dq", 38912), ("dkv", 39936)):
        assert tuple(ta.train_attention_stream_launch_geometry(720, 576, 16, kind)) == (
            64, 18 * 720, smem)
    for hd in (64, 128):
        assert ta.train_attention_stream_launch_geometry(4320, 128, hd, "dq").cols == 32


class _FakeLibrary:
    """Records the arguments of each call of the four entry points."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def entry(*args):
            self.calls.append((name, args))
            return 0
        return entry


SHAPES = ((4320, 128, 16, 90), (8, 512, 32, 2), (720, 576, 16, 90), (8, 128, 64, 1),
          (6, 65, 33, 3), (2, 37, 128, 1))


def test_wrapper_dispatch(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(ta, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counters go back to their values after the test.
    monkeypatch.setattr(ta, "launches_fwd", ta.launches_fwd)
    monkeypatch.setattr(ta, "launches_bwd", ta.launches_bwd)
    before = ta.launches_fwd, ta.launches_bwd
    for g, l, hd, n_pairs in SHAPES:
        q = torch.zeros((g, l, hd))
        keep = torch.ones((n_pairs, l, l))
        ta._launch_fwd(q, q, q, keep, n_pairs)
        ta._launch_bwd(q, q, q, keep, q, torch.zeros((g, l)), q, n_pairs)
        (fname, fargs), (bname, bargs) = fake.calls[-2:]
        assert fargs[6:10] == (g, l, hd, n_pairs) and fargs[-1] == 0 and bargs[-1] == 0
        if ta.resident(l, hd):
            f = ta.train_attention_fwd_launch_geometry(g, l, hd, n_pairs)
            b = ta.train_attention_bwd_launch_geometry(g, l, hd)
            assert (fname, bname) == ("train_attention_fwd", "train_attention_bwd")
            assert fargs[10:14] == (f.groups, f.tq, f.threads, f.smem_bytes)
            assert bargs[10:14] == (g, l, hd, n_pairs)
            assert bargs[14:19] == (b.groups, b.tq, b.threads, b.nku, b.smem_bytes)
        else:
            f, dq, dkv = (ta.train_attention_stream_launch_geometry(g, l, hd, kind)
                          for kind in ta.STREAM_KINDS)
            assert (fname, bname) == ("train_attention_fwd_stream", "train_attention_bwd_stream")
            assert fargs[10:12] == (f.cols, f.smem_bytes)
            assert bargs[10] != 0 and bargs[11:15] == (g, l, hd, n_pairs)  # the D scratch
            assert bargs[15:19] == (dq.cols, dq.smem_bytes, dkv.cols, dkv.smem_bytes)
    assert (ta.launches_fwd, ta.launches_bwd) == (before[0] + len(SHAPES), before[1] + len(SHAPES))
    assert "train_attention" not in _build._libraries


# -- the plain route at wide head dims, against JAX -------------------------------

N_PAIRS, BH, L = 2, 8, 128
FWD_TOL, GRAD_TOL = 2e-5, 5e-5


@pytest.mark.parametrize("keep_kind", ("dropout", "ones"))
@pytest.mark.parametrize("hd", (64, 128))
def test_plain_route_matches_jax_at_wide_head_dims(hd, keep_kind):
    rng = np.random.default_rng(hd)
    g = N_PAIRS * BH
    q, k = (rng.normal(size=(g, L, hd)).astype(np.float32) * np.float32(hd**-0.5)
            for _ in range(2))
    v, do = (rng.normal(size=(g, L, hd)).astype(np.float32) for _ in range(2))
    if keep_kind == "dropout":
        keep = (rng.uniform(size=(N_PAIRS, L, L)) > 0.2).astype(np.float32) / np.float32(0.8)
        n_pairs = N_PAIRS
    else:
        keep, n_pairs = np.ones((1, L, L), np.float32), 1
    assert not ta.resident(L, hd)
    out, vjp = jax.vjp(lambda *a: pallas_train_attention.fused_causal_attend(*a, keep, n_pairs),
                       q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = ta.fused_causal_attend(tq, tk, tv, torch.from_numpy(keep), n_pairs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=FWD_TOL)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for a, ref in zip(grads, vjp(do)):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), rtol=0, atol=GRAD_TOL)
