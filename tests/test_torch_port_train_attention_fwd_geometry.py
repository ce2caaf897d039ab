"""The launch rule of the port's training-attention forward, and its strip
walk, on the CPU.

``hopper_train_attention.train_attention_fwd_launch_geometry`` chooses, from
the shape alone, how ``csrc/train_attention.cu``'s strip forward launches:
groups a CTA (all of one pair), query rows a strip, threads and shared
memory. These tests hold the rule, over L in {1, 2, 31, 32, 33, 37, 64, 65,
127, 128, 255, 256, 511, 512} and hd in {1, 8, 16, 17, 32}, to what the
kernel needs: shared memory within a block's 232,448 bytes, whole warps (a
warp for each 8 rows of a strip and group) and at most 128 threads a CTA,
strips that every warp walks over the same keys, every group in exactly one
CTA (G = 1, and G not a multiple of the groups a CTA) and no CTA holding the
groups of two pairs; and the wrapper passing the rule's geometry to the
kernel's entry point, checked through a fake library.

The kernel's walk, done here in numpy float32: CTA by CTA, strip by strip,
the strip's q and keep rows (and, where a strip opens a 32-key chunk, that
chunk's K and V rows) copied into shared buffers; each 8-row block a warp,
lane (tq_l, tk_l) with rows tq_l + 4 i and keys tk_l + 8 j of each chunk,
chunk by chunk: the lane's max over its keys, its sum and accumulators
rescaled when that max passes the running max by more than 4, p = 2^((s - m)
log2 e), z += p, acc += p keep v; then the 8 key lanes of a row merged.
Cells not copied in hold NaN, so a read the kernel must not make shows. At L
in {1, 7, 37, 128} and hd in {4, 16}, with the all-ones and a dropout keep,
it is held against JAX's Pallas ``fused_causal_attend`` in interpret mode:
out within 1e-5 * max(|ref|, 1) (f32 sums of up to L terms in another
order), and lse within the same limit against a float64 log-sum-exp of the
causal scores. Two more walks, at L = 200 (hd 16) and L = 128 (hd 24) with
wider scores, make each lane's max rise past its running max after its sum
has begun, so the rescale is held too. No card is needed or asked for.
"""

import numpy as np
import pytest
import torch

from artspeech_tpu.ops import pallas_train_attention
from artspeech_tpu_torch.ops import _build, hopper_train_attention

LS = (1, 2, 31, 32, 33, 37, 64, 65, 127, 128, 255, 256, 511, 512)
HDS = (1, 8, 16, 17, 32)
MAX_SMEM = 232448
ROWS, KEYS = 8, 32  # a warp's row block; a chunk of keys
LOG2E = np.float32(1.4426950408889634)
RESCALE = np.float32(4)  # a lane's max may pass its running max by this before a rescale
TOL = 1e-5


def _round_up(x, m):
    return -(-x // m) * m


def _cta_groups(cta, groups, per_pair):
    """The groups CTA ``cta`` walks (train_attention.cu's forward kernel):
    a pair's groups fill ceil(per_pair / groups) CTAs in order."""
    ctas_per_pair = -(-per_pair // groups)
    pair, first = divmod(cta, ctas_per_pair)
    first *= groups
    return [pair * per_pair + first + s for s in range(min(groups, per_pair - first))]


@pytest.mark.parametrize("hd", HDS)
def test_rule_fits_the_kernel(hd):
    for l in LS:
        assert hopper_train_attention.resident(l, hd)
        geo = hopper_train_attention.train_attention_fwd_launch_geometry(4320, l, hd, 90)
        assert geo.tq in (8, 16, 32) and geo.groups >= 1
        assert geo.threads == 4 * geo.groups * geo.tq
        assert geo.threads % 32 == 0 and geo.threads <= hopper_train_attention.FWD_MAX_THREADS
        assert geo.smem_bytes == 4 * hopper_train_attention.fwd_cta_floats(
            l, hd, geo.groups, geo.tq) <= MAX_SMEM
        assert geo.ctas == 90 * -(-48 // geo.groups)


@pytest.mark.parametrize("l", LS)
def test_strip_blocks_walk_the_same_keys(l):
    """Every 8-row block of a strip ends its walk at the same chunk, so no
    warp of a strip waits at its barrier for the others' keys; a strip's
    keep rows are copied over exactly those chunks."""
    for hd in (16, 32):
        tq = hopper_train_attention.train_attention_fwd_launch_geometry(1, l, hd).tq
        for i0 in range(0, l, tq):
            ends = {KEYS * ((rb + ROWS - 1) // KEYS + 1) for rb in range(i0, i0 + tq, ROWS)}
            assert ends == {_round_up(i0 + 1, KEYS)}, (l, tq, i0, ends)


@pytest.mark.parametrize("l", (1, 33, 128, 512))
def test_every_group_in_one_cta_of_its_pair(l):
    for g, n_pairs in ((1, 1), (2, 1), (3, 3), (5, 1), (7, 7), (8, 2), (360, 90), (4321, 1),
                       (4320, 90), (23040, 90), (6, 2), (45, 3)):
        geo = hopper_train_attention.train_attention_fwd_launch_geometry(g, l, 16, n_pairs)
        per_pair = g // n_pairs
        seen = []
        for cta in range(geo.ctas):
            gs = _cta_groups(cta, geo.groups, per_pair)
            assert 1 <= len(gs) <= geo.groups
            assert len({x // per_pair for x in gs}) == 1  # one pair's keep a CTA
            seen += gs
        assert sorted(seen) == list(range(g)), (g, n_pairs, geo)


def test_thesis_shapes():
    """The transformer's forward (L = 128, hd = 16, 90 pairs): two groups of
    one pair a CTA, strips of 16 rows, 4 warps, 53 KB of shared memory."""
    for g, ctas in ((4320, 2160), (23040, 11520)):
        geo = hopper_train_attention.train_attention_fwd_launch_geometry(g, 128, 16, 90)
        assert (geo.groups, geo.tq, geo.threads, geo.ctas, geo.smem_bytes) == (
            2, 16, 128, ctas, 54272)


class _FakeLibrary:
    """Records the arguments of each call of the forward's entry points."""

    def __init__(self):
        self.calls = []

    def train_attention_fwd(self, *args):
        self.calls.append(("resident", args))
        return 0

    def train_attention_fwd_stream(self, *args):
        self.calls.append(("stream", args))
        return 0


def test_wrapper_passes_the_rule_geometry(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(hopper_train_attention, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counter goes back to its value after the test.
    monkeypatch.setattr(hopper_train_attention, "launches_fwd", hopper_train_attention.launches_fwd)
    before = hopper_train_attention.launches_fwd
    for g, l, hd, n_pairs in ((4320, 128, 16, 90), (360, 33, 16, 90), (8, 512, 32, 2),
                              (6, 7, 5, 3), (8, 128, 64, 1)):
        q = torch.zeros((g, l, hd))
        keep = torch.ones((n_pairs, l, l))
        out, lse = hopper_train_attention._launch_fwd(q, q, q, keep, n_pairs)
        assert out.shape == q.shape and lse.shape == (g, l)
        route, args = fake.calls[-1]
        # 6 pointers, G, L, hd, n_pairs, geometry, stream.
        assert args[6:10] == (g, l, hd, n_pairs) and args[-1] == 0
        if hopper_train_attention.resident(l, hd):
            geo = hopper_train_attention.train_attention_fwd_launch_geometry(g, l, hd, n_pairs)
            assert route == "resident"
            assert args[10:14] == (geo.groups, geo.tq, geo.threads, geo.smem_bytes)
        else:  # the streamed kernel and its own rule
            geo = hopper_train_attention.train_attention_stream_launch_geometry(g, l, hd)
            assert route == "stream" and args[10:12] == (geo.cols, geo.smem_bytes)
    assert hopper_train_attention.launches_fwd == before + 5
    assert "train_attention" not in _build._libraries


# -- the strip walk, against JAX ---------------------------------------------------

BH = 8  # groups a pair (JAX's G_BLOCK)


def _rows_in(x, r0, n, l, hd_max):
    """Rows [r0, r0 + n) of each (L, hd) matrix of x, zero past L and hd."""
    p = np.zeros((x.shape[0], n, hd_max), np.float32)
    rows = min(n, max(l - r0, 0))
    p[:, :rows, :x.shape[2]] = x[:, r0:r0 + rows]
    return p


def _fwd_walk(q, k, v, keep, n_pairs):
    """out and lse as csrc/train_attention.cu's strip forward computes them,
    in float32; NaN where the kernel would write nothing."""
    g, l, hd = q.shape
    geo = hopper_train_attention.train_attention_fwd_launch_geometry(g, l, hd, n_pairs)
    hd_max = 16 if hd <= 16 else 32
    nc, lr, tq, per_pair = 1, _round_up(l, KEYS), geo.tq, g // n_pairs  # nc: chunks a pass
    out = np.full((g, l, hd), np.nan, np.float32)
    lse = np.full((g, l), np.nan, np.float32)
    tk = np.arange(8)
    for cta in range(geo.ctas):
        gs = np.array(_cta_groups(cta, geo.groups, per_pair))
        keep_p = keep[gs[0] // per_pair]
        ks = np.full((len(gs), lr, hd_max), np.nan, np.float32)
        vs = np.full((len(gs), lr, hd_max), np.nan, np.float32)
        for i0 in range(0, l, tq):
            if i0 % KEYS == 0:
                ks[:, i0:i0 + KEYS] = _rows_in(k[gs], i0, KEYS, l, hd_max)
                vs[:, i0:i0 + KEYS] = _rows_in(v[gs], i0, KEYS, l, hd_max)
            qs = _rows_in(q[gs], i0, tq, l, hd_max)
            kend_strip = _round_up(i0 + 1, KEYS)
            keep_s = np.full((tq, lr + 8), np.nan, np.float32)
            keep_s[:, :kend_strip] = 0
            rows = min(tq, l - i0)
            keys = min(kend_strip, l)
            keep_s[:rows, :keys] = keep_p[i0:i0 + rows, :keys]
            for rb in range(i0, min(i0 + tq, l), ROWS):
                r = rb + np.arange(ROWS)  # the block's rows, lanes (tq_l, i) alike
                qr = qs[:, rb - i0:rb - i0 + ROWS]  # (G, 8, hd_max)
                kend = KEYS * ((rb + ROWS - 1) // KEYS + 1)
                m = np.full((len(gs), ROWS, 8), -np.inf, np.float32)  # (group, row, key lane)
                z = np.zeros((len(gs), ROWS, 8), np.float32)
                acc = np.zeros((len(gs), ROWS, 8, hd_max), np.float32)
                for kb0 in range(0, kend, nc * KEYS):
                    # key of (lane, e = 4 c + j): kb0 + 32 c + tk + 8 j
                    key = kb0 + KEYS * (np.arange(4 * nc) // 4)[None, :] + tk[:, None] \
                        + 8 * (np.arange(4 * nc) % 4)[None, :]
                    live = (key - tk[:, None]) // KEYS * KEYS < kend  # chunks the pass walks
                    kc = np.where(live, key, 0)
                    s = np.zeros((len(gs), ROWS, 8, 4 * nc), np.float32)
                    for d in range(hd_max):
                        s = s + qr[:, :, None, None, d] * ks[:, kc, d][:, None]
                    s = np.where(live[None, None] & (key[None, None] <= r[None, :, None, None]),
                                 s, -np.inf).astype(np.float32)
                    cm = s.max(axis=-1)
                    up = cm > m + RESCALE
                    with np.errstate(invalid="ignore"):  # alpha is NaN where up is False
                        alpha = np.exp2((m - cm) * LOG2E).astype(np.float32)
                        z = np.where(up, z * alpha, z)
                        acc = np.where(up[..., None], acc * alpha[..., None], acc)
                    m = np.where(up, cm, m)
                    ml = np.where(m == -np.inf, 0, m).astype(np.float32) * LOG2E
                    p = np.exp2(s * LOG2E - ml[..., None]).astype(np.float32)
                    for e in range(4 * nc):
                        z = z + p[..., e]
                    kp = keep_s[(r - i0)[:, None, None], kc[None]]  # (8, 8, 4 nc)
                    w = np.where(live, p * kp, 0).astype(np.float32)
                    for e in range(4 * nc):
                        acc = acc + w[..., e, None] * vs[:, kc[:, e]][:, None]
                mm = m.max(axis=-1, keepdims=True)
                scale = np.exp2((m - mm) * LOG2E).astype(np.float32)
                zz = (z * scale).sum(axis=-1)
                a = (acc * scale[..., None]).sum(axis=2)
                stored = r < l
                out[gs[:, None], r[stored]] = (a / zz[..., None])[:, stored, :hd]
                lse[gs[:, None], r[stored]] = (mm[..., 0] + np.log(zz))[:, stored]
    return out, lse


def _inputs(l, hd, keep_kind, seed):
    rng = np.random.default_rng(seed)
    n_pairs = 2 if keep_kind == "dropout" else 1
    g = n_pairs * BH
    q, k = (rng.normal(size=(g, l, hd)).astype(np.float32) * hd**-0.5 for _ in range(2))
    v = rng.normal(size=(g, l, hd)).astype(np.float32)
    if keep_kind == "dropout":
        keep = (rng.uniform(size=(n_pairs, l, l)) > 0.1).astype(np.float32) / np.float32(0.9)
    else:
        keep = np.ones((1, l, l), np.float32)
    return q, k, v, keep, n_pairs


def _lse64(q, k):
    """Each row's log-sum-exp over its causal scores, in float64."""
    l = q.shape[1]
    s = np.einsum("gqd,gkd->gqk", q.astype(np.float64), k.astype(np.float64))
    s = np.where(np.tril(np.ones((l, l), bool)), s, -np.inf)
    m = s.max(axis=-1)
    return m + np.log(np.exp(s - m[..., None]).sum(axis=-1))


@pytest.mark.parametrize("keep_kind", ("ones", "dropout"))
@pytest.mark.parametrize("hd", (4, 16))
@pytest.mark.parametrize("l", (1, 7, 37, 128))
def test_strip_walk_matches_the_pallas_forward(l, hd, keep_kind):
    q, k, v, keep, n_pairs = _inputs(l, hd, keep_kind, seed=3 * l + hd)
    ref = np.asarray(pallas_train_attention.fused_causal_attend(q, k, v, keep, n_pairs))
    out, lse = _fwd_walk(q, k, v, keep, n_pairs)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0)
    assert np.isfinite(err) and err <= TOL, err
    lse_ref = _lse64(q, k)
    lse_err = np.abs(lse - lse_ref).max() / max(np.abs(lse_ref).max(), 1.0)
    assert np.isfinite(lse_err) and lse_err <= TOL, lse_err


@pytest.mark.parametrize("l, hd", ((200, 16), (128, 24)))
def test_strip_walk_rescales_across_passes(l, hd):
    """Rows of several chunks, with wider scores, so that a lane's max rises
    past its running max after its sum has begun and the sum and
    accumulators are rescaled, at both row widths (hd_max 16 and 32)."""
    q, k, v, keep, n_pairs = _inputs(l, hd, "dropout", seed=l + hd)
    q = q * np.float32(4)  # wider scores: the max rises across passes more often
    ref = np.asarray(pallas_train_attention.fused_causal_attend(q, k, v, keep, n_pairs))
    out, lse = _fwd_walk(q, k, v, keep, n_pairs)
    err = np.abs(out - ref).max() / max(np.abs(ref).max(), 1.0)
    assert np.isfinite(err) and err <= TOL, err
    lse_ref = _lse64(q, k)
    lse_err = np.abs(lse - lse_ref).max() / max(np.abs(lse_ref).max(), 1.0)
    assert np.isfinite(lse_err) and lse_err <= TOL, lse_err
