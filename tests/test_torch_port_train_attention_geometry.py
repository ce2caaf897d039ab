"""The launch rule of the port's training-attention backward, and its strip
walk, on the CPU.

``hopper_train_attention.train_attention_bwd_launch_geometry`` chooses, from
the shape alone, how ``csrc/train_attention.cu``'s strip backward launches:
groups a CTA, query rows a strip, threads a group, dK/dV units a thread and
shared memory. These tests hold the rule, over L in {1, 2, 31, 32, 33, 37,
64, 65, 127, 128, 255, 256, 511, 512} and hd in {1, 8, 16, 17, 32}, to what
the kernel needs: shared memory within a block's 232,448 bytes, whole warps
and at most 256 threads a CTA, every (4 keys, 4 dims) unit of dK and dV
owned, an instance for each (hd, units a thread), every G covered (G = 1 and
G not a multiple of the groups a CTA); every shape that the resident
backward took before the strip kernel (hd <= 32 while a group's four
(L, hd_max) row sets and two L-vectors fit the shared memory, at 1 to 4
groups a block) is still resident; and the wrapper passing the rule's
geometry to the kernel's entry point, checked through a fake library.

The kernel's walk, done here in numpy float32: strip by strip, the pair
blocks of 8 rows x 32 keys (those wholly above the diagonal skipped), P keep
and dS written for the block's pairs (0 where k > q or past L), then dK and
dV summed over the strip's rows in order from each unit's first key, and dQ
over keys 0 .. q rounded up to 4, in order. Rows not yet copied in and the
skipped blocks' buffer cells hold NaN, so a read the kernel must not make
shows. At L in {1, 7, 37, 128} and hd in {4, 16}, with the all-ones and a
dropout keep, at both strip heights, it is held against JAX's Pallas
``fused_causal_attend`` vjp in interpret mode within 1e-5 * max(|ref|, 1):
f32 sums of up to L terms taken in another order than XLA's (the port's
plain backward is held to the same vjp within 5e-5 absolute at L = 128 in
tests/test_torch_port_train_attention.py). No card is needed or asked for.
"""

import jax
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import pallas_train_attention
from artspeech_tpu_torch.ops import _build, hopper_train_attention

LS = (1, 2, 31, 32, 33, 37, 64, 65, 127, 128, 255, 256, 511, 512)
HDS = (1, 8, 16, 17, 32)
MAX_SMEM = 232448
#: (hd_max, units a thread) of the strip kernel's instances (train_attention.cu).
INSTANCES = {(16, 1), (16, 2), (32, 1), (32, 2), (32, 4)}


def _old_resident(l, hd):
    """The rule of the resident backward that the strip kernel replaced: a
    block of 128 threads held 1, 2 or 4 groups (L over 64, over 32, up to
    32), each with Q, K, V and dO rows of hd_max floats and lse and D."""
    hd_max = 16 if hd <= 16 else 32
    span = -(-l // 32) * 32
    groups = 1 if span >= 128 else 128 // span
    return hd <= 32 and l <= 512 and 4 * groups * (4 * l * hd_max + 2 * l) <= MAX_SMEM


@pytest.mark.parametrize("hd", HDS)
def test_rule_fits_the_kernel(hd):
    hd_max = 16 if hd <= 16 else 32
    for l in LS:
        assert hopper_train_attention.resident(l, hd)
        geo = hopper_train_attention.train_attention_bwd_launch_geometry(4320, l, hd)
        assert geo.tq in (16, 32) and (hd_max, geo.nku) in INSTANCES
        assert geo.threads % 32 == 0 and 32 <= geo.threads
        assert geo.groups * geo.threads <= hopper_train_attention.BWD_MAX_THREADS
        # Every (4 keys, 4 dims) unit owned: key4 = t / C4 + n * threads / C4.
        assert geo.nku * (geo.threads // (hd_max // 4)) >= -(-l // 4)
        assert geo.smem_bytes == 4 * geo.groups * hopper_train_attention.bwd_group_floats(
            l, hd, geo.tq) <= MAX_SMEM
        if l > 64:
            assert geo.groups == 1


def test_old_resident_shapes_stay_resident():
    for l in range(1, 513):
        for hd in range(1, 33):
            if _old_resident(l, hd):
                assert hopper_train_attention.resident(l, hd), (l, hd)
    assert not hopper_train_attention.resident(128, 33)
    assert not hopper_train_attention.resident(513, 16)


@pytest.mark.parametrize("l", (1, 33, 128, 512))
def test_every_group_has_a_cta(l):
    for g in (1, 2, 3, 5, 7, 360, 4321, 23040):
        geo = hopper_train_attention.train_attention_bwd_launch_geometry(g, l, 16)
        assert geo.ctas * geo.groups >= g > (geo.ctas - 1) * geo.groups


def test_thesis_shapes():
    """The transformer's backward (L = 128, hd = 16): one group a CTA, 4
    warps, strips of 16 rows; its dK/dV units one a thread."""
    geo = hopper_train_attention.train_attention_bwd_launch_geometry(4320, 128, 16)
    assert (geo.groups, geo.tq, geo.threads, geo.nku, geo.ctas) == (1, 16, 128, 1, 4320)


class _FakeLibrary:
    """Records the arguments of each call of the backward's entry points."""

    def __init__(self):
        self.calls = []

    def train_attention_bwd(self, *args):
        self.calls.append(("resident", args))
        return 0

    def train_attention_bwd_stream(self, *args):
        self.calls.append(("stream", args))
        return 0


def test_wrapper_passes_the_rule_geometry(monkeypatch):
    fake = _FakeLibrary()
    monkeypatch.setattr(hopper_train_attention, "_library", lambda: fake)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counter goes back to its value after the test.
    monkeypatch.setattr(hopper_train_attention, "launches_bwd", hopper_train_attention.launches_bwd)
    before = hopper_train_attention.launches_bwd
    for g, l, hd, n_pairs in ((4320, 128, 16, 90), (360, 33, 16, 90), (8, 512, 32, 2),
                              (6, 7, 5, 3), (8, 128, 64, 1)):
        q = torch.zeros((g, l, hd))
        keep = torch.ones((n_pairs, l, l))
        hopper_train_attention._launch_bwd(q, q, q, keep, q, torch.zeros((g, l)), q, n_pairs)
        route, args = fake.calls[-1]
        assert args[-1] == 0
        if hopper_train_attention.resident(l, hd):
            # 10 pointers, G, L, hd, n_pairs, geometry, stream.
            geo = hopper_train_attention.train_attention_bwd_launch_geometry(g, l, hd)
            assert route == "resident" and args[10:14] == (g, l, hd, n_pairs)
            assert args[14:19] == (geo.groups, geo.tq, geo.threads, geo.nku, geo.smem_bytes)
        else:  # the streamed kernels: the D scratch, their own geometries
            assert route == "stream" and args[10] != 0 and args[11:15] == (g, l, hd, n_pairs)
    assert hopper_train_attention.launches_bwd == before + 5
    assert "train_attention" not in _build._libraries


# -- the strip walk, against JAX ---------------------------------------------------

ROWS, KEYS = 8, 32  # a warp's pair block
BH = 8  # groups a pair (JAX's G_BLOCK)
TOL = 1e-5


def _round_up(x, m):
    return -(-x // m) * m


def _d_rows(do, out, hd_max):
    """D_q = dO_q . out_q as the kernel sums it: each 4-dim chunk from its
    last dim down, then a xor butterfly over the chunks."""
    g, l, _ = do.shape
    c4 = hd_max // 4
    prod = (do * out).reshape(g, l, c4, 4)
    parts = prod[..., 3]
    for e in (2, 1, 0):
        parts = parts + prod[..., e]
    o = c4 // 2
    while o:
        parts = parts + parts[..., np.arange(c4) ^ o]
        o //= 2
    return parts[..., 0]


def _strip_walk(q, k, v, keep, out, lse, do, n_pairs, tq):
    """dq, dk, dv as csrc/train_attention.cu's strip kernel computes them,
    all groups at once, in float32."""
    g, l, hd = q.shape
    hd_max = 16 if hd <= 16 else 32
    lr, c4 = _round_up(l, KEYS), hd_max // 4

    def padded(x):
        p = np.zeros((g, lr, hd_max), np.float32)
        p[:, :l, :hd] = x
        return p

    qp, kp, vp, dop = padded(q), padded(k), padded(v), padded(do)
    kg = keep[np.arange(g) // (g // n_pairs)]  # (G, L, L)
    lse_s = np.zeros((g, lr), np.float32)
    lse_s[:, :l] = lse
    d_s = np.zeros((g, lr), np.float32)
    d_s[:, :l] = _d_rows(padded(do)[:, :l], padded(out)[:, :l], hd_max)
    dka, dva = (np.zeros((g, lr, hd_max), np.float32) for _ in range(2))
    dq = np.zeros((g, l, hd_max), np.float32)
    keys = np.arange(lr)
    for i0 in range(0, l, tq):
        kc = min(i0 + tq, l)
        copied = keys < i0 + tq  # K and V rows in shared memory (zero from L on)
        ks = np.where(copied[None, :, None], kp, np.nan).astype(np.float32)
        vs = np.where(copied[None, :, None], vp, np.nan).astype(np.float32)
        ps = np.full((g, tq, lr), np.nan, np.float32)
        dss = np.full((g, tq, lr), np.nan, np.float32)
        nrb = tq // ROWS
        for blk in range(nrb * -(-kc // KEYS)):
            rb, kb = i0 + (blk % nrb) * ROWS, (blk // nrb) * KEYS
            if kb > rb + ROWS - 1 or rb >= l:
                continue
            r = np.arange(rb, rb + ROWS)
            kk = np.arange(kb, kb + KEYS)
            qr, dr = qp[:, r], dop[:, r]
            s = np.zeros((g, ROWS, KEYS), np.float32)
            dp = np.zeros((g, ROWS, KEYS), np.float32)
            for d in range(hd_max):
                s = s + qr[:, :, None, d] * ks[:, None, kb:kb + KEYS, d]
                dp = dp + dr[:, :, None, d] * vs[:, None, kb:kb + KEYS, d]
            valid = (kk[None, :] <= r[:, None]) & (r[:, None] < l)
            kmask = np.where(valid, kg[:, np.minimum(r, l - 1)][:, :, np.minimum(kk, l - 1)], 0)
            with np.errstate(all="ignore"):
                p = np.exp(s - lse_s[:, r, None])
                pk = np.where(valid, p * kmask, 0).astype(np.float32)
                ds = np.where(valid, p * (dp * kmask - d_s[:, r, None]), 0).astype(np.float32)
            ps[:, r - i0, kb:kb + KEYS] = pk
            dss[:, r - i0, kb:kb + KEYS] = ds
        # dK and dV: each unit of 4 keys from its first key, rows in order.
        first = keys // 4 * 4
        for r in range(i0, kc):
            on = (first <= r)[None, :, None]
            with np.errstate(all="ignore"):
                dva += np.where(on, ps[:, r - i0, :, None] * dop[:, r, None, :], 0).astype(np.float32)
                dka += np.where(on, dss[:, r - i0, :, None] * qp[:, r, None, :], 0).astype(np.float32)
        # dQ of the strip's rows: keys 0 .. q rounded up to 4, in order.
        rows = np.arange(i0, kc)
        acc = np.zeros((g, len(rows), hd_max), np.float32)
        for key in range(_round_up(kc, 4)):
            on = (key < (rows + 4) // 4 * 4)[None, :, None]
            with np.errstate(all="ignore"):
                acc += np.where(on, dss[:, rows - i0, key, None] * ks[:, key, None, :], 0).astype(np.float32)
        dq[:, i0:kc] = acc
    return dq[..., :hd], dka[:, :l, :hd], dva[:, :l, :hd]


def _inputs(l, hd, keep_kind, seed):
    rng = np.random.default_rng(seed)
    n_pairs = 2 if keep_kind == "dropout" else 1
    g = n_pairs * BH
    q, k = (rng.normal(size=(g, l, hd)).astype(np.float32) * hd**-0.5 for _ in range(2))
    v, do = (rng.normal(size=(g, l, hd)).astype(np.float32) for _ in range(2))
    if keep_kind == "dropout":
        keep = (rng.uniform(size=(n_pairs, l, l)) > 0.1).astype(np.float32) / np.float32(0.9)
    else:
        keep = np.ones((1, l, l), np.float32)
    return q, k, v, keep, do, n_pairs


def _lse(q, k):
    """The forward's log-sum-exp of each row's causal scores, float32."""
    l = q.shape[1]
    s = np.einsum("gqd,gkd->gqk", q.astype(np.float64), k.astype(np.float64))
    s = np.where(np.tril(np.ones((l, l), bool)), s, -np.inf)
    m = s.max(axis=-1)
    return (m + np.log(np.exp(s - m[..., None]).sum(axis=-1))).astype(np.float32)


@pytest.mark.parametrize("keep_kind", ("ones", "dropout"))
@pytest.mark.parametrize("hd", (4, 16))
@pytest.mark.parametrize("l", (1, 7, 37, 128))
def test_strip_walk_matches_the_pallas_vjp(l, hd, keep_kind):
    q, k, v, keep, do, n_pairs = _inputs(l, hd, keep_kind, seed=l + hd)
    out, vjp = jax.vjp(lambda *a: pallas_train_attention.fused_causal_attend(*a, keep, n_pairs),
                       q, k, v)
    refs = [np.asarray(x) for x in vjp(do)]
    lse = _lse(q, k)
    rule = hopper_train_attention.train_attention_bwd_launch_geometry(q.shape[0], l, hd).tq
    for tq in sorted({rule, 16, 32}):
        got = _strip_walk(q, k, v, keep, np.asarray(out), lse, do, n_pairs, tq)
        for name, a, ref in zip(("dq", "dk", "dv"), got, refs):
            scale = max(np.abs(ref).max(), 1.0)
            err = np.abs(a - ref).max() / scale
            assert np.isfinite(err) and err <= TOL, (name, tq, err)
