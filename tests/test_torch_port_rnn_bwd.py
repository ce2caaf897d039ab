"""The recurrent backward kernels' launch rule and plain versions, on the CPU.

``hopper_gru.rnn_bwd_launch_geometry`` chooses, from the shape and the
card's SM count alone, how ``csrc/gru_bwd.cu`` (G = 3 gates) and
``csrc/lstm_bwd.cu`` (G = 4) launch: the cluster backward step of
``csrc/rnn_bwd_step.cuh`` or the wide instance. These tests hold the rule to
what the kernels need, over G in {3, 4}, B in {1, 3, 12, 16, 64, 256}, D in
{1, 2}, H in {6, 16, 128, 136, 256, 1024}, f32 and bf16, at the H100's 132
SMs: every batch row in exactly one tile, threads and shared memory within
a block's limits, a portable cluster size that divides H, scratch and
partials sized as the kernels index them; the thesis and latent-RNN shapes
with every CTA resident at once; ``resident()`` answered without a library
or a card; and both wrappers launching what the rule says.

The plain backwards (``gru_sequence_backward_reference``,
``lstm_sequence_backward_reference``), which the card holds the kernels to,
are held to ``jax.vjp`` of the JAX package at the card checks' small edge
shapes (B = 1 and 13, T = 1, H = 6, 20 and 136): of the Pallas
``gru_sequence`` / ``lstm_sequence`` in interpret mode where T is a whole
number of its 4-step chunks (T = 4, 8), of the scan ``ops/gru.py`` runs
otherwise (T = 1, 9), with the same numpy-seeded inputs; f32 within
``1e-5 * max(|ref|, 1)``, bf16 within ``2^-6 * max(|ref|, 1)`` (as
tests/test_torch_port_train.py).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import gru as jax_gru
from artspeech_tpu.ops import pallas_gru
from artspeech_tpu_torch.ops import hopper_gru, hopper_lstm

SMS = 132
BATCHES = (1, 3, 12, 16, 64, 256)
HIDDEN = (6, 16, 128, 136, 256, 1024)
DTYPES = {"float32": 4, "bfloat16": 2}


def _smem(hidden, c, rows, gates, elem):
    """rnn_bwd_step.cuh:smem_bytes, written out again."""
    units = hidden // c
    cols = -(-4 * -(-units // 4) * gates // 8) * 8  # unit-major, groups of 4 units
    hk = -(-hidden // 8) * 8
    w = -(-hk * cols * elem // 16) * 16
    stage = max(hk * 68, 32 * (hk + 4 + cols))
    return w + 4 * (2 * rows * hidden + 2 * rows * cols + stage)


@pytest.mark.parametrize("gates", (3, 4))
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_geometry_fits_the_kernels(gates, dtype):
    elem = DTYPES[dtype]
    for hidden in HIDDEN:
        for batch in BATCHES:
            for n_dir in (1, 2):
                geo = hopper_gru.rnn_bwd_launch_geometry(batch, n_dir, hidden, gates, elem, SMS)
                c, rows, tiles = geo.cluster, geo.rows, geo.tiles
                # Every batch row in exactly one tile of one cluster.
                assert tiles * rows >= batch > (tiles - 1) * rows
                assert geo.grid == (c * tiles, n_dir) and geo.ctas == c * tiles * n_dir
                assert geo.waves == -(-geo.ctas // (SMS * geo.ctas_per_sm))
                assert geo.smem_bytes <= hopper_gru.MAX_SMEM
                assert geo.threads <= hopper_gru.MAX_THREADS and geo.threads % 32 == 0
                if geo.resident:
                    units = hidden // c
                    assert c in (1, 2, 4, 8) and hidden % c == 0
                    assert rows in (2, 4, 8) and rows * units <= geo.threads
                    # One thread a k of the dh product and a (row, unit) of the cell.
                    assert geo.threads == 256 and hidden <= 256
                    assert geo.smem_bytes == _smem(hidden, c, rows, gates, elem)
                    # Two CTAs an SM only where both fit its 228 KiB.
                    assert geo.ctas_per_sm == (2 if 2 * (geo.smem_bytes + 1024) <= 233472 else 1)
                    values = {3: 5, 4: 6}[gates]
                    assert geo.scratch_per_step == n_dir * tiles * rows * values * hidden
                else:
                    assert (c, rows, geo.threads) == (1, 4, 512)
                    assert geo.scratch_per_step == n_dir * batch * gates * hidden


@pytest.mark.parametrize("gates, hidden, resident", [
    (3, 6, True), (3, 128, True), (3, 130, True), (3, 136, True), (3, 256, True),
    (3, 264, False), (3, 512, False), (3, 1024, False), (4, 6, True), (4, 128, True),
    (4, 168, True), (4, 256, True), (4, 264, False), (4, 1024, False)])
def test_instance_of_each_width(gates, hidden, resident):
    """The cluster step to H = 256 (one thread a k of the dh product), where
    a CTA's W_h slice, buffers and stage fit; the wide instance above; bf16
    alike. The instance does not depend on the batch."""
    got = {hopper_gru.rnn_bwd_launch_geometry(b, d, hidden, gates, 4).resident
           for b in BATCHES for d in (1, 2)}
    assert got == {resident}
    if resident:
        assert hopper_gru.rnn_bwd_launch_geometry(16, 2, hidden, gates, 2).resident


def test_thesis_and_latent_rnn_shapes_run_in_one_wave():
    """The thesis GRU (B = 12, 16, 256) and the latent RNN's LSTM (B = 12,
    64), H = 128, both directions and one: the cluster step, every CTA
    resident at once; and the geometry the rule gives them in f32."""
    for gates, batches in ((3, (12, 16, 256)), (4, (12, 64))):
        for batch in batches:
            for n_dir in (1, 2):
                for elem in DTYPES.values():
                    geo = hopper_gru.rnn_bwd_launch_geometry(batch, n_dir, 128, gates, elem, SMS)
                    assert geo.resident and geo.waves == 1 and geo.ctas <= SMS * geo.ctas_per_sm
    expect = {(3, 12): (8, 2, 96), (3, 16): (8, 2, 128), (3, 256): (4, 8, 256),
              (4, 12): (8, 2, 96), (4, 64): (4, 2, 256)}
    for (gates, batch), (c, rows, ctas) in expect.items():
        geo = hopper_gru.rnn_bwd_launch_geometry(batch, 2, 128, gates, 4, SMS)
        assert (geo.cluster, geo.rows, geo.ctas, geo.threads) == (c, rows, ctas, 256)
        assert geo.ctas_per_sm == 2


def test_rule_follows_the_card():
    """On a quarter of the SMs the rule takes smaller clusters; where no
    candidate fits the card at once, the one with the fewest CTAs."""
    geo = hopper_gru.rnn_bwd_launch_geometry(16, 2, 128, 3, 4, SMS // 4)
    assert geo.ctas <= 2 * (SMS // 4) and (geo.cluster, geo.rows) == (4, 2)
    geo = hopper_gru.rnn_bwd_launch_geometry(256, 2, 128, 4, 4, SMS // 2)
    assert geo.waves > 1 and geo.ctas == min(
        -(-256 // r) * 2 * c for r in (2, 4, 8) for c in (8, 4, 2, 1)
        if r * 128 // c <= 256
        and hopper_gru.bwd_cluster_smem_bytes(128, c, r, 4, 4) <= hopper_gru.MAX_SMEM)


def test_resident_needs_no_library_or_card(monkeypatch):
    def no_library(name):
        raise AssertionError(f"resident() asked the {name} library")

    monkeypatch.setattr(hopper_gru, "_library", no_library)
    monkeypatch.setattr(hopper_lstm, "_library", no_library)
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_library)
    for hidden in HIDDEN + (130, 168, 512):
        for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
            for mod, name, gates in ((hopper_gru, "gru_bwd", 3), (hopper_lstm, "lstm_bwd", 4)):
                rule = hopper_gru.rnn_bwd_launch_geometry(1, 1, hidden, gates, elem).resident
                assert mod.resident(name, hidden, dtype) is rule


class _FakeLibrary:
    """Records the ints each backward entry point is called with."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def test_both_wrappers_launch_the_rule(monkeypatch):
    """gru_bwd and lstm_bwd get the rule's (cluster, rows, smem), and the
    scratch and partials are sized from its tiles and scratch_per_step."""
    lib = _FakeLibrary()
    for mod in (hopper_gru, hopper_lstm):
        monkeypatch.setattr(mod, "_library", lambda name: lib)
        monkeypatch.setattr(mod, "_check", lambda *args: None)
        monkeypatch.setattr(mod, "bwd_launches", mod.bwd_launches)
    monkeypatch.setattr(hopper_gru, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    sizes = []
    buffers = hopper_gru.bwd_launch_buffers

    def recorded(x_proj, n_dir, hidden, gates):
        out = buffers(x_proj, n_dir, hidden, gates)
        sizes.append((out[0], *(t.shape for t in out[1:])))
        return out

    monkeypatch.setattr(hopper_gru, "bwd_launch_buffers", recorded)
    t = 3
    for batch, hidden in ((1, 6), (12, 128), (13, 136), (64, 128), (5, 512)):
        for gates, mod, name in ((3, hopper_gru, "gru_bwd"), (4, hopper_lstm, "lstm_bwd")):
            for n_dir in (1, 2):
                xp = torch.zeros(t, batch, n_dir * gates * hidden)
                wh = torch.zeros(n_dir, hidden, gates * hidden)
                bh = torch.zeros(n_dir, gates * hidden)
                mask = torch.ones(t, batch, dtype=torch.bool)
                ys = torch.zeros(t, batch, n_dir * hidden)
                if gates == 3:
                    mod._launch_bwd(xp, wh, bh, mask, ys, ys, n_dir, 0)
                else:
                    mod._launch_bwd(xp, wh, bh, mask, ys, ys, ys, n_dir, 0)
                geo = hopper_gru.rnn_bwd_launch_geometry(batch, n_dir, hidden, gates, 4, SMS)
                # ..., n_dir, rev_bits, dtype, cluster, rows, smem, stream.
                assert lib.calls[name][-7:-4] == (n_dir, 0, 0)
                assert lib.calls[name][-4:-1] == (geo.cluster if geo.resident else 0, geo.rows,
                                                  geo.smem_bytes)
                assert sizes[-1] == (geo, (t * geo.scratch_per_step,),
                                     (n_dir, geo.tiles, hidden, gates * hidden),
                                     (n_dir, geo.tiles, gates * hidden))


# -- the plain backwards against JAX ---------------------------------------------

def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _inputs(seed, t, b, h, gates):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, b, gates * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, gates * h)) * 0.3).astype(np.float32)
    bh = (rng.standard_normal(gates * h) * 0.1).astype(np.float32)
    g = rng.standard_normal((t, b, h)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    if b > 1:
        lengths[-1] = 1
    mask = np.arange(t)[:, None] < lengths[None, :]
    return xp, wh, bh, mask, g


def _jax_vjp(kind, route, xp, wh, bh, mask, g, reverse, dtype):
    jdt = jnp.dtype(dtype)
    jx, jw, jb, jg = (jnp.asarray(a).astype(jdt) for a in (xp, wh, bh, g))
    hidden = wh.shape[0]
    if route == "pallas":
        seq = pallas_gru.gru_sequence if kind == "gru" else pallas_gru.lstm_sequence
        fn = lambda x, w, b: seq(x, w, b, jnp.asarray(mask, jdt), reverse=reverse)  # noqa: E731
    else:
        scan = jax_gru._gru_scan if kind == "gru" else jax_gru._lstm_scan
        fn = lambda x, w, b: scan(x, w, b, jnp.asarray(mask), hidden,  # noqa: E731
                                  time_major=True, reverse=reverse)
    _, vjp = jax.vjp(fn, jx, jw, jb)
    return [np.asarray(r.astype(jnp.float32)) for r in vjp(jg)]


def _port_backward(kind, xp, wh, bh, mask, g, reverse, dtype):
    tdt = getattr(torch, dtype)
    tx, tw, tb, tg = (torch.from_numpy(a).to(tdt) for a in (xp, wh, bh, g))
    tm = torch.from_numpy(mask)
    if kind == "gru":
        ys = hopper_gru.gru_sequence_reference(tx, tw, tb, tm, reverse)
        return hopper_gru.gru_sequence_backward_reference(tx, tw, tb, tm, ys, tg, reverse)
    ys, cs = hopper_lstm.lstm_sequence_reference(tx, tw, tb, tm, reverse, return_cells=True)
    return hopper_lstm.lstm_sequence_backward_reference(tx, tw, tb, tm, ys, cs, tg, reverse)


# (kind, route, T, B, H, reverse, dtype): the Pallas kernel where T is a
# whole number of its chunks, the scan at T = 1 and 9; B = 1 and 13, H = 6,
# 20 and 136; both walks; bf16 on the Pallas route, whose semantics (f32
# gate math, the carry rounded every step) the port keeps.
EDGE_CASES = [
    ("gru", "pallas", 8, 1, 6, False, "float32"), ("gru", "pallas", 4, 13, 136, True, "float32"),
    ("gru", "pallas", 8, 13, 20, True, "bfloat16"), ("gru", "scan", 1, 13, 20, False, "float32"),
    ("gru", "scan", 9, 1, 136, True, "float32"),
    ("lstm", "pallas", 8, 1, 6, True, "float32"), ("lstm", "pallas", 4, 13, 136, False, "float32"),
    ("lstm", "pallas", 8, 13, 20, False, "bfloat16"), ("lstm", "scan", 1, 13, 20, True, "float32"),
    ("lstm", "scan", 9, 1, 136, False, "float32"),
]


@pytest.mark.parametrize("kind, route, t, b, h, reverse, dtype", EDGE_CASES)
def test_plain_backward_matches_jax_at_edge_shapes(kind, route, t, b, h, reverse, dtype):
    gates = 3 if kind == "gru" else 4
    xp, wh, bh, mask, g = _inputs(t + b + h, t, b, h, gates)
    ref = _jax_vjp(kind, route, xp, wh, bh, mask, g, reverse, dtype)
    got = _port_backward(kind, xp, wh, bh, mask, g, reverse, dtype)
    tol = 1e-5 if dtype == "float32" else 2.0**-6
    assert got[0].dtype == getattr(torch, dtype)
    assert got[1].dtype == got[2].dtype == torch.float32
    for name, a, r in zip(("dx_proj", "dW_h", "db_h"), got, ref):
        assert a.shape == r.shape, name
        assert _rel_err(a.float().numpy(), r) <= tol, name
