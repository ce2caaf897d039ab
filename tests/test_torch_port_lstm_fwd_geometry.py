"""The LSTM forward kernel's launch rule and its step's order of sums, on the CPU.

``csrc/lstm_fwd.cu`` runs the forward cluster step of
``csrc/rnn_fwd_step.cuh`` with a four-gate cell, launched with the geometry
``hopper_gru.gru_launch_geometry`` gives for 4 gates (the GRU forwards' rule).
These tests hold the rule at G = 4 to what the kernel needs, over B in {1,
3, 12, 16, 64, 256}, D in {1, 2}, H in {6, 16, 128, 136, 168, 256, 512,
1024}, f32 and bf16, at the H100's 132 SMs: every batch row in exactly one
tile, threads and shared memory within a block's limits, the W_h slice of 4
gates; the latent RNN's geometries; the instance each width takes;
``hopper_lstm.resident("lstm_fwd", ...)`` answered without a library or a
card; and the wrapper passing its kernel the rule's geometry (a fake
library).

Then the step's arithmetic in numpy float32: lane l of a unit's 8 sums k in
the quads l, l + 8, ... of h (zero past H), the 8 lanes meet in the
kernel's reduce-scatter in its fixed order with G = 4 and R = 2, 4 and 8,
and the lane left with a row applies the cell, keeping c. Every (row, unit)
of the batch is applied by exactly one lane a step, and the result is held
to ``lstm_sequence_reference`` within 1e-5 (ys; cs relative to max(|c|, 1))
at a ragged batch that leaves part of a tile empty. No card is needed.
"""

import contextlib

import numpy as np
import pytest
import torch

from artspeech_tpu_torch.ops import _build, hopper_gru, hopper_lstm

SMS = 132
GATES = 4
BATCHES = (1, 3, 12, 16, 64, 256)
HIDDEN = (6, 16, 128, 136, 168, 256, 512, 1024)
DTYPES = {"float32": 4, "bfloat16": 2}
LANES = 8


@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_geometry_fits_the_kernel(hidden, dtype):
    elem = DTYPES[dtype]
    for batch in BATCHES:
        for n_dir in (1, 2):
            geo = hopper_gru.gru_launch_geometry(batch, n_dir, hidden, GATES, elem, SMS)
            c, rows = geo.cluster, geo.rows
            tiles = geo.grid[0] // c
            # Every batch row in exactly one tile of one cluster.
            assert geo.grid == (c * tiles, n_dir) and geo.ctas == c * tiles * n_dir
            assert tiles * rows >= batch > (tiles - 1) * rows
            assert geo.waves == -(-geo.ctas // SMS)
            assert geo.smem_bytes <= hopper_gru.MAX_SMEM
            assert geo.threads <= hopper_gru.MAX_THREADS
            if geo.resident:
                assert c in (1, 2, 4, 8) and hidden % c == 0 and hidden // c <= 64
                assert rows in (2, 4, 8) and rows <= 4 * c
                assert geo.threads == LANES * (hidden // c)
                # The (HP, 4U) W_h slice, k padded to whole quads of the 8
                # lanes, and two (rows, HP) f32 h buffers.
                hp = -(-hidden // 32) * 32
                w_bytes = -(-hp * 4 * (hidden // c) * elem // 16) * 16
                assert geo.smem_bytes == w_bytes + 2 * rows * hp * 4
            else:
                assert (c, rows, geo.threads) == (1, 4, hopper_gru.MAX_THREADS)
                # h, c and the 4 gates of each of the block's 4 rows, f32.
                assert geo.smem_bytes == 4 * 6 * hidden * 4


@pytest.mark.parametrize("hidden, cluster", [
    (6, True), (16, True), (128, True), (136, True), (168, True), (256, True),
    (512, False), (1024, False)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_instance_of_each_width(hidden, cluster, dtype):
    """The cluster step to H = 256 (at 256 a CTA of 8 holds a 128 KiB slice in
    f32), the wide instance at 512 and 1,024 in both storage types, at every
    batch."""
    assert {hopper_gru.gru_launch_geometry(b, d, hidden, GATES, DTYPES[dtype], SMS).resident
            for b in BATCHES for d in (1, 2)} == {cluster}


def test_latent_rnn_geometry():
    """The geometry the rule gives the latent RNN's shapes (H = 128, both
    directions, f32): (rows, C, CTAs, threads, shared memory)."""
    expect = {12: (2, 8, 96, 128, 32768 + 2048), 16: (2, 8, 128, 128, 32768 + 2048),
              64: (2, 2, 128, 512, 131072 + 2048)}
    for batch, want in expect.items():
        geo = hopper_gru.gru_launch_geometry(batch, 2, 128, GATES, 4, SMS)
        assert geo.resident and geo.waves == 1
        assert (geo.rows, geo.cluster, geo.ctas, geo.threads, geo.smem_bytes) == want


def test_resident_needs_no_library_or_card(monkeypatch):
    def refuse(*args):
        raise AssertionError("resident() asked for a library or a card")

    monkeypatch.setattr(_build, "load", refuse)
    monkeypatch.setattr(torch.cuda, "get_device_properties", refuse)
    for hidden in HIDDEN:
        for dtype, elem in ((torch.float32, 4), (torch.bfloat16, 2)):
            rule = hopper_gru.gru_launch_geometry(1, 1, hidden, GATES, elem).resident
            assert hopper_lstm.resident("lstm_fwd", hidden, dtype) is rule


class _FakeLibrary:
    """Records the arguments the forward entry point is called with."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def test_wrapper_launches_the_rule(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(hopper_lstm, "_library", lambda name: lib)
    monkeypatch.setattr(hopper_lstm, "_check", lambda *args: None)
    monkeypatch.setattr(hopper_gru, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counter goes back to its value after the test.
    monkeypatch.setattr(hopper_lstm, "launches", hopper_lstm.launches)
    t = 3
    for batch, hidden in ((1, 6), (12, 128), (16, 128), (64, 128), (13, 136), (5, 256), (5, 512)):
        for dtype in (torch.float32, torch.bfloat16):
            for n_dir, with_cells in ((1, False), (2, True)):
                xp = torch.zeros(t, batch, n_dir * 4 * hidden, dtype=dtype)
                wh = torch.zeros(n_dir, hidden, 4 * hidden, dtype=dtype)
                bh = torch.zeros(n_dir, 4 * hidden, dtype=dtype)
                mask = torch.ones(t, batch, dtype=torch.bool)
                before = hopper_lstm.launches
                ys, cs = hopper_lstm._launch(xp, wh, bh, mask, n_dir, n_dir - 1, with_cells)
                assert hopper_lstm.launches == before + 1
                assert ys.shape == (t, batch, n_dir * hidden) and (cs is not None) == with_cells
                geo = hopper_gru.gru_launch_geometry(batch, n_dir, hidden, GATES,
                                                     xp.element_size(), SMS)
                args = lib.calls["lstm_fwd"]
                # 6 pointers (cs null for inference), T, B, H, n_dir, rev_bits,
                # dtype, then cluster (0: wide), rows, smem, stream.
                assert (args[5] is None) != with_cells
                assert args[6:12] == (t, batch, hidden, n_dir, n_dir - 1,
                                      int(dtype == torch.bfloat16))
                assert args[12:15] == (geo.cluster if geo.resident else 0, geo.rows,
                                       geo.smem_bytes)


# -- the step's order of sums, emulated ------------------------------------------

def _lane_sums(h_tile, w, lane, hidden):
    """Lane ``lane``'s share of h @ W_h for every unit: it sums k in its quads
    {lane, lane + 8, ...} in order, four k a quad, in f32. (R, G*H)."""
    hp = -(-hidden // (4 * LANES)) * 4 * LANES
    acc = np.zeros((h_tile.shape[0], w.shape[1]), np.float32)
    for q in range(hp // (4 * LANES)):
        for i in range(4):
            k = 4 * (lane + LANES * q) + i
            if k < hidden:
                acc = (acc + h_tile[:, k, None] * w[k][None, :]).astype(np.float32)
    return acc


def _reduce_scatter(acc, rows):
    """The kernel's shuffle levels over the 8 lanes (off = 4, 2, 1) on
    acc (LANES, G, R, U): while a lane holds more than one row, the lane with
    bit ``off`` set keeps the upper half of its rows and its partner the
    lower, each adding what the other gives; then the one row is summed in
    both partners. Lane l ends with row l // (LANES / R) in acc[l, :, 0]."""
    acc = acc.copy()
    held, off = rows, LANES // 2
    while off > 0:
        new = acc.copy()
        for lane in range(LANES):
            partner = lane ^ off
            if held > 1:
                half = held // 2
                upper = bool(lane & off)
                for i in range(half):
                    keep = acc[lane, :, i + half] if upper else acc[lane, :, i]
                    give = acc[partner, :, i] if not upper else acc[partner, :, i + half]
                    new[lane, :, i] = keep + give
            else:
                new[lane, :, 0] = acc[lane, :, 0] + acc[partner, :, 0]
        acc = new.astype(np.float32)
        held = max(held // 2, 1)
        off //= 2
    return acc


def _sigmoid(v):
    return (np.float32(1) / (np.float32(1) + np.exp(-v))).astype(np.float32)


def _emulated_forward(xp, w, b, mask, rows):
    """The cluster step on one direction in numpy float32: (ys, cs, how many
    lanes applied each (t, b, unit))."""
    n_steps, batch, gates = xp.shape
    hidden = gates // 4
    tiles = -(-batch // rows)
    spread = LANES // rows
    h = np.zeros((tiles * rows, hidden), np.float32)  # rows past the batch stay zero
    c = np.zeros_like(h)
    ys = np.zeros((n_steps, batch, hidden), np.float32)
    cs = np.zeros_like(ys)
    applied = np.zeros((n_steps, batch, hidden), np.int64)
    bias = b.reshape(4, hidden)
    for t in range(n_steps):
        h_next, c_next = h.copy(), c.copy()
        for tile in range(tiles):
            h_tile = h[tile * rows:(tile + 1) * rows]
            acc = np.stack([_lane_sums(h_tile, w, lane, hidden) for lane in range(LANES)])
            acc = acc.reshape(LANES, rows, 4, hidden).transpose(0, 2, 1, 3)
            acc = _reduce_scatter(acc, rows)
            for lane in range(0, LANES, spread):
                row = tile * rows + lane // spread
                if row >= batch:
                    continue
                x = xp[t, row].reshape(4, hidden)
                pre = ((acc[lane, :, 0] + bias) + x).astype(np.float32)
                i, f, o = _sigmoid(pre[0]), _sigmoid(pre[1]), _sigmoid(pre[3])
                g = np.tanh(pre[2])
                c_new = (f * c[row] + i * g).astype(np.float32)
                if mask[t, row]:
                    h_next[row] = o * np.tanh(c_new)
                    c_next[row] = c_new
                applied[t, row] += 1
        h, c = h_next, c_next
        ys[t], cs[t] = h[:batch], c[:batch]
    return ys, cs, applied


@pytest.mark.parametrize("rows", (2, 4, 8))
@pytest.mark.parametrize("hidden", (20, 40))
def test_emulated_step_matches_the_plain_version(rows, hidden):
    """H = 20 (one quad a lane, lanes 5-7 past H) and 40 (two quads, the
    second partly padding); B = 5 leaves rows of the last tile empty."""
    rng = np.random.default_rng(rows * 100 + hidden)
    t, batch = 6, 5
    xp = (rng.standard_normal((t, batch, 4 * hidden)) * 0.5).astype(np.float32)
    w = (rng.standard_normal((hidden, 4 * hidden)) * 0.3).astype(np.float32)
    b = (rng.standard_normal(4 * hidden) * 0.1).astype(np.float32)
    lengths = np.array([t, 3, 1, 6, 2])
    mask = np.arange(t)[:, None] < lengths[None, :]
    ys, cs, applied = _emulated_forward(xp, w, b, mask, rows)
    assert (applied == 1).all()
    ref_ys, ref_cs = hopper_lstm.lstm_sequence_reference(
        torch.from_numpy(xp), torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(mask),
        return_cells=True)
    assert np.abs(ys - ref_ys.numpy()).max() <= 1e-5
    assert np.abs(cs - ref_cs.numpy()).max() / max(np.abs(ref_cs.numpy()).max(), 1.0) <= 1e-5
