"""The launch rule of the port's recurrent forward kernels, on the CPU.

``hopper_gru.gru_launch_geometry`` chooses, from the shape, the gate count
and the card's SM count alone, how ``csrc/gru_fwd.cu`` and
``csrc/gru_seq.cu`` (3 gates) and ``csrc/lstm_fwd.cu`` (4) launch: the
cluster step of ``csrc/rnn_fwd_step.cuh`` (a cluster of C CTAs a direction
and tile of rows, W_h slices in shared memory) or the wide instance (4-row
blocks reading W_h through the L2). These tests hold the rule to what the
kernels need, over G in {3, 4}, B in {1, 3, 12, 16, 64, 256}, D in {1, 2},
H in {6, 16, 128, 130, 256, 1024}, f32 and bf16, at the H100's 132 SMs:
every batch row in exactly one tile, shared memory and threads within a
block's limits, the cluster size a portable one that splits H evenly; the
thesis shapes with every cluster resident at once and at least as many
CTAs on a step as one 4-row block a tile; and both GRU wrappers passing
their kernels the same geometry for the same (B, D = 1, H). The LSTM's
wrapper and widths: tests/test_torch_port_lstm_fwd_geometry.py. No card is
needed or asked for.
"""

import contextlib

import pytest
import torch

from artspeech_tpu_torch.ops import hopper_gru

SMS = 132
BATCHES = (1, 3, 12, 16, 64, 256)
HIDDEN = (6, 16, 128, 130, 256, 1024)
DTYPES = {"float32": 4, "bfloat16": 2}


@pytest.mark.parametrize("gates", (3, 4))
@pytest.mark.parametrize("hidden", HIDDEN)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_geometry_fits_the_kernels(hidden, dtype, gates):
    elem = DTYPES[dtype]
    for batch in BATCHES:
        for n_dir in (1, 2):
            geo = hopper_gru.gru_launch_geometry(batch, n_dir, hidden, gates, elem, SMS)
            c, rows = geo.cluster, geo.rows
            tiles = geo.grid[0] // c
            # Every batch row in exactly one tile of one cluster.
            assert geo.grid == (c * tiles, n_dir) and geo.ctas == c * tiles * n_dir
            assert tiles * rows >= batch > (tiles - 1) * rows
            assert geo.waves == -(-geo.ctas // SMS)
            assert geo.smem_bytes <= hopper_gru.MAX_SMEM
            assert geo.threads <= hopper_gru.MAX_THREADS <= 1024
            if geo.resident:
                assert c in (1, 2, 4, 8) and hidden % c == 0
                assert rows in hopper_gru.CLUSTER_ROWS and rows <= 4 * c
                assert geo.threads == hopper_gru.LANES * (hidden // c)
                # The W_h slice, padded to whole quads of k, and two h buffers.
                hp = -(-hidden // 32) * 32
                w_bytes = -(-hp * gates * (hidden // c) * elem // 16) * 16
                assert geo.smem_bytes == w_bytes + 2 * rows * hp * 4
            else:
                assert (c, rows, geo.threads) == (1, hopper_gru.WIDE_ROWS, hopper_gru.MAX_THREADS)
                # The carries (the GRU's h; the LSTM's h and c) and the G gates of a row.
                carries = {3: 1, 4: 2}[gates]
                assert geo.smem_bytes == hopper_gru.WIDE_ROWS * (carries + gates) * hidden * 4


@pytest.mark.parametrize("hidden, dtype, resident", [
    (6, "float32", True), (16, "float32", True), (128, "float32", True),
    (128, "bfloat16", True), (130, "float32", False), (256, "float32", True),
    (512, "float32", False), (512, "bfloat16", True), (1024, "bfloat16", False)])
def test_instance_of_each_width(hidden, dtype, resident):
    """The cluster step wherever a CTA's W_h slice fits and a CTA holds at
    most 64 units (130 = 2 * 65 does not); the wide instance elsewhere. The
    instance does not depend on the batch."""
    torch_dtype = getattr(torch, dtype)
    assert hopper_gru.resident("gru_fwd", hidden, torch_dtype) is resident
    assert {hopper_gru.gru_launch_geometry(b, d, hidden, 3, DTYPES[dtype]).resident
            for b in BATCHES for d in (1, 2)} == {resident}
    if dtype == "float32":
        assert hopper_gru.batch_major_resident(hidden) is resident


@pytest.mark.parametrize("gates", (3, 4))
@pytest.mark.parametrize("batch", (12, 16, 256))
def test_thesis_shapes_keep_every_cluster_resident(batch, gates):
    for n_dir in (1, 2):
        for elem in DTYPES.values():
            geo = hopper_gru.gru_launch_geometry(batch, n_dir, 128, gates, elem, SMS)
            assert geo.resident and geo.waves == 1 and geo.ctas <= SMS
            # Never fewer CTAs on a step than one 4-row block a tile.
            assert geo.ctas >= -(-batch // 4) * n_dir


@pytest.mark.parametrize("gates", (3, 4))
def test_thesis_geometry_as_measured(gates):
    """The geometry the rule gives the thesis shapes (f32, H = 128): clusters
    of 8 two rows deep at B = 12 and 16, clusters of 2 at B = 256; the same
    for 3 gates and 4 (a CTA of a 2-CTA cluster holds 96 or 128 KiB)."""
    expect = {(12, 2): (8, 2, 96), (16, 2): (8, 2, 128), (16, 1): (8, 2, 64),
              (256, 2): (2, 8, 128), (256, 1): (2, 4, 128)}
    for (batch, n_dir), (c, rows, ctas) in expect.items():
        geo = hopper_gru.gru_launch_geometry(batch, n_dir, 128, gates, 4, SMS)
        assert (geo.cluster, geo.rows, geo.ctas) == (c, rows, ctas)


@pytest.mark.parametrize("gates", (3, 4))
def test_rule_follows_the_card(gates):
    """The rule reads the SM count it is given: on half the SMs it takes
    deeper tiles or smaller clusters, and where no candidate fits the card at
    once (B = 256 on 66 SMs) the one with the fewest CTAs."""
    half = SMS // 2
    geo = hopper_gru.gru_launch_geometry(16, 2, 128, gates, 4, half)
    assert geo.ctas <= half and (geo.cluster, geo.rows) == (4, 2)
    geo = hopper_gru.gru_launch_geometry(256, 2, 128, gates, 4, half)
    assert (geo.cluster, geo.rows, geo.ctas, geo.waves) == (2, 8, 128, 2)


class _FakeLibrary:
    """Records the ints each forward entry point is called with."""

    def __init__(self):
        self.calls = {}

    def __getattr__(self, name):
        def entry(*args):
            self.calls[name] = args
            return 0
        return entry


def test_both_layouts_launch_the_same_geometry(monkeypatch):
    lib = _FakeLibrary()
    monkeypatch.setattr(hopper_gru, "_library", lambda name: lib)
    monkeypatch.setattr(hopper_gru, "_check", lambda *args: None)
    monkeypatch.setattr(hopper_gru, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: type("Stream", (), {"cuda_stream": 0})())
    # The fake launches count; the counters go back to their values after the test.
    monkeypatch.setattr(hopper_gru, "launches", hopper_gru.launches)
    monkeypatch.setattr(hopper_gru, "launches_seq", hopper_gru.launches_seq)
    for batch, hidden in ((1, 6), (12, 128), (16, 136), (256, 128), (5, 512)):
        t = 3
        xp = torch.zeros(t, batch, 3 * hidden)
        mask = torch.ones(t, batch, dtype=torch.bool)
        hopper_gru._launch(xp, torch.zeros(1, hidden, 3 * hidden), torch.zeros(1, 3 * hidden),
                           mask, 1, 0)
        hopper_gru._launch_seq(xp.transpose(0, 1).contiguous(), torch.zeros(hidden, 3 * hidden),
                               torch.zeros(3 * hidden), mask.T)
        geo = hopper_gru.gru_launch_geometry(batch, 1, hidden, 3, 4, SMS)
        expected = (geo.cluster if geo.resident else 0, geo.rows, geo.smem_bytes)
        # gru_fwd: ..., n_dir, rev_bits, dtype, cluster, rows, smem, stream.
        assert lib.calls["gru_fwd"][-4:-1] == expected
        # gru_seq: 5 pointers, batch, n_steps, hidden, cluster, rows, smem, stream.
        assert lib.calls["gru_seq"][5:] == (batch, t, hidden, *expected, 0)
