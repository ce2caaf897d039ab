"""The port's batch-major GRU recurrence against the JAX package's.

``hopper_gru.gru_sequence_batch_major`` on the CPU (its plain version) is held
against ``pallas_kernels.gru_sequence_pallas`` in interpret mode, as
tests/test_ops.py runs it: at JAX's own test shape (B 5, T 11, H 16, batch
tile 4, ragged lengths 11, 8, 3, 1, 11) and at a second one (B 21, T 9, H 12,
the default tile 16, so B is not a multiple of it), within 1e-6 (both sides
compute the same f32 step; only the summation order of the (H, 3H) product
differs). Inputs are made with numpy from a seed. The wrapper takes what
JAX takes: any batch tile >= 1 (33, and one above B) and bfloat16 or float64
inputs, which both sides cast to float32; these are held to JAX the same
way. Its checks run before any kernel: a CUDA-shaped call on meta tensors
reaches the launch and raises for want of CUDA, and what neither side takes
(tile 0, where JAX would divide by zero, shapes, H above the kernel's) is
refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops.pallas_kernels import gru_sequence_pallas
from artspeech_tpu_torch.ops import _build, hopper_gru

TOL = 1e-6
CASES = {"jax_test_shape": (5, 11, 16, 4, [11, 8, 3, 1, 11]),
         "partial_default_tile": (21, 9, 12, 16, None)}
#: Inputs the wrapper refused before and JAX takes: (B, T, H, tile, input dtype).
WIDENED = {"tile_33": (5, 11, 16, 33, np.float32), "tile_above_batch": (21, 9, 12, 64, np.float32),
           "bfloat16_input": (5, 11, 16, 4, "bfloat16"), "float64_input": (7, 6, 8, 16, np.float64)}


def _inputs(b, t, h, lengths, seed):
    rng = np.random.default_rng(seed)
    xp = rng.standard_normal((b, t, 3 * h)).astype(np.float32)
    wh = (rng.standard_normal((h, 3 * h)) * 0.3).astype(np.float32)
    bh = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    if lengths is None:
        lengths = rng.integers(1, t + 1, b)
        lengths[0], lengths[-1] = t, 1
    mask = np.arange(t)[None, :] < np.asarray(lengths)[:, None]
    return xp, wh, bh, mask


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_version_matches_jax_kernel(case):
    b, t, h, tile, lengths = CASES[case]
    xp, wh, bh, mask = _inputs(b, t, h, lengths, seed=b + t)
    ref = gru_sequence_pallas(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bh),
                              jnp.asarray(mask), batch_tile=tile)
    got = hopper_gru.gru_sequence_batch_major(*(torch.from_numpy(a) for a in (xp, wh, bh, mask)),
                                              batch_tile=tile)
    assert got.shape == (b, t, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


@pytest.mark.parametrize("case", sorted(WIDENED))
def test_inputs_jax_takes_match_jax_kernel(case):
    b, t, h, tile, dtype = WIDENED[case]
    xp, wh, bh, mask = _inputs(b, t, h, None, seed=b * t + tile)
    if dtype == "bfloat16":
        # bf16 values on both sides, exactly the same ones.
        xp_j, wh_j, bh_j = (jnp.asarray(a).astype(jnp.bfloat16) for a in (xp, wh, bh))
        xp_t, wh_t, bh_t = (torch.from_numpy(np.array(a.astype(jnp.float32))).bfloat16()
                            for a in (xp_j, wh_j, bh_j))
    else:
        xp_j, wh_j, bh_j = (a.astype(dtype) for a in (xp, wh, bh))
        xp_t, wh_t, bh_t = (torch.from_numpy(a) for a in (xp_j, wh_j, bh_j))
    ref = gru_sequence_pallas(xp_j, wh_j, bh_j, jnp.asarray(mask), batch_tile=tile)
    got = hopper_gru.gru_sequence_batch_major(xp_t, wh_t, bh_t, torch.from_numpy(mask),
                                              batch_tile=tile)
    assert got.shape == (b, t, h) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_padded_steps_repeat_the_last_valid_state():
    xp, wh, bh, mask = (torch.from_numpy(a) for a in _inputs(3, 6, 8, [6, 2, 1], seed=0))
    out = hopper_gru.gru_sequence_batch_major(xp, wh, bh, mask)
    assert torch.equal(out[1, 2:], out[1, 1:2].expand(4, -1))
    assert torch.equal(out[2, 1:], out[2, :1].expand(5, -1))
    assert hopper_gru.launches_seq == 0  # the plain version counts no launch


def test_wrapper_checks_before_the_kernel():
    before = hopper_gru.launches_seq
    meta = [torch.from_numpy(a).to("meta")
            for a in _inputs(2, 3, hopper_gru.MAX_HIDDEN, [3, 1], seed=1)]
    with pytest.raises(ValueError, match="CUDA"):
        hopper_gru.gru_sequence_batch_major(*meta)
    xp, wh, bh, mask = (torch.from_numpy(a) for a in _inputs(2, 3, 4, [3, 1], seed=2))
    cases = [
        (ValueError, "1 <= H", [torch.zeros(2, 3, 3 * 1025), torch.zeros(1025, 3 * 1025),
                                torch.zeros(3 * 1025), mask], {}),
        (ValueError, "batch_tile", [xp, wh, bh, mask], {"batch_tile": 0}),
        (ValueError, "shapes", [xp, wh[:, :6], bh, mask], {}),
        (ValueError, "shapes", [xp, wh, bh, mask[:, :2]], {}),
        (ValueError, r"\(B, T, 3H\)", [xp[..., :5], wh, bh, mask], {}),
    ]
    for error, match, args, kwargs in cases:
        with pytest.raises(error, match=match):
            hopper_gru.gru_sequence_batch_major(*args, **kwargs)
    assert hopper_gru.launches_seq == before
    assert "gru_seq" not in _build._libraries
