"""The port's masked GRU against the JAX package's.

The plain version ``gru_sequence_reference`` is held against the JAX Pallas
kernel ``pallas_gru.gru_sequence`` (interpret mode on the CPU, as in
tests/test_pallas_gru.py) and against ``_gru_scan``; the port's ``BiGRU`` and
``GRUStack`` against the JAX modules on one param tree, at B=4 and B=24, which
cover the JAX package's direction-fused (B <= 16) and time-major paths.
Inputs are made with numpy from a seed. Tolerance: 1e-5 in float32 (the
recurrences differ only in the summation order of the (H, 3H) products);
bf16 outputs within one bf16 step of 2^-7 at |h| < 1, against the TPU kernel's
bf16 semantics (f32 gate math, carry rounded to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import gru as jax_gru
from artspeech_tpu.ops import pallas_gru
from artspeech_tpu_torch.ops import hopper_gru
from artspeech_tpu_torch.ops.gru import BiGRU, GRUStack

T, B, H = 16, 64, 128
TOL = 1e-5


def _inputs(seed=0, t=T, b=B, h=H):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, b, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, 3 * h)) * 0.1).astype(np.float32)
    bh = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    lengths = rng.integers(3, t + 1, b)
    mask = np.arange(t)[:, None] < lengths[None, :]  # (T, B) time-major, ragged
    return xp, wh, bh, mask


@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_jax_kernel_and_scan_f32(reverse):
    xp, wh, bh, mask = _inputs()
    kernel = pallas_gru.gru_sequence(
        jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bh),
        jnp.asarray(mask, jnp.float32), reverse=reverse)
    scan = jax_gru._gru_scan(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bh),
                             jnp.asarray(mask), H, time_major=True, reverse=reverse)
    got = hopper_gru.gru_sequence(torch.from_numpy(xp), torch.from_numpy(wh),
                                  torch.from_numpy(bh), torch.from_numpy(mask), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=0, atol=TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_jax_kernel_bf16(reverse, dtype):
    # 16-bit storage (the name keeps bf16, the first such case): the carry
    # rounded every step on both sides, two steps of bf16's 2^-8 allowed
    # (fp16 rounds at 2^-11, inside it).
    xp, wh, bh, mask = _inputs(seed=1)
    as_half = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    kernel = pallas_gru.gru_sequence(as_half(xp), as_half(wh), as_half(bh),
                                     as_half(mask.astype(np.float32)), reverse=reverse)
    kernel = np.asarray(kernel.astype(jnp.float32))
    to_t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    got = hopper_gru.gru_sequence(to_t(xp), to_t(wh), to_t(bh), torch.from_numpy(mask), reverse)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), kernel, rtol=0, atol=2.0**-7)


def test_padded_steps_repeat_last_valid_state():
    xp, wh, bh, mask = _inputs(seed=2)
    ys = hopper_gru.gru_sequence(torch.from_numpy(xp), torch.from_numpy(wh),
                                 torch.from_numpy(bh), torch.from_numpy(mask)).numpy()
    lengths = mask.sum(axis=0)
    for b in range(B):
        L = lengths[b]
        np.testing.assert_array_equal(ys[L:, b], np.broadcast_to(ys[L - 1, b], ys[L:, b].shape))


def test_bigru_sequence_is_both_directions():
    xp_f, wh_f, bh_f, mask = _inputs(seed=3, b=8)
    xp_b, wh_b, bh_b, _ = _inputs(seed=4, b=8)
    t = torch.from_numpy
    both = hopper_gru.bigru_sequence(
        t(np.concatenate([xp_f, xp_b], axis=-1)), t(np.stack([wh_f, wh_b])),
        t(np.stack([bh_f, bh_b])), t(mask))
    fwd = hopper_gru.gru_sequence(t(xp_f), t(wh_f), t(bh_f), t(mask), False)
    bwd = hopper_gru.gru_sequence(t(xp_b), t(wh_b), t(bh_b), t(mask), True)
    np.testing.assert_array_equal(both.numpy(), torch.cat([fwd, bwd], -1).numpy())


def _state_dict(tree, prefix="layers"):
    return {f"{prefix}.{i}.{k}": torch.from_numpy(np.array(tree[f"GRULayer_{i}"][k]))
            for i in range(len(tree)) for k in ("wi", "bi", "wh", "bh")}


@pytest.mark.parametrize("batch", [4, 24])
def test_bigru_matches_jax(batch):
    rng = np.random.default_rng(batch)
    t, e, h = 12, 10, 16
    x = rng.standard_normal((batch, t, e)).astype(np.float32)
    lengths = rng.integers(1, t + 1, batch)
    mask = np.arange(t)[None, :] < lengths[:, None]
    module = jax_gru.BiGRU(hidden_size=h, num_layers=2)
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))

    port = BiGRU(e, h, num_layers=2)
    port.load_state_dict(_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    assert got.shape == (batch, t, 2 * h)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_grustack_matches_jax():
    rng = np.random.default_rng(7)
    batch, t, e, h = 6, 9, 5, 12
    x = rng.standard_normal((batch, t, e)).astype(np.float32)
    mask = np.arange(t)[None, :] < rng.integers(1, t + 1, batch)[:, None]
    module = jax_gru.GRUStack(hidden_size=h, num_layers=2)
    params = module.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(mask))["params"]
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))

    port = GRUStack(e, h, num_layers=2)
    port.load_state_dict(_state_dict(params))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(mask)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_torch_rnn_init_is_symmetric_and_seeded():
    a = BiGRU(8, 16, generator=torch.Generator().manual_seed(3))
    b = BiGRU(8, 16, generator=torch.Generator().manual_seed(3))
    wh = a.layers[0].wh.detach()
    bound = 1.0 / 16**0.5
    assert wh.abs().max() <= bound and wh.min() < 0 < wh.max()
    for pa, pb in zip(a.parameters(), b.parameters()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0)
