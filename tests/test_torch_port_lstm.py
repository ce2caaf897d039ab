"""The port's masked LSTM against the JAX package's.

The plain versions ``lstm_sequence_reference`` and its backward are held
against the JAX Pallas kernel ``pallas_gru.lstm_sequence`` (interpret mode on
the CPU, as in tests/test_pallas_gru.py) and against ``_lstm_scan``, both
directions, ragged masks: the forward within 1e-5 in float32 (the recurrences
differ only in the summation order of the (H, 4H) products), ``jax.grad``
gradients within 1e-4 * max(|ref|, 1); bf16 outputs within one bf16 step of
2^-7 at |h| < 1 against the Pallas kernel's bf16 semantics (f32 gate math, h
and c rounded to bf16 every step). The explicit backward is held to torch
autograd through the plain forward in float64 (1e-10), and the port's
``BiLSTM`` to the JAX module on one param tree at B=4 and B=24, which cover
the JAX package's direction-fused (B <= 16) and time-major paths. Inputs are
made with numpy from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import gru as jax_gru
from artspeech_tpu.ops import pallas_gru
from artspeech_tpu_torch.ops import hopper_lstm
from artspeech_tpu_torch.ops.gru import BiLSTM

T, B, H = 12, 6, 16
TOL = 1e-5
GRAD_TOL = 1e-4


def _inputs(seed=0, t=T, b=B, h=H):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, b, 4 * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, 4 * h)) * 0.2).astype(np.float32)
    bh = (rng.standard_normal(4 * h) * 0.1).astype(np.float32)
    lengths = rng.integers(2, t + 1, b)
    lengths[0], lengths[-1] = t, 1  # a full row and a row of length 1
    mask = np.arange(t)[:, None] < lengths[None, :]  # (T, B) time-major, ragged
    return xp, wh, bh, mask


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_jax_kernel_and_scan_f32(reverse):
    xp, wh, bh, mask = _inputs()
    kernel = pallas_gru.lstm_sequence(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bh),
                                      jnp.asarray(mask, jnp.float32), reverse=reverse)
    scan = jax_gru._lstm_scan(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bh),
                              jnp.asarray(mask), H, time_major=True, reverse=reverse)
    got = hopper_lstm.lstm_sequence(torch.from_numpy(xp), torch.from_numpy(wh),
                                    torch.from_numpy(bh), torch.from_numpy(mask), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(scan), rtol=0, atol=TOL)


@pytest.mark.parametrize("reverse", [False, True])
def test_reference_gradients_match_jax_kernel_and_scan(reverse):
    xp, wh, bh, mask = _inputs(seed=1)
    weights = np.random.default_rng(2).standard_normal((T, B, H)).astype(np.float32)
    mask_j, mask_f = jnp.asarray(mask), jnp.asarray(mask, jnp.float32)

    def loss_scan(xp, wh, bh):
        ys = jax_gru._lstm_scan(xp, wh, bh, mask_j, H, time_major=True, reverse=reverse)
        return jnp.sum(jnp.sin(ys) * weights)

    def loss_kernel(xp, wh, bh):
        ys = pallas_gru.lstm_sequence(xp, wh, bh, mask_f, reverse=reverse)
        return jnp.sum(jnp.sin(ys) * weights)

    args = tuple(jnp.asarray(a) for a in (xp, wh, bh))
    refs = {"scan": jax.grad(loss_scan, argnums=(0, 1, 2))(*args),
            "kernel": jax.grad(loss_kernel, argnums=(0, 1, 2))(*args)}
    params = [torch.from_numpy(a).requires_grad_() for a in (xp, wh, bh)]
    ys = hopper_lstm.lstm_sequence(*params, torch.from_numpy(mask), reverse)
    torch.sum(torch.sin(ys) * torch.from_numpy(weights)).backward()
    for name, ref in refs.items():
        for p, r in zip(params, ref):
            assert _rel_err(p.grad.numpy(), np.asarray(r)) <= GRAD_TOL, name


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
@pytest.mark.parametrize("reverse", [False, True])
def test_reference_matches_jax_kernel_bf16(reverse, dtype):
    # 16-bit storage, held as the GRU's (test_torch_port_gru.py).
    xp, wh, bh, mask = _inputs(seed=3)
    as_half = lambda a: jnp.asarray(a).astype(getattr(jnp, dtype))  # noqa: E731
    kernel = pallas_gru.lstm_sequence(as_half(xp), as_half(wh), as_half(bh),
                                      as_half(mask.astype(np.float32)), reverse=reverse)
    to_t = lambda a: torch.from_numpy(a).to(getattr(torch, dtype))  # noqa: E731
    got = hopper_lstm.lstm_sequence(to_t(xp), to_t(wh), to_t(bh), torch.from_numpy(mask),
                                    reverse)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(kernel.astype(jnp.float32)),
                               rtol=0, atol=2.0**-7)


def test_padded_steps_repeat_last_valid_state():
    xp, wh, bh, mask = _inputs(seed=4)
    ys, cs = hopper_lstm.lstm_sequence_reference(
        torch.from_numpy(xp), torch.from_numpy(wh), torch.from_numpy(bh),
        torch.from_numpy(mask), return_cells=True)
    lengths = mask.sum(axis=0)
    for out in (ys.numpy(), cs.numpy()):
        for b in range(B):
            L = lengths[b]
            np.testing.assert_array_equal(out[L:, b], np.broadcast_to(out[L - 1, b],
                                                                       out[L:, b].shape))


def test_bilstm_sequence_is_both_directions():
    xp_f, wh_f, bh_f, mask = _inputs(seed=5)
    xp_b, wh_b, bh_b, _ = _inputs(seed=6)
    t = torch.from_numpy
    both = hopper_lstm.bilstm_sequence(t(np.concatenate([xp_f, xp_b], -1)),
                                       t(np.stack([wh_f, wh_b])), t(np.stack([bh_f, bh_b])),
                                       t(mask))
    fwd = hopper_lstm.lstm_sequence(t(xp_f), t(wh_f), t(bh_f), t(mask))
    bwd = hopper_lstm.lstm_sequence(t(xp_b), t(wh_b), t(bh_b), t(mask), reverse=True)
    torch.testing.assert_close(both, torch.cat([fwd, bwd], -1), rtol=0, atol=0)


@pytest.mark.parametrize("rev_bits", [0b10, 0b01])
def test_explicit_backward_matches_autograd_f64(rev_bits):
    """lstm_backward_reference (what the backward kernel computes) against
    torch autograd through the plain forward, both in float64."""
    rng = np.random.default_rng(7)
    xp = torch.from_numpy(rng.standard_normal((T, B, 8 * H)) * 0.5)
    wh = torch.from_numpy(rng.standard_normal((2, H, 4 * H)) * 0.3)
    bh = torch.from_numpy(rng.standard_normal((2, 4 * H)) * 0.1)
    mask = torch.from_numpy(_inputs(seed=8)[3])
    g = torch.from_numpy(rng.standard_normal((T, B, 2 * H)))
    ys, cs = hopper_lstm.lstm_forward_reference(xp, wh, bh, mask, rev_bits, with_cells=True)
    got = hopper_lstm.lstm_backward_reference(xp, wh, bh, mask, ys, cs, g, rev_bits)
    params = [v.clone().requires_grad_() for v in (xp, wh, bh)]
    auto = torch.autograd.grad(hopper_lstm.lstm_forward_reference(*params, mask, rev_bits)[0],
                               params, g)
    for a, r in zip(got, auto):
        assert a.dtype == torch.float64
        assert _rel_err(a.numpy(), r.numpy()) <= 1e-10


def test_forward_keeps_cells_only_for_a_gradient():
    xp, wh, bh, mask = (torch.from_numpy(a) for a in _inputs(seed=9))
    saved = {}
    real_forward = hopper_lstm.lstm_forward

    def spy(*args):
        saved["with_cells"] = args[-1]
        return real_forward(*args)

    hopper_lstm.lstm_forward = spy
    try:
        with torch.no_grad():
            hopper_lstm.lstm_sequence(xp, wh.requires_grad_(), bh, mask)
        assert saved["with_cells"] is False
        hopper_lstm.lstm_sequence(xp, wh, bh, mask)
        assert saved["with_cells"] is True
    finally:
        hopper_lstm.lstm_forward = real_forward


def _bilstm_pair(b, seed=10, e=12):
    jax_model = jax_gru.BiLSTM(hidden_size=H, num_layers=2)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, T, e)).astype(np.float32)
    lengths = rng.integers(1, T + 1, b)
    lengths[0] = T
    mask = np.arange(T)[None, :] < lengths[:, None]
    params = jax_model.init(jax.random.PRNGKey(seed), jnp.asarray(x), jnp.asarray(mask))
    port = BiLSTM(e, H, num_layers=2)
    port.load_state_dict({f"layers.{i}.{name}": torch.from_numpy(np.asarray(
        params["params"][f"LSTMLayer_{i}"][name])) for i in range(4)
        for name in ("wi", "bi", "wh", "bh")})
    return jax_model, params, port, x, mask


@pytest.mark.parametrize("b", [4, 24])
def test_bilstm_matches_jax(b):
    jax_model, params, port, x, mask = _bilstm_pair(b)
    ref = jax_model.apply(params, jnp.asarray(x), jnp.asarray(mask))
    got = port(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_bilstm_gradients_match_jax():
    jax_model, params, port, x, mask = _bilstm_pair(4, seed=11)
    weights = np.random.default_rng(12).standard_normal((4, T, 2 * H)).astype(np.float32)

    def loss(p, x):
        return jnp.sum(jnp.sin(jax_model.apply(p, x, jnp.asarray(mask))) * weights)

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    torch.sum(torch.sin(port(xt, torch.from_numpy(mask))) * torch.from_numpy(weights)).backward()
    assert _rel_err(xt.grad.numpy(), np.asarray(g_x)) <= GRAD_TOL
    for i in range(4):
        for name in ("wi", "bi", "wh", "bh"):
            ref = np.asarray(g_params["params"][f"LSTMLayer_{i}"][name])
            got = getattr(port.layers[i], name).grad.numpy()
            assert _rel_err(got, ref) <= GRAD_TOL, (i, name)


def test_wrappers_take_the_plain_versions_on_cpu_and_raise_elsewhere():
    xp, wh, bh, mask = (torch.from_numpy(a) for a in _inputs(seed=13))
    before = (hopper_lstm.launches, hopper_lstm.bwd_launches)
    ys = hopper_lstm.lstm_sequence(xp, wh.requires_grad_(), bh, mask)
    ys.sum().backward()
    assert (hopper_lstm.launches, hopper_lstm.bwd_launches) == before
    meta = [v.detach().to("meta") for v in (xp, wh[None], bh[None], mask)]
    with pytest.raises(ValueError, match="CUDA"):
        hopper_lstm.lstm_forward(*meta, 0)
    g = torch.zeros(T, B, H, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_lstm.lstm_backward(*meta[:4], g, g, g, 0)
