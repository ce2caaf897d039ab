"""Widths the port's kernels refused before and take now, against the JAX
package's paths at those widths, on the CPU.

At these widths the JAX package leaves its Pallas kernels for its scan or XLA
paths (GRU ops/gru.py:88-100, LSTM :342-350, training attention
models/transformer.py:461, decode :1024). The port's plain versions, which a
CPU tensor takes, are held against those paths at one new width a family,
with inputs made by numpy from a seed:
- the GRU at H = 130 (H % 4 != 0, 3H > 1024 threads) against ``_gru_scan``
  within 1e-5, both directions (the recurrences differ only in the summation
  order of the (H, 3H) product, as in tests/test_torch_port_gru.py);
- the LSTM at H = 168 (its W_h above a CTA's shared memory in f32) against
  ``_lstm_scan`` within 1e-5;
- the training attention at hd = 48, L = 512 against the XLA fallback of
  JAX's ``FusedChannelInteractions`` (materialised causal scores), forward
  within 2e-5 and its vjp within 5e-5, as tests/test_torch_port_train_attention.py
  holds the kernel's path;
- the decode attend at hd = 80 against the JAX decode's XLA attend within
  1e-5 relative + 2e-5 absolute, as tests/test_torch_port_attention.py does.
On meta tensors, every wrapper's checks pass at its new outer width (the
call goes on to the launch and raises for want of CUDA) and refuse the next
width, before any kernel is built.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops import gru as jax_gru
from artspeech_tpu_torch.ops import (
    _build,
    hopper_attention,
    hopper_gru,
    hopper_lstm,
    hopper_train_attention,
)


def _recurrence_inputs(gates, h, seed, t=9, b=5):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, b, gates * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, gates * h)) * 0.1).astype(np.float32)
    bh = (rng.standard_normal(gates * h) * 0.1).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    return xp, wh, bh, np.arange(t)[:, None] < lengths[None, :]


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_plain_version_matches_jax_scan_at_h130(reverse):
    xp, wh, bh, mask = _recurrence_inputs(3, 130, seed=0)
    ref = jax_gru._gru_scan(*(jnp.asarray(a) for a in (xp, wh, bh, mask)), 130,
                            time_major=True, reverse=reverse)
    got = hopper_gru.gru_sequence(*(torch.from_numpy(a) for a in (xp, wh, bh, mask)), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_plain_version_matches_jax_scan_at_h168(reverse):
    xp, wh, bh, mask = _recurrence_inputs(4, 168, seed=1)
    ref = jax_gru._lstm_scan(*(jnp.asarray(a) for a in (xp, wh, bh, mask)), 168,
                             time_major=True, reverse=reverse)
    got = hopper_lstm.lstm_sequence(*(torch.from_numpy(a) for a in (xp, wh, bh, mask)), reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def _xla_causal_attend(q, k, v, keep, n_pairs):
    """JAX FusedChannelInteractions' XLA fallback on merged groups
    (models/transformer.py:470-485): scores, the causal mask with
    finfo.min, a max-subtracted softmax, the pair's keep mask, @ v."""
    g, l, _ = q.shape
    s = jnp.einsum("gld,gmd->glm", q, k)
    s = jnp.where(jnp.tril(jnp.ones((l, l), bool)), s, jnp.finfo(s.dtype).min)
    ex = jnp.exp(s - jax.lax.stop_gradient(jnp.max(s, axis=-1, keepdims=True)))
    probs = ex / jnp.sum(ex, axis=-1, keepdims=True)
    probs = (probs.reshape(n_pairs, g // n_pairs, l, l) * keep[:, None]).reshape(g, l, l)
    return jnp.einsum("glm,gmd->gld", probs, v)


def test_training_attention_plain_versions_match_jax_xla_path_at_hd48_l512():
    rng = np.random.default_rng(2)
    g, l, hd, n_pairs = 4, 512, 48, 2
    q, k = (rng.normal(size=(g, l, hd)).astype(np.float32) * 0.4 for _ in range(2))
    v, do = (rng.normal(size=(g, l, hd)).astype(np.float32) for _ in range(2))
    keep = (rng.uniform(size=(n_pairs, l, l)) > 0.2).astype(np.float32) / np.float32(0.8)
    out, vjp = jax.vjp(lambda *a: _xla_causal_attend(*a, jnp.asarray(keep), n_pairs), q, k, v)
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = hopper_train_attention.fused_causal_attend(tq, tk, tv, torch.from_numpy(keep), n_pairs)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(out), rtol=0, atol=2e-5)
    grads = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    for got_g, ref_g in zip(grads, vjp(jnp.asarray(do))):
        np.testing.assert_allclose(got_g.numpy(), np.asarray(ref_g), rtol=0, atol=5e-5)


def test_decode_plain_attend_matches_jax_xla_attend_at_hd80():
    rng = np.random.default_rng(3)
    s, hd, g = 12, 80, 40
    k, v = (rng.standard_normal((s, hd, g)).astype(np.float32) for _ in range(2))
    q = (rng.standard_normal((hd, g)) * hd**-0.5).astype(np.float32)
    for t in (0, 5, s - 1):
        bias = jnp.where(jnp.arange(s) <= t, 0.0, jnp.finfo(jnp.float32).min)
        attn = jax.nn.softmax(jnp.sum(jnp.asarray(k) * q[None], axis=1) + bias[:, None], axis=0)
        ref = np.asarray(jnp.sum(jnp.asarray(v) * attn[:, None, :], axis=0))
        got = hopper_attention.flash_decode_attend(*(torch.from_numpy(a) for a in (k, v, q)),
                                                   t + 1)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=2e-5)


def _meta(*shape):
    return torch.zeros(shape, device="meta")


def _recurrence_call(kernel, h, t=2, b=1):
    gates = 3 if kernel.startswith("gru") else 4
    xp, wh, bh = _meta(t, b, gates * h), _meta(1, h, gates * h), _meta(1, gates * h)
    mask = torch.ones(t, b, dtype=torch.bool, device="meta")
    ys = _meta(t, b, h)
    return {"gru_fwd": lambda: hopper_gru.gru_forward(xp, wh, bh, mask, 0),
            "gru_bwd": lambda: hopper_gru.gru_backward(xp, wh, bh, mask, ys, ys, 0),
            "lstm_fwd": lambda: hopper_lstm.lstm_forward(xp, wh, bh, mask, 0),
            "lstm_bwd": lambda: hopper_lstm.lstm_backward(xp, wh, bh, mask, ys, ys, ys, 0)}[kernel]


@pytest.mark.parametrize("kernel", ["gru_fwd", "gru_bwd", "lstm_fwd", "lstm_bwd"])
def test_recurrent_wrappers_take_every_width_to_1024_and_refuse_beyond(kernel):
    mod = hopper_gru if kernel.startswith("gru") else hopper_lstm
    for h in (1, 6, 130, 168, 512, mod.MAX_HIDDEN):
        with pytest.raises(ValueError, match="needs CUDA"):
            _recurrence_call(kernel, h)()
    with pytest.raises(ValueError, match=f"H <= {mod.MAX_HIDDEN}, got H={mod.MAX_HIDDEN + 1}"):
        _recurrence_call(kernel, mod.MAX_HIDDEN + 1)()
    assert mod.launches == 0 and mod.bwd_launches == 0
    assert kernel not in _build._libraries


def test_attention_wrappers_take_their_new_widths_and_refuse_beyond():
    max_l, max_hd = hopper_train_attention.MAX_L, hopper_train_attention.MAX_HEAD_DIM
    for l, hd in ((max_l, 32), (max_l, 48), (37, max_hd), (max_l, max_hd)):
        with pytest.raises(ValueError, match="CUDA"):
            hopper_train_attention.fused_causal_attend(_meta(2, l, hd), _meta(2, l, hd),
                                                       _meta(2, l, hd), _meta(1, l, l), 1)
    with pytest.raises(ValueError, match=f"head dim {max_hd + 1}"):
        hopper_train_attention.fused_causal_attend(*(_meta(2, 8, max_hd + 1),) * 3,
                                                   _meta(1, 8, 8), 1)
    for hd in (80, 128, hopper_attention.MAX_HEAD_DIM):
        with pytest.raises(ValueError, match="CUDA"):
            hopper_attention.flash_decode_attend(_meta(4, hd, 40), _meta(4, hd, 40),
                                                 _meta(hd, 40), 4)
    hd = hopper_attention.MAX_HEAD_DIM + 1
    with pytest.raises(ValueError, match=f"head dim {hd} above"):
        hopper_attention.flash_decode_attend(_meta(4, hd, 40), _meta(4, hd, 40), _meta(hd, 40), 4)
    assert hopper_train_attention.launches_fwd == 0 and hopper_attention.launches == 0
    assert not {"train_attention", "flash_decode"} & set(_build._libraries)
