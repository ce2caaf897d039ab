"""The port's flash decode-attend against the JAX package's, on the CPU.

- The plain version ``flash_decode_attend_reference`` (what the wrapper runs
  for a CPU tensor), reading exactly ``t + 1`` rows, against JAX's Pallas
  ``flash_decode_attend`` in interpret mode, which reads a ``p_end``-row
  prefix and masks the rows past ``t``: the shapes of
  tests/test_pallas_attention.py, float32, bfloat16 and float16 caches, to 1e-5
  relative and 2e-5 absolute (float32 sums in another order).
- The same against the XLA attend of the JAX decode (transformer.py:1043-1047)
  at a lane count the Pallas kernel refuses (G = 360, the thesis batch's self
  caches at B = 9), to 1e-5.
- The wrapper's refusals, on CPU and meta tensors: cache dtypes, mixed K/V
  dtypes, a non-float32 query, shapes, non-contiguous tensors, head dims above
  the kernel's, ``n_rows`` out of range; a meta tensor that passes them raises
  for want of CUDA. No call counts a launch or builds anything.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.ops.pallas_attention import S_CHUNK, flash_decode_attend, supported
from artspeech_tpu_torch.ops import _build, hopper_attention

S, HD, G = 64, 16, 256
TORCH_DTYPES = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16,
                jnp.float16: torch.float16}


def _inputs(dtype, g=G, seed=0):
    """Caches (S, hd, G) in ``dtype`` and an f32 query (hd, G), from numpy."""
    rng = np.random.default_rng(seed)
    k = jnp.asarray(rng.standard_normal((S, HD, g)).astype(np.float32)).astype(dtype)
    v = jnp.asarray(rng.standard_normal((S, HD, g)).astype(np.float32)).astype(dtype)
    q = jnp.asarray(rng.standard_normal((HD, g)).astype(np.float32))
    return k, v, q


def _to_torch(x, dtype):
    """A JAX array as a torch tensor of ``dtype``, bit for bit (bf16 and f16
    via f32, which holds every value of either exactly)."""
    return torch.from_numpy(np.array(x.astype(jnp.float32))).to(dtype)


def _port(k, v, q, n_rows, dtype):
    return hopper_attention.flash_decode_attend(
        _to_torch(k, TORCH_DTYPES[dtype]), _to_torch(v, TORCH_DTYPES[dtype]),
        _to_torch(q, torch.float32), n_rows).numpy()


@pytest.mark.parametrize("cache_dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
@pytest.mark.parametrize("p_end", [S_CHUNK, S])
@pytest.mark.parametrize("t_of", ["first", "fifth", "last"])
def test_plain_attend_matches_the_pallas_kernel(cache_dtype, p_end, t_of):
    t = {"first": 0, "fifth": 5, "last": p_end - 1}[t_of]
    k, v, q = _inputs(cache_dtype)
    assert supported(p_end, HD, G)
    ref = np.asarray(flash_decode_attend(k, v, q, t, p_end))
    got = _port(k, v, q, t + 1, cache_dtype)
    assert got.shape == (HD, G) and got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=2e-5)


def _xla_attend(k, v, q, t):
    """The JAX decode's XLA attend (transformer.py:1043-1047) over the whole
    cache, rows past ``t`` masked with finfo.min."""
    t_bias = jnp.where(jnp.arange(k.shape[0]) <= t, 0.0, jnp.finfo(jnp.float32).min)
    logits = jnp.sum(k.astype(jnp.float32) * q[None], axis=1) + t_bias[:, None]
    attn = jax.nn.softmax(logits, axis=0)
    return jnp.sum(v.astype(jnp.float32) * attn[:, None, :], axis=0)


@pytest.mark.parametrize("cache_dtype", [jnp.float32, jnp.bfloat16, jnp.float16])
def test_plain_attend_matches_the_xla_attend_where_pallas_refuses(cache_dtype):
    g = 360
    assert not supported(S, HD, g)
    k, v, q = _inputs(cache_dtype, g=g, seed=1)
    for t in (0, 17, S - 1):
        ref = np.asarray(_xla_attend(k, v, q, t))
        np.testing.assert_allclose(_port(k, v, q, t + 1, cache_dtype), ref, rtol=1e-5, atol=1e-5)


def _tensors(device, dtype=torch.float32, s=4, hd=HD, g=40):
    k = torch.zeros((s, hd, g), dtype=dtype, device=device)
    return k, torch.zeros_like(k), torch.zeros((hd, g), device=device)


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_wrapper_refuses_what_the_kernel_does_not_take(device):
    before = hopper_attention.launches
    k, v, q = _tensors(device)
    cases = [
        (TypeError, (k.half(), v.bfloat16(), q, 1)),
        (TypeError, (k.double(), v.double(), q, 1)),
        (TypeError, (k, v.bfloat16(), q, 1)),
        (TypeError, (k, v, q.bfloat16(), 1)),
        (ValueError, (k, v[:3], q, 1)),
        (ValueError, (k, v, q[:, :39], 1)),
        (ValueError, (k.transpose(1, 2).contiguous().transpose(1, 2), v, q, 1)),
        (ValueError, (k, v, torch.zeros((40, HD), device=device).T, 1)),
        (ValueError, (*_tensors(device, hd=hopper_attention.MAX_HEAD_DIM + 8), 1)),
        (ValueError, (k, v, q, 0)),
        (ValueError, (k, v, q, 5)),
    ]
    for error, args in cases:
        with pytest.raises(error):
            hopper_attention.flash_decode_attend(*args)
    if device == "meta":
        for dtype in (torch.float32, torch.bfloat16, torch.float16):
            k, v, q = _tensors(device, dtype=dtype, hd=hopper_attention.MAX_HEAD_DIM)
            with pytest.raises(ValueError, match="CUDA"):
                hopper_attention.flash_decode_attend(k, v, q, 4)
    assert hopper_attention.launches == before
    assert "flash_decode" not in _build._libraries


def test_cpu_tensors_take_the_plain_version_at_every_row_count():
    rng = np.random.default_rng(2)
    k = torch.from_numpy(rng.standard_normal((9, HD, 40)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((9, HD, 40)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((HD, 40)).astype(np.float32))
    before = hopper_attention.launches
    for n_rows in range(1, 10):
        got = hopper_attention.flash_decode_attend(k, v, q, n_rows)
        torch.testing.assert_close(
            got, hopper_attention.flash_decode_attend_reference(k, v, q, n_rows), rtol=0, atol=0)
    # one row: the softmax is 1, the output that row's values
    torch.testing.assert_close(hopper_attention.flash_decode_attend(k, v, q, 1), v[0],
                               rtol=0, atol=0)
    assert hopper_attention.launches == before
