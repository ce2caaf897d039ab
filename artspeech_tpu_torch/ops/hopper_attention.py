"""Flash decode-attention over merged-lane KV caches: the Hopper kernel's
wrapper and its plain version.

Counterpart of artspeech_tpu/ops/pallas_attention.py:flash_decode_attend (the
Pallas ``_flash_kernel``), which serves the transformer's KV-cached decode
(models/transformer.py:make_fast_generate). The kernel is
``csrc/flash_decode.cu``.

- A CPU tensor takes the plain version, :func:`flash_decode_attend_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

On every device the call raises for what the kernel does not take: caches
other than float32 or bfloat16, K and V of different dtypes, a query other
than float32, tensors that are not contiguous, a head dim above
``MAX_HEAD_DIM``, ``n_rows`` outside ``[1, S]``. The TPU wrapper's tile rules
(``supported``, ``S_CHUNK``, ``_G_BLOCKS``) and its dispatch threshold
(``HBM_STREAM_BYTES``) are not ported: the kernel takes any G and any
``n_rows``, and the decode calls it at every step.

Inference only, like the TPU kernel. ``launches`` counts kernel launches.
"""

import ctypes

import torch

from artspeech_tpu_torch.ops import _build

#: Kernel launches so far (the plain version does not count).
launches = 0

#: Largest head dim the kernels take (csrc/flash_decode.cu: registers up to
#: 64, the wide instance's shared memory above).
MAX_HEAD_DIM = 256

_CACHE_DTYPES = (torch.float32, torch.bfloat16)
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("flash_decode")
        lib.flash_decode.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.flash_decode.restype = ctypes.c_int
        _lib = lib
    return _lib


def flash_decode_attend_reference(cache_k, cache_v, qg, n_rows: int):
    """Plain PyTorch attend: the XLA attend of the JAX decode
    (transformer.py:1043-1047) over rows ``[0, n_rows)``: scores, softmax over
    time and the PV sum, all in float32.

    Args:
        cache_k, cache_v: (S, hd, G) caches; qg: (hd, G) pre-scaled query.
    Returns:
        (hd, G) float32.
    """
    k = cache_k[:n_rows].float()
    v = cache_v[:n_rows].float()
    logits = torch.sum(k * qg[None], dim=1)  # (n_rows, G)
    attn = torch.softmax(logits, dim=0)
    return torch.sum(v * attn[:, None, :], dim=0)


def _check(cache_k, cache_v, qg, n_rows):
    if cache_k.dtype not in _CACHE_DTYPES or cache_v.dtype != cache_k.dtype:
        raise TypeError(f"flash_decode: caches must both be float32 or both bfloat16, got "
                        f"{cache_k.dtype} and {cache_v.dtype}")
    if qg.dtype != torch.float32:
        raise TypeError(f"flash_decode: the query must be float32, got {qg.dtype}")
    if cache_k.dim() != 3 or cache_v.shape != cache_k.shape or qg.shape != cache_k.shape[1:]:
        raise ValueError(f"flash_decode shapes: caches (S, hd, G) and query (hd, G), got "
                         f"{tuple(cache_k.shape)}, {tuple(cache_v.shape)}, {tuple(qg.shape)}")
    if not (cache_k.is_contiguous() and cache_v.is_contiguous() and qg.is_contiguous()):
        raise ValueError("flash_decode: caches and query must be contiguous")
    s, hd, _ = cache_k.shape
    if hd > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode: head dim {hd} above the kernel's {MAX_HEAD_DIM}")
    if not 1 <= n_rows <= s:
        raise ValueError(f"flash_decode: n_rows={n_rows} outside [1, {s}]")


def _launch(cache_k, cache_v, qg, n_rows):
    global launches
    dev = cache_k.device
    if dev.type != "cuda" or cache_v.device != dev or qg.device != dev:
        raise ValueError(f"flash_decode kernel needs CUDA tensors on one device, got "
                         f"{cache_k.device}, {cache_v.device}, {qg.device}")
    _, hd, g = cache_k.shape
    out = torch.empty((hd, g), dtype=torch.float32, device=dev)
    err = _library().flash_decode(
        cache_k.data_ptr(), cache_v.data_ptr(), qg.data_ptr(), out.data_ptr(), hd, g, n_rows,
        int(cache_k.dtype == torch.bfloat16), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_decode kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def flash_decode_attend(cache_k, cache_v, qg, n_rows: int):
    """One decode step of attention over the first ``n_rows`` rows of
    merged-lane caches.

    Args:
        cache_k, cache_v: (S, hd, G) caches, float32 or bfloat16, contiguous.
        qg: (hd, G) float32 pre-scaled query, contiguous.
        n_rows: rows to attend over (``t + 1`` at decode step ``t``), a host
            int in ``[1, S]``.
    Returns:
        (hd, G) float32. A CPU tensor takes
        :func:`flash_decode_attend_reference`; a CUDA tensor takes the
        kernel, or the call raises.
    """
    _check(cache_k, cache_v, qg, n_rows)
    if cache_k.device.type == "cpu" and cache_v.device.type == "cpu" and qg.device.type == "cpu":
        return flash_decode_attend_reference(cache_k, cache_v, qg, n_rows)
    return _launch(cache_k, cache_v, qg, n_rows)
