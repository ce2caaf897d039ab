"""Mean bidirectional P2CP distance: the Hopper kernel's wrapper and its plain
version.

Counterpart of artspeech_tpu/ops/pallas_kernels.py:mean_p2cp_pallas (the
Pallas ``_p2cp_kernel``), on the channel-major layout of
artspeech_tpu/ops/distances.py:mean_p2cp_channel_major. The kernel is
``csrc/p2cp.cu``.

- A CPU tensor takes the plain version, :func:`mean_p2cp_channel_major_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

The kernel is forward only: the train and eval steps use P2CP as a metric,
outside autograd, and the wrapper raises for a CUDA input that requires grad.
``launches`` counts kernel launches.
"""

import ctypes

import torch

from artspeech_tpu_torch.ops import _build

#: Kernel launches so far (the plain version does not count).
launches = 0

_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("p2cp")
        lib.p2cp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.p2cp.restype = ctypes.c_int
        lib.p2cp_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.p2cp_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def _sq_dists(a, b):
    """(..., N, M) squared distances between channel-major (..., 2, N) and
    (..., 2, M) point sets, the coordinate sum written out."""
    dx = a[..., 0, :, None] - b[..., 0, None, :]
    dy = a[..., 1, :, None] - b[..., 1, None, :]
    return dx * dx + dy * dy


def mean_p2cp_channel_major_reference(u, v):
    """Plain PyTorch mean P2CP: the broadcast formula, one (..., N, M) tensor
    per direction, min over squared distances and sqrt of the winners.

    Args:
        u: (..., 2, N); v: (..., 2, M) — x row, then y row.
    Returns:
        (...,) the mean of both directions' mean closest-point distances.
    """
    u2cp = torch.sqrt(torch.clamp(_sq_dists(u, v).amin(dim=-1), min=0.0))
    v2cp = torch.sqrt(torch.clamp(_sq_dists(v, u).amin(dim=-1), min=0.0))
    return (u2cp.mean(dim=-1) + v2cp.mean(dim=-1)) / 2.0


def _launch(u, v):
    global launches
    if u.device.type != "cuda" or v.device.type != "cuda" or u.device != v.device:
        raise ValueError(
            f"p2cp kernel needs CUDA tensors on one device, got {u.device}, {v.device}")
    if torch.is_grad_enabled() and (u.requires_grad or v.requires_grad):
        raise RuntimeError("p2cp kernel has no backward; call it under torch.no_grad() "
                           "on detached tensors")
    if u.dim() < 2 or v.dim() < 2 or u.shape[-2] != 2 or v.shape[-2] != 2 \
            or u.shape[:-2] != v.shape[:-2]:
        raise ValueError(f"p2cp kernel shapes: u (..., 2, N), v (..., 2, M) with the same "
                         f"leading dims, got {tuple(u.shape)}, {tuple(v.shape)}")
    lead = u.shape[:-2]
    n, m = u.shape[-1], v.shape[-1]
    if n == 0 or m == 0:
        raise ValueError(f"p2cp kernel needs points in both sets, got N={n}, M={m}")
    smem = _library().p2cp_smem_bytes(n, m)
    if smem > _MAX_SMEM:
        raise ValueError(f"p2cp kernel: N={n}, M={m} need {smem} B of shared memory, "
                         f"more than the {_MAX_SMEM} B a block may use")
    # f32 only, as the TPU wrapper casts; contiguous (R, 2, N) rows.
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    rows = u.numel() // (2 * n)
    out = torch.empty(lead, dtype=torch.float32, device=u.device)
    if rows == 0:
        return out
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().p2cp(u.data_ptr(), v.data_ptr(), out.data_ptr(), rows, n, m, stream)
    if err != 0:
        raise RuntimeError(f"p2cp kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def mean_p2cp_channel_major(u, v):
    """Mean bidirectional P2CP per row of channel-major contours.

    Args:
        u: (..., 2, N); v: (..., 2, M).
    Returns:
        (...,) f32. A CPU tensor takes :func:`mean_p2cp_channel_major_reference`;
        a CUDA tensor takes the kernel, or the call raises.
    """
    if u.device.type == "cpu" and v.device.type == "cpu":
        return mean_p2cp_channel_major_reference(u, v)
    return _launch(u, v)
