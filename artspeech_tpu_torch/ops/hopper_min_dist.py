"""Minimum pairwise distance and its argmin pair: the Hopper kernel's wrapper
and its plain version.

Counterpart of artspeech_tpu/ops/pallas_kernels.py:min_distance_pallas (the
Pallas ``_min_dist_kernel``) and of the XLA formula
artspeech_tpu/ops/distances.py:min_distance, on the model's channel-major
layout. The kernel is ``csrc/min_dist.cu``.

- A CPU tensor takes the plain version,
  :func:`min_distance_channel_major_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

The kernel is forward only: the tract variables are outputs of the test step
under ``torch.inference_mode``, and the wrapper raises for a CUDA input that
requires grad. ``launches`` counts kernel launches.
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
        lib = _build.load("min_dist")
        lib.min_dist.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        lib.min_dist.restype = ctypes.c_int
        lib.min_dist_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.min_dist_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def min_distance_channel_major_reference(u, v):
    """Plain PyTorch min distance: the broadcast formula, the flat argmin over
    the (..., N, M) squared distances (first flat index on ties) and the
    sqrt of the winner.

    Args:
        u: (..., 2, N); v: (..., 2, M) — x row, then y row.
    Returns:
        (dist (...,), idx_u (...,) int64, idx_v (...,) int64).
    """
    dx = u[..., 0, :, None] - v[..., 0, None, :]
    dy = u[..., 1, :, None] - v[..., 1, None, :]
    sq = dx * dx + dy * dy
    m = sq.shape[-1]
    flat = sq.flatten(-2)
    arg = flat.argmin(dim=-1)
    best = flat.gather(-1, arg[..., None])[..., 0]
    return torch.sqrt(torch.clamp(best, min=0.0)), arg // m, arg % m


def _launch(u, v):
    global launches
    if u.device.type != "cuda" or v.device.type != "cuda" or u.device != v.device:
        raise ValueError(
            f"min_dist kernel needs CUDA tensors on one device, got {u.device}, {v.device}")
    if u.requires_grad or v.requires_grad:
        raise RuntimeError("min_dist kernel has no backward; call it on tensors that do not "
                           "require grad (the test step runs under torch.inference_mode)")
    if u.dim() < 2 or v.dim() < 2 or u.shape[-2] != 2 or v.shape[-2] != 2 \
            or u.shape[:-2] != v.shape[:-2]:
        raise ValueError(f"min_dist kernel shapes: u (..., 2, N), v (..., 2, M) with the same "
                         f"leading dims, got {tuple(u.shape)}, {tuple(v.shape)}")
    lead = u.shape[:-2]
    n, m = u.shape[-1], v.shape[-1]
    if n == 0 or m == 0:
        raise ValueError(f"min_dist kernel needs points in both sets, got N={n}, M={m}")
    smem = _library().min_dist_smem_bytes(n, m)
    if smem > _MAX_SMEM:
        raise ValueError(f"min_dist kernel: N={n}, M={m} need {smem} B of shared memory, "
                         f"more than the {_MAX_SMEM} B a block may use")
    # f32 only, as the TPU wrapper casts; contiguous (R, 2, N) rows.
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    rows = u.numel() // (2 * n)
    dist = torch.empty(lead, dtype=torch.float32, device=u.device)
    idx_u = torch.empty(lead, dtype=torch.int64, device=u.device)
    idx_v = torch.empty(lead, dtype=torch.int64, device=u.device)
    if rows == 0:
        return dist, idx_u, idx_v
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().min_dist(u.data_ptr(), v.data_ptr(), dist.data_ptr(), idx_u.data_ptr(),
                                  idx_v.data_ptr(), rows, n, m, stream)
    if err != 0:
        raise RuntimeError(f"min_dist kernel launch failed with CUDA error {err}")
    launches += 1
    return dist, idx_u, idx_v


def min_distance_channel_major(u, v):
    """Minimum pairwise distance per row of channel-major point sets, and
    the pair that attains it.

    Args:
        u: (..., 2, N); v: (..., 2, M).
    Returns:
        (dist (...,) f32, idx_u (...,) int64, idx_v (...,) int64); ties go to
        the smallest flat index ``idx_u * M + idx_v``. A CPU tensor takes
        :func:`min_distance_channel_major_reference`; a CUDA tensor takes the
        kernel, or the call raises.
    """
    if u.device.type == "cpu" and v.device.type == "cpu":
        return min_distance_channel_major_reference(u, v)
    return _launch(u, v)
