"""Mean bidirectional P2CP distance: the Hopper kernel's wrapper and its plain
version.

Counterpart of artspeech_tpu/ops/pallas_kernels.py:mean_p2cp_pallas (the
Pallas ``_p2cp_kernel``), on the channel-major layout of
artspeech_tpu/ops/distances.py:mean_p2cp_channel_major. The kernel is
``csrc/p2cp.cu``.

- A CPU tensor takes the plain version, :func:`mean_p2cp_channel_major_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

A gradient through a CUDA call takes :class:`_MeanP2CP`: the kernel forward
and, as backward, the VJP of the plain version recomputed from the saved
inputs, as JAX's ``_mean_p2cp_fast`` (ops/distances.py) pairs the Pallas
forward with the XLA formula's VJP; there is no backward kernel. Without a
gradient asked for, the wrapper launches the kernel directly. ``launches``
counts kernel launches. It launches with the geometry of
:func:`p2cp_launch_geometry`, from the shape alone.
"""

import ctypes
from typing import NamedTuple

import torch

from artspeech_tpu_torch.ops import _build
from artspeech_tpu_torch.ops.point_pairs import (
    MAX_SMEM,
    ROWS_A_WARP,
    blocks_of,
    pick_tile,
    warps_for,
)

#: Kernel launches so far (the plain version does not count).
launches = 0

#: The (KU, KV, N, M) tiles csrc/p2cp.cu compiles (its P2CP_TILES): the
#: contours' 50 x 50 in one 52 x 52 block with the shape compiled in, and
#: 32 x 32 blocks for any other shape.
TILES = ((13, 13, 50, 50), (8, 8, 0, 0))
_lib = None


class P2CPGeometry(NamedTuple):
    """How the kernel launches at one shape (:func:`p2cp_launch_geometry`).

    The kernel is passed ``points_u``, ``points_v``, ``exact``, ``warps``
    and ``smem_bytes``; the other fields describe that launch.
    """

    points_u: int    #: KU, u points a lane a tile
    points_v: int    #: KV, v points a lane a chunk
    exact: bool      #: the tile compiled with this (N, M)
    u_tiles: int     #: ceil(N / (LANES_U * KU))
    v_chunks: int    #: ceil(M / (LANES_V * KV))
    warps: int       #: warps a CTA, ROWS_A_WARP rows each
    threads: int     #: 32 * warps
    blocks: int      #: ceil(R / (warps * ROWS_A_WARP))
    smem_bytes: int  #: the warps' staged rows (and column minima) in f32


def p2cp_launch_geometry(rows, n, m):
    """The launch of csrc/p2cp.cu for ``rows`` rows of N u points and M v
    points, from the shape alone: the tile of TILES compiled with (N, M)
    where there is one, else the one for any shape; and as many warps a CTA
    (up to 4) as their staged rows fit in a block's shared memory, 0 where
    one warp does not fit (the wrapper refuses the shape)."""
    tile = pick_tile(TILES, n, m)
    u_tiles, v_chunks = blocks_of(n, m, tile)
    row_bytes = 4 * (2 * (n + m) + (m if u_tiles > 1 else 0))
    warps = warps_for(row_bytes)
    return P2CPGeometry(*tile[:2], tile[2:] != (0, 0), u_tiles, v_chunks, warps, 32 * warps,
                        -(-rows // (warps * ROWS_A_WARP)) if warps else 0,
                        warps * ROWS_A_WARP * row_bytes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("p2cp")
        lib.p2cp.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        lib.p2cp.restype = ctypes.c_int
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


def _check(u, v):
    if u.device.type != "cuda" or v.device.type != "cuda" or u.device != v.device:
        raise ValueError(
            f"p2cp kernel needs CUDA tensors on one device, got {u.device}, {v.device}")
    if u.dim() < 2 or v.dim() < 2 or u.shape[-2] != 2 or v.shape[-2] != 2 \
            or u.shape[:-2] != v.shape[:-2]:
        raise ValueError(f"p2cp kernel shapes: u (..., 2, N), v (..., 2, M) with the same "
                         f"leading dims, got {tuple(u.shape)}, {tuple(v.shape)}")
    if u.shape[-1] == 0 or v.shape[-1] == 0:
        raise ValueError(f"p2cp kernel needs points in both sets, got N={u.shape[-1]}, "
                         f"M={v.shape[-1]}")


def _launch(u, v):
    global launches
    _check(u, v)
    lead = u.shape[:-2]
    n, m = u.shape[-1], v.shape[-1]
    rows = lead.numel()
    geo = p2cp_launch_geometry(rows, n, m)
    if geo.warps == 0:
        raise ValueError(f"p2cp kernel: N={n}, M={m} need more than the {MAX_SMEM} B of "
                         f"shared memory a block may use for {ROWS_A_WARP} rows")
    # f32 only, as the TPU wrapper casts; contiguous (R, 2, N) rows.
    u = u.to(torch.float32).contiguous()
    v = v.to(torch.float32).contiguous()
    out = torch.empty(lead, dtype=torch.float32, device=u.device)
    if rows == 0:
        return out
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().p2cp(u.data_ptr(), v.data_ptr(), out.data_ptr(), rows, n, m,
                              geo.points_u, geo.points_v, int(geo.exact), geo.warps,
                              geo.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"p2cp kernel launch failed with CUDA error {err}")
    launches += 1
    return out


def plain_vjp(reference, inputs, grads, needs):
    """The VJP of ``reference`` at ``inputs`` (recomputed in f32) for the
    output cotangents ``grads``; None for each input not in ``needs``, each
    gradient in its input's dtype."""
    with torch.enable_grad():
        xs = [x.detach().to(torch.float32).requires_grad_(need) for x, need in zip(inputs, needs)]
        out = reference(*xs)
        wanted = [x for x in xs if x.requires_grad]
        got = iter(torch.autograd.grad(out, wanted, grads) if wanted else ())
    return [next(got).to(x.dtype) if need else None for x, need in zip(inputs, needs)]


class _MeanP2CP(torch.autograd.Function):
    """The kernel forward; the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, u, v):
        ctx.save_for_backward(u, v)
        return _launch(u, v)

    @staticmethod
    def backward(ctx, grad):
        return tuple(plain_vjp(mean_p2cp_channel_major_reference, ctx.saved_tensors, grad,
                               ctx.needs_input_grad))


def mean_p2cp_channel_major(u, v):
    """Mean bidirectional P2CP per row of channel-major contours.

    Args:
        u: (..., 2, N); v: (..., 2, M).
    Returns:
        (...,) f32. A CPU tensor takes :func:`mean_p2cp_channel_major_reference`;
        a CUDA tensor takes the kernel, or the call raises. With a gradient
        asked for, the CUDA call goes through :class:`_MeanP2CP`.
    """
    if u.device.type == "cpu" and v.device.type == "cpu":
        return mean_p2cp_channel_major_reference(u, v)
    if torch.is_grad_enabled() and (u.requires_grad or v.requires_grad):
        return _MeanP2CP.apply(u, v)
    return _launch(u, v)
