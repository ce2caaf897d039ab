"""Minimum pairwise distance and its argmin pair: the Hopper kernel's wrapper
and its plain version.

Counterpart of artspeech_tpu/ops/pallas_kernels.py:min_distance_pallas (the
Pallas ``_min_dist_kernel``) and of the XLA formula
artspeech_tpu/ops/distances.py:min_distance, on the model's channel-major
layout. The kernel is ``csrc/min_dist.cu``. It takes a table of problems in
one launch: each a u window of a point set and one or two v windows read as
one set, all read in place from up to 8 channel-major sources by their
strides (:func:`min_distance_windows`; the tract variables' four in one
launch). :func:`min_distance_channel_major` is the table of one problem.

- A CPU tensor takes the plain version,
  :func:`min_distance_windows_reference` /
  :func:`min_distance_channel_major_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

A gradient through a CUDA call takes :class:`_MinDistanceWindows` or
:class:`_MinDistance`: the kernel forward and, as backward, the VJP of the
plain version recomputed from the saved inputs (JAX differentiates its XLA
formula; there is no backward kernel). The gradient reaches the sources
through the distances and, for a table, through the gathered places of
constriction, as JAX's ``take_along_axis`` passes it; the indices carry
none. Without a gradient asked for, the wrappers launch the kernel
directly. ``launches`` counts kernel launches. The kernel launches with
the geometry of :func:`min_dist_launch_geometry`, from the shapes alone.
"""

import ctypes
from typing import NamedTuple, Sequence, Tuple

import torch

from artspeech_tpu_torch.ops import _build
from artspeech_tpu_torch.ops.hopper_p2cp import plain_vjp
from artspeech_tpu_torch.ops.point_pairs import (
    MAX_SMEM,
    ROWS_A_WARP,
    blocks_of,
    pick_tile,
    warps_for,
)

#: Kernel launches so far (the plain version does not count).
launches = 0

#: The (KU, KV, N, M) tiles csrc/min_dist.cu compiles, by tile id (its
#: MIN_DIST_TILES): the tract variables' LA (50 x 50), TTCD (15 x 25), TBCD
#: (20 x 40) and VEL (15 x 50) each in one block with its shape compiled in,
#: and 32 x 32 blocks for any other shape.
TILES = ((13, 13, 50, 50), (4, 7, 15, 25), (5, 10, 20, 40), (4, 13, 15, 50), (8, 8, 0, 0))
MAX_SOURCES = MAX_PROBLEMS = 8
OUT_FIELDS = 5  # dist, poc_1 (x, y), poc_2 (x, y)
#: The source dtypes the kernel reads in place, by its dtype code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_lib = None


class Window(NamedTuple):
    """Points ``start, ..., start + count - 1`` of source ``source``."""

    source: int
    start: int
    count: int


#: A problem: the u window and the v windows (one or two, read as one set).
Problem = Tuple[Window, Tuple[Window, ...]]


class ProblemLaunch(NamedTuple):
    """One problem of a launch (:func:`min_dist_launch_geometry`)."""

    slot: int         #: its place in the table and in the output
    tile: int         #: index into TILES
    u_tiles: int      #: ceil(N / (LANES_U * KU))
    v_chunks: int     #: ceil(M / (LANES_V * KV))
    blocks: int       #: CTAs, ceil(R / (warps * ROWS_A_WARP))
    first_block: int  #: its first CTA: the problems run in this order


class MinDistGeometry(NamedTuple):
    """How the kernel launches a table (:func:`min_dist_launch_geometry`)."""

    problems: Tuple[ProblemLaunch, ...]  #: heaviest a row first
    warps: int       #: warps a CTA, ROWS_A_WARP rows of one problem each
    threads: int     #: 32 * warps
    blocks: int      #: all problems' CTAs
    smem_bytes: int  #: the warps' staged rows in f32, at the largest problem


def min_dist_launch_geometry(rows, shapes):
    """The launch of csrc/min_dist.cu for ``rows`` rows of each problem's
    (N, M) in ``shapes`` (table order), from the shapes alone: each
    problem's tile of TILES compiled with its (N, M) where there is one,
    else the one for any shape; the problems ordered by N * M, the most
    pairs a row first (their CTAs run first, so the light ones fill the
    tail); and as many warps a CTA (up to 4) as the largest problem's staged
    rows fit in a block's shared memory, 0 where one warp does not fit (the
    wrapper refuses the table)."""
    tiles = [pick_tile(TILES, n, m) for n, m in shapes]
    order = sorted(range(len(shapes)), key=lambda p: -shapes[p][0] * shapes[p][1])
    row_bytes = max(4 * 2 * (n + m) for n, m in shapes)
    warps = warps_for(row_bytes)
    per_problem = -(-rows // (warps * ROWS_A_WARP)) if warps else 0
    problems = tuple(ProblemLaunch(p, TILES.index(tiles[p]), *blocks_of(*shapes[p], tiles[p]),
                                   per_problem, k * per_problem) for k, p in enumerate(order))
    return MinDistGeometry(problems, warps, 32 * warps, len(shapes) * per_problem,
                           warps * ROWS_A_WARP * row_bytes)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("min_dist")
        lib.min_dist.argtypes = ([ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
                                 + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 3)
        lib.min_dist.restype = ctypes.c_int
        _lib = lib
    return _lib


def _points(contour, index):
    """The points ``index`` (...,) of a channel-major (..., 2, N) contour -> (..., 2)."""
    return torch.gather(contour, -1, index[..., None, None].expand(*index.shape, 2, 1))[..., 0]


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


def _cut(sources, window):
    return sources[window.source][..., window.start:window.start + window.count]


def min_distance_windows_reference(sources, problems):
    """Plain PyTorch table of problems: each window cut, the v windows
    concatenated, :func:`min_distance_channel_major_reference`, and the
    winning points gathered.

    Returns:
        (P, ..., 5): each problem's distance and its two points' (x, y).
    """
    out = []
    for u_window, v_windows in problems:
        u = _cut(sources, u_window)
        v = torch.cat([_cut(sources, w) for w in v_windows], dim=-1)
        value, i, j = min_distance_channel_major_reference(u, v)
        out.append(torch.cat([value[..., None], _points(u, i), _points(v, j)], dim=-1))
    return torch.stack(out)


def _check(sources: Sequence[torch.Tensor], problems: Sequence[Problem]):
    if not 1 <= len(sources) <= MAX_SOURCES or not 1 <= len(problems) <= MAX_PROBLEMS:
        raise ValueError(f"min_dist kernel takes 1-{MAX_SOURCES} sources and 1-{MAX_PROBLEMS} "
                         f"problems, got {len(sources)} and {len(problems)}")
    device, lead = sources[0].device, sources[0].shape[:-2]
    for s in sources:
        if s.device.type != "cuda" or s.device != device:
            raise ValueError(f"min_dist kernel needs CUDA tensors on one device, got {s.device}")
        if s.dim() < 2 or s.shape[-2] != 2 or s.shape[:-2] != lead:
            raise ValueError(f"min_dist kernel sources: (..., 2, N) with the same leading dims, "
                             f"got {[tuple(t.shape) for t in sources]}")
    for u_window, v_windows in problems:
        if not 1 <= len(v_windows) <= 2:
            raise ValueError(f"min_dist kernel: v is one or two windows, got {len(v_windows)}")
        for w in (u_window, *v_windows):
            if not (0 <= w.source < len(sources) and w.count >= 1 and w.start >= 0
                    and w.start + w.count <= sources[w.source].shape[-1]):
                raise ValueError(f"min_dist kernel: window {w} is not inside its source")


def _launch(sources, problems, with_idx):
    """The kernel over ``problems``: (out (P, ..., 5) f32, idx (2, P, ...) int64
    or None)."""
    global launches
    _check(sources, problems)
    lead = sources[0].shape[:-2]
    shapes = [(u.count, sum(w.count for w in vs)) for u, vs in problems]
    rows = lead.numel()
    geo = min_dist_launch_geometry(rows, shapes)
    if geo.warps == 0:
        raise ValueError(f"min_dist kernel: (N, M) = {max(shapes, key=sum)} need more than the "
                         f"{MAX_SMEM} B of shared memory a block may use for {ROWS_A_WARP} rows")
    # Read in place (bf16 and f16 widened in the kernel); mixed or other types as f32.
    dtype = sources[0].dtype
    if dtype not in _DTYPES or any(s.dtype != dtype for s in sources):
        sources, dtype = [s.to(torch.float32) for s in sources], torch.float32
    # (R, 2, N_s) views where the leading dims flatten to one stride (reshape
    # copies only where they do not).
    flat = [s.reshape(-1, 2, s.shape[-1]) for s in sources]
    device = sources[0].device
    out = torch.empty((len(problems), *lead, OUT_FIELDS), dtype=torch.float32, device=device)
    idx = (torch.empty((2, len(problems), *lead), dtype=torch.int64, device=device)
           if with_idx else None)
    if rows == 0:
        return out, idx
    src = (ctypes.c_longlong * (4 * len(flat)))(
        *[x for s in flat for x in (s.data_ptr(), *s.stride())])
    table = (ctypes.c_int * (12 * len(problems)))(*[
        x for launch in geo.problems for x in (
            launch.tile, launch.slot, launch.first_block,
            *problems[launch.slot][0],
            *problems[launch.slot][1][0],
            *(problems[launch.slot][1][1] if len(problems[launch.slot][1]) == 2 else (0, 0, 0)))])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().min_dist(src, len(flat), table, len(problems), rows,
                                  _DTYPES[dtype], geo.warps, geo.blocks,
                                  geo.smem_bytes, out.data_ptr(),
                                  idx.data_ptr() if with_idx else None, stream)
    if err != 0:
        raise RuntimeError(f"min_dist kernel launch failed with CUDA error {err}")
    launches += 1
    return out, idx


def _grad_asked(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _MinDistanceWindows(torch.autograd.Function):
    """The kernel forward over a table; the plain version's VJP backward."""

    @staticmethod
    def forward(ctx, problems, *sources):
        ctx.problems = problems
        ctx.save_for_backward(*sources)
        return _launch(list(sources), problems, with_idx=False)[0]

    @staticmethod
    def backward(ctx, grad):
        def reference(*sources):
            return min_distance_windows_reference(list(sources), ctx.problems)

        return (None, *plain_vjp(reference, ctx.saved_tensors, grad, ctx.needs_input_grad[1:]))


class _MinDistance(torch.autograd.Function):
    """The kernel forward of one problem; the plain distance's VJP backward."""

    @staticmethod
    def forward(ctx, u, v):
        ctx.save_for_backward(u, v)
        problem = (Window(0, 0, u.shape[-1]), (Window(1, 0, v.shape[-1]),))
        out, idx = _launch([u, v], [problem], with_idx=True)
        ctx.mark_non_differentiable(idx)
        return out[0, ..., 0], idx[0, 0], idx[1, 0]

    @staticmethod
    def backward(ctx, grad, _grad_u, _grad_v):
        def reference(u, v):
            return min_distance_channel_major_reference(u, v)[0]

        return tuple(plain_vjp(reference, ctx.saved_tensors, grad, ctx.needs_input_grad))


def min_distance_windows(sources, problems):
    """Each problem's minimum distance and its two places of constriction.

    Args:
        sources: up to 8 channel-major point sets (..., 2, N_s) with the same
            leading dims.
        problems: up to 8 (u Window, v Windows), the v windows (one or two)
            read as one set in their order.
    Returns:
        (P, ..., 5): the distance, the u point's (x, y) and the v point's (x,
        y) of each problem's first least squared distance (first flat index
        on ties, NaN first). A CPU tensor takes
        :func:`min_distance_windows_reference`; a CUDA tensor takes the
        kernel (f32 out), or the call raises. With a gradient asked for, the
        CUDA call goes through :class:`_MinDistanceWindows`.
    """
    if all(s.device.type == "cpu" for s in sources):
        return min_distance_windows_reference(sources, problems)
    if _grad_asked(sources):
        return _MinDistanceWindows.apply(problems, *sources)
    return _launch(sources, problems, with_idx=False)[0]


def min_distance_channel_major(u, v):
    """Minimum pairwise distance per row of channel-major point sets, and
    the pair that attains it.

    Args:
        u: (..., 2, N); v: (..., 2, M).
    Returns:
        (dist (...,) f32, idx_u (...,) int64, idx_v (...,) int64); ties go to
        the smallest flat index ``idx_u * M + idx_v``. A CPU tensor takes
        :func:`min_distance_channel_major_reference`; a CUDA tensor takes the
        kernel (a table of one problem), or the call raises. With a gradient
        asked for, the CUDA call goes through :class:`_MinDistance`.
    """
    if u.device.type == "cpu" and v.device.type == "cpu":
        return min_distance_channel_major_reference(u, v)
    if u.dim() < 2 or v.dim() < 2:
        raise ValueError(f"min_dist kernel shapes: u (..., 2, N), v (..., 2, M), got "
                         f"{tuple(u.shape)}, {tuple(v.shape)}")
    if _grad_asked((u, v)):
        return _MinDistance.apply(u, v)
    problem = (Window(0, 0, u.shape[-1]), (Window(1, 0, v.shape[-1]),))
    out, idx = _launch([u, v], [problem], with_idx=True)
    return out[0, ..., 0], idx[0, 0], idx[1, 0]
