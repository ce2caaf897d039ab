"""Fused causal attention for training: the Hopper kernels' wrappers and their
plain versions.

Counterpart of artspeech_tpu/ops/pallas_train_attention.py:fused_causal_attend
(the Pallas ``_fwd_kernel`` and ``_bwd_kernel`` wired by a custom VJP), which
serves the multi-channel transformer's cross-channel pair attention in
training (models/transformer.py, ``ChannelInteractionsLayer`` in training
mode). The kernels are ``csrc/train_attention.cu``; :class:`FusedCausalAttendFn`
wires them as a ``torch.autograd.Function``.

- A CPU tensor takes the plain versions, :func:`fused_causal_attend_reference`
  and :func:`fused_causal_attend_bwd_reference`.
- A CUDA tensor takes the kernels, or the call raises. Nothing falls back.
- Any other device raises.

On every device the call raises for what the kernels do not take: tensors
other than float32, tensors that are not contiguous, a head dim above
``MAX_HEAD_DIM`` and a ``G`` that ``n_pairs`` does not divide. The kernels
take any G and any L, each shape by one route (:func:`resident`):

- up to hd = ``RESIDENT_MAX_HD`` and L = ``MAX_L``, the thesis transformer's
  hd = 16 at the default buckets among them, the resident kernels: each
  walks its groups' causal triangles in query strips with the K and V rows
  of a whole group in shared memory and the keep mask read along keys (the
  forward a CTA of groups of one pair in step, launched as
  :func:`train_attention_fwd_launch_geometry` says; the backward as
  :func:`train_attention_bwd_launch_geometry` says);
- every other shape, the streamed kernels: a CTA owns a tile of 32 rows of
  one group (query rows for the forward and dQ, keys for dK/dV) and
  streams the other side's rows and the keep mask through shared memory
  in stages, so that its shared memory does not grow with L; the
  backward is two launches, dQ (which also writes D = dO . out into a
  (G, L) scratch) then dK and dV, as
  :func:`train_attention_stream_launch_geometry` says. The loader's
  buckets past the longest default one (data/batching.py rounds the
  longest sentence up to 64) take them, where JAX sends those lengths to
  its XLA attention.

The TPU wrapper's tile rules (``supported``, ``G_BLOCK``, ``L % 128``,
``_spmd_safe``) and its ``ARTSPEECH_NO_TRAIN_ATTENTION_KERNEL`` switch are
not ported.

``launches_fwd`` and ``launches_bwd`` count kernel launches.
"""

import ctypes
import functools
from typing import NamedTuple

import torch

from artspeech_tpu_torch.ops import _build

#: Forward kernel launches so far (the plain version does not count).
launches_fwd = 0
#: Backward kernel launches so far (the plain version does not count).
launches_bwd = 0

#: Longest sequence of the resident kernels: the largest default bucket
#: (data/batching.py DEFAULT_BUCKETS). Longer ones take the streamed kernels.
MAX_L = 512
#: Largest head dim the kernels take (csrc/train_attention.cu).
MAX_HEAD_DIM = 128
#: Largest head dim of the resident kernels (rows padded to 16 or 32 floats).
RESIDENT_MAX_HD = 32
#: Threads a CTA of the backward's strip kernel at most (train_attention.cu:
#: strip::MAX_THREADS).
BWD_MAX_THREADS = 256
#: Threads a CTA of the forward's strip kernel at most (train_attention.cu:
#: fwd::MAX_THREADS), which its launch rule fills.
FWD_MAX_THREADS = 128
#: Bytes of shared memory one Hopper block may use.
MAX_SMEM = 232448
#: Rows of one group a CTA of each streamed kernel owns (train_attention.cu:
#: stream::ROWS), and its threads: 4 warps, each 8 of the rows.
STREAM_ROWS = 32
STREAM_THREADS = 128
#: The streamed kernels, in the order of train_attention.cu's stream::cta_floats kinds.
STREAM_KINDS = ("fwd", "dq", "dkv")

_lib = None


class BwdGeometry(NamedTuple):
    """How the backward's strip kernel launches at one shape
    (:func:`train_attention_bwd_launch_geometry`); the kernel is passed
    ``groups``, ``tq``, ``threads``, ``nku`` and ``smem_bytes``."""

    groups: int      #: groups a CTA, each walked by its own ``threads``
    tq: int          #: query rows a strip (16 or 32)
    threads: int     #: threads a group, whole warps
    nku: int         #: (4 keys, 4 dims) units of dK and of dV a thread (1, 2 or 4)
    ctas: int        #: ceil(G / groups)
    smem_bytes: int  #: dynamic shared memory a CTA


class FwdGeometry(NamedTuple):
    """How the forward's strip kernel launches at one shape
    (:func:`train_attention_fwd_launch_geometry`); the kernel is passed
    ``groups``, ``tq``, ``threads`` and ``smem_bytes``."""

    groups: int      #: groups a CTA, all of one pair, walked in step
    tq: int          #: query rows a strip (8, 16 or 32)
    threads: int     #: threads a CTA: a warp for each 8 rows of a strip and group
    ctas: int        #: n_pairs * ceil((G / n_pairs) / groups)
    smem_bytes: int  #: dynamic shared memory a CTA


def _round_up(x, m):
    return -(-x // m) * m


def bwd_group_floats(l, hd, tq):
    """Floats of shared memory one group of the strip kernel takes
    (train_attention.cu: strip::group_floats): K and V rows (L rounded up to
    32, rows of hd_max + 4 floats), two buffers each of the strip's Q and dO
    rows and one of its out rows, the strip's P keep and dS (rows of L
    rounded up to 32, + 8), and lse and D."""
    hd_max = 16 if hd <= 16 else 32
    lr, row = _round_up(l, 32), hd_max + 4
    return 2 * lr * row + 5 * tq * row + 2 * tq * (lr + 8) + 2 * lr


def fwd_cta_floats(l, hd, groups, tq):
    """Floats of shared memory one CTA of the forward's strip kernel takes
    (train_attention.cu: fwd::smem_floats): for each group K and V rows (L
    rounded up to 32) and two buffers of the strip's q rows, hd_max floats a
    row; two buffers of the strip's keep rows (L rounded up to 32, + 8)."""
    hd_max = 16 if hd <= 16 else 32
    lr = _round_up(l, 32)
    return groups * 2 * (lr + tq) * hd_max + 2 * tq * (lr + 8)


def train_attention_fwd_launch_geometry(g, l, hd, n_pairs=1):
    """The launch of csrc/train_attention.cu's strip forward for G groups of
    length ``l`` and head dim ``hd`` (<= ``RESIDENT_MAX_HD``), from the shape
    alone; ``n_pairs`` only sets ``ctas``.

    - ``tq``: strips of 16 query rows (8 at L <= 8); every warp of a strip
      walks the same keys.
    - ``groups``: 128 / (4 tq) groups a CTA (two, or four at L <= 8),
      sharing each keep row they read; halved, then ``tq`` halved, until
      the shared memory fits a block.
    - A CTA takes groups of one pair only: each pair's G / n_pairs groups
      fill ceil(G / n_pairs / groups) CTAs, the last with fewer live groups.

    At the transformer's shape (L = 128, hd = 16): 2 groups a CTA, strips
    of 16 rows, 128 threads, 53 KB of shared memory, 4 CTAs an SM. On the
    H100 this ran ahead of CTAs of 256 threads (2 groups and strips of 32
    rows), of one group with strips of 32 rows, and of strips of 8 rows.
    """
    tq = 8 if l <= 8 else 16
    groups = FWD_MAX_THREADS // (4 * tq)
    while 4 * fwd_cta_floats(l, hd, groups, tq) > MAX_SMEM:
        if groups > 1:
            groups //= 2
        else:
            tq //= 2
    return FwdGeometry(groups, tq, 4 * groups * tq, n_pairs * -(-(g // n_pairs) // groups),
                       4 * fwd_cta_floats(l, hd, groups, tq))


@functools.lru_cache(maxsize=1024)
def _fwd_geometry(g, l, hd):
    return train_attention_fwd_launch_geometry(g, l, hd)


def train_attention_bwd_launch_geometry(g, l, hd):
    """The launch of csrc/train_attention.cu's strip backward for G groups of
    length ``l`` and head dim ``hd`` (<= ``RESIDENT_MAX_HD``), from the shape
    alone.

    - A group's dK and dV are ceil(L / 4) x hd_max / 4 units of (4 keys, 4
      dims) (hd_max: hd rounded up to 16 or 32), held in registers across
      the walk: ``threads`` is that count rounded up to a warp, within [32,
      256], and ``nku`` the units a thread then takes (a power of two).
    - ``groups``: 128 // threads groups a CTA at L <= 64 (the small groups'
      CTAs would hold a warp or two), else 1.
    - ``tq``: strips of 16 query rows.

    At the transformer's shape (G = 4,320 and 23,040, L = 128, hd = 16: 128
    threads, nku 1) this was the fastest of the geometries probed on the
    H100; 256 threads a group, 64 threads with two units each and strips of
    32 rows ran slower.
    """
    hd_max = 16 if hd <= 16 else 32
    units = -(-l // 4) * (hd_max // 4)
    threads = min(BWD_MAX_THREADS, max(32, _round_up(units, 32)))
    nku = 1 << (-(-units // threads) - 1).bit_length()
    groups = max(1, 128 // threads) if l <= 64 else 1
    tq = 16
    return BwdGeometry(groups, tq, threads, nku, -(-g // groups),
                       4 * groups * bwd_group_floats(l, hd, tq))


@functools.lru_cache(maxsize=1024)
def _bwd_geometry(g, l, hd):
    return train_attention_bwd_launch_geometry(g, l, hd)


class StreamGeometry(NamedTuple):
    """How one streamed kernel launches at one shape
    (:func:`train_attention_stream_launch_geometry`); the kernel is passed
    ``cols`` and ``smem_bytes``."""

    cols: int        #: rows streamed a stage (32 or 64): keys (fwd, dq) or query rows (dkv)
    ctas: int        #: ceil(L / STREAM_ROWS) * G: a CTA a tile of one group's rows
    smem_bytes: int  #: dynamic shared memory a CTA


def stream_hd(hd):
    """Floats a row of the streamed kernels' instances: hd padded to 16, 32,
    64 or 128."""
    return next(h for h in (16, 32, 64, 128) if hd <= h)


def stream_cta_floats(kind, hd, cols):
    """Floats of shared memory one CTA of a streamed kernel takes
    (train_attention.cu: stream::cta_floats): its own ``STREAM_ROWS`` rows
    (q; q and dO; k and v), two buffers of a stage's ``cols`` streamed rows
    (k and v; k and v; q, dO, lse and D), two of the stage's keep rows, and
    at hd above 16 an (8, 40) weight block a warp."""
    h, r = stream_hd(hd), STREAM_ROWS
    w = STREAM_THREADS // 32 * 8 * 40 if h > 16 else 0
    if kind == "fwd":
        return r * h + 4 * cols * h + 2 * r * (cols + 8) + w
    if kind == "dq":
        return 2 * r * h + 4 * cols * h + 2 * r * (cols + 8) + w
    return 2 * r * h + 4 * cols * h + 4 * cols + 2 * cols * (r + 4) + w


def train_attention_stream_launch_geometry(g, l, hd, kind="fwd"):
    """The launch of one of csrc/train_attention.cu's streamed kernels
    (``kind`` in ``STREAM_KINDS``) for G groups of length ``l`` and head dim
    ``hd``, from the shape alone: a CTA of ``STREAM_THREADS`` threads for
    each tile of ``STREAM_ROWS`` rows of each group, stages of 64 columns at
    hd <= 32, else 32. Shared memory does not depend on L: at most ~111 KB
    (dq, hd = 128). On the H100 one group of 32 rows a CTA ran ahead of 2
    or 4 groups of 16 or 8 rows sharing their keep rows, and 32-column
    stages ahead of 64 at hd = 64 (64 ahead of 32 for the forward at
    hd = 16)."""
    cols = 64 if hd <= 32 else 32
    return StreamGeometry(cols, -(-l // STREAM_ROWS) * g,
                          4 * stream_cta_floats(kind, hd, cols))


@functools.lru_cache(maxsize=1024)
def _stream_geometry(g, l, hd, kind):
    return train_attention_stream_launch_geometry(g, l, hd, kind)


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("train_attention")
        lib.train_attention_fwd.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
                                            + [ctypes.c_size_t, ctypes.c_void_p])
        lib.train_attention_fwd.restype = ctypes.c_int
        lib.train_attention_bwd.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
                                            + [ctypes.c_size_t, ctypes.c_void_p])
        lib.train_attention_bwd.restype = ctypes.c_int
        geometry = [ctypes.c_int, ctypes.c_size_t]
        lib.train_attention_fwd_stream.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                                                   + geometry + [ctypes.c_void_p])
        lib.train_attention_fwd_stream.restype = ctypes.c_int
        lib.train_attention_bwd_stream.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4
                                                   + geometry * 2 + [ctypes.c_void_p])
        lib.train_attention_bwd_stream.restype = ctypes.c_int
        _lib = lib
    return _lib


def resident(l: int, hd: int) -> bool:
    """Whether the forward and backward at (L, hd) run the resident kernels,
    which hold a group's rows in shared memory (else the streamed ones):
    hd <= ``RESIDENT_MAX_HD`` and L <= ``MAX_L``."""
    return hd <= RESIDENT_MAX_HD and l <= MAX_L


def _causal_scores(q, k):
    l = q.shape[1]
    s = torch.einsum("gqd,gkd->gqk", q, k)
    causal = torch.ones(l, l, dtype=torch.bool, device=q.device).tril()
    return s.masked_fill(~causal, float("-inf"))


def _per_pair(x, n_pairs):
    """(G, L, L) -> (n_pairs, G // n_pairs, L, L), a view."""
    return x.reshape(n_pairs, -1, *x.shape[1:])


def fused_causal_attend_reference(q, k, v, keep, n_pairs: int):
    """Plain PyTorch forward, the TPU kernel's math in float32 (JAX
    pallas_train_attention.py:100-121): scores, the causal mask, a max-subtracted
    softmax, times the pair's keep mask, @ v.

    Args:
        q, k, v: (G, L, hd) float32, G pair-major, q pre-scaled by 1/sqrt(hd).
        keep: (n_pairs, L, L) float32 pre-scaled keep mask.
        n_pairs: pairs in G (G % n_pairs == 0).
    Returns:
        (G, L, hd) float32.
    """
    p = torch.softmax(_causal_scores(q, k), dim=-1)
    pk = (_per_pair(p, n_pairs) * keep[:, None]).reshape(p.shape)
    return torch.einsum("gqk,gkd->gqd", pk, v)


def fused_causal_attend_bwd_reference(q, k, v, keep, do, n_pairs: int):
    """Plain PyTorch backward, the TPU backward kernel written out step by step
    (JAX pallas_train_attention.py:129-158): S and P recomputed, dV = (P keep)^T
    dO, dP = (dO V^T) keep, dS = P (dP - rowsum(dP P)), dQ = dS K, dK = dS^T Q.

    Args:
        q, k, v, keep, n_pairs: as in :func:`fused_causal_attend_reference`.
        do: (G, L, hd) float32, the gradient by the output.
    Returns:
        (dq, dk, dv), each (G, L, hd) float32. ``keep`` gets no gradient.
    """
    s = _causal_scores(q, k)
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    keep_g = keep[:, None]
    pk = (_per_pair(p, n_pairs) * keep_g).reshape(p.shape)
    dv = torch.einsum("gqk,gqd->gkd", pk, do)
    dpk = torch.einsum("gqd,gkd->gqk", do, v)
    dp = (_per_pair(dpk, n_pairs) * keep_g).reshape(p.shape)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("gqk,gkd->gqd", ds, k)
    dk = torch.einsum("gqk,gqd->gkd", ds, q)
    return dq, dk, dv


def _check(q, k, v, keep, n_pairs):
    dev = q.device
    if any(t.dtype != torch.float32 for t in (q, k, v, keep)):
        raise TypeError(f"fused_causal_attend takes float32 tensors, got "
                        f"{[str(t.dtype) for t in (q, k, v, keep)]}")
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"fused_causal_attend shapes: q, k, v (G, L, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    g, l, hd = q.shape
    if n_pairs < 1 or g % n_pairs or tuple(keep.shape) != (n_pairs, l, l):
        raise ValueError(f"fused_causal_attend: keep must be (n_pairs, L, L) with n_pairs "
                         f"dividing G={g}, got keep {tuple(keep.shape)}, n_pairs={n_pairs}")
    if not all(t.is_contiguous() for t in (q, k, v, keep)):
        raise ValueError("fused_causal_attend: q, k, v and keep must be contiguous")
    if l < 1:
        raise ValueError(f"fused_causal_attend: L={l} below 1")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"fused_causal_attend: head dim {hd} outside the kernels' "
                         f"[1, {MAX_HEAD_DIM}]")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_causal_attend takes CPU tensors (plain version) or CUDA tensors "
                         f"(kernel), got {dev}")
    if any(t.device != dev for t in (k, v, keep)):
        raise ValueError("fused_causal_attend: q, k, v and keep must be on one device")


def _stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def fused_causal_attend_fwd(q, k, v, keep, n_pairs: int):
    """One launch of the forward kernel (CUDA tensors only): returns the
    output (G, L, hd) and the rows' log-sum-exp lse (G, L), both float32,
    which the backward kernel takes."""
    _check(q, k, v, keep, n_pairs)
    if q.device.type != "cuda":
        raise ValueError(f"train_attention forward kernel needs CUDA tensors, got {q.device}")
    return _launch_fwd(q, k, v, keep, n_pairs)


def _launch_fwd(q, k, v, keep, n_pairs):
    global launches_fwd
    g, l, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((g, l), dtype=torch.float32, device=q.device)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(), out.data_ptr(),
            lse.data_ptr(), g, l, hd, n_pairs)
    if resident(l, hd):
        geo = _fwd_geometry(g, l, hd)
        err = _library().train_attention_fwd(*args, geo.groups, geo.tq, geo.threads,
                                             geo.smem_bytes, _stream(q.device))
    else:
        geo = _stream_geometry(g, l, hd, "fwd")
        err = _library().train_attention_fwd_stream(*args, geo.cols, geo.smem_bytes,
                                                    _stream(q.device))
    if err != 0:
        raise RuntimeError(f"train_attention forward kernel launch failed with CUDA error {err}")
    launches_fwd += 1
    return out, lse


def fused_causal_attend_bwd(q, k, v, keep, out, lse, do, n_pairs: int):
    """One launch of the backward kernel (CUDA tensors only), given the
    forward kernel's ``out`` and ``lse`` and the gradient ``do`` by out:
    returns (dq, dk, dv), each (G, L, hd) float32."""
    _check(q, k, v, keep, n_pairs)
    g, l, hd = q.shape
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"train_attention backward kernel needs CUDA tensors, got {dev}")
    for name, t, shape in (("out", out, q.shape), ("do", do, q.shape), ("lse", lse, (g, l))):
        if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != dev
                or not t.is_contiguous()):
            raise ValueError(f"train_attention backward kernel: {name} must be a contiguous "
                             f"float32 {tuple(shape)} tensor on {dev}")
    return _launch_bwd(q, k, v, keep, out, lse, do, n_pairs)


def _launch_bwd(q, k, v, keep, out, lse, do, n_pairs):
    global launches_bwd
    g, l, hd = q.shape
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(), out.data_ptr(),
            lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
    if resident(l, hd):
        geo = _bwd_geometry(g, l, hd)
        err = _library().train_attention_bwd(*args, g, l, hd, n_pairs, geo.groups, geo.tq,
                                             geo.threads, geo.nku, geo.smem_bytes,
                                             _stream(q.device))
    else:  # dQ, then dK and dV, with D_q = dO_q . out_q in a scratch between them
        dsum = torch.empty_like(lse)
        a, b = (_stream_geometry(g, l, hd, kind) for kind in ("dq", "dkv"))
        err = _library().train_attention_bwd_stream(
            *args, dsum.data_ptr(), g, l, hd, n_pairs, a.cols, a.smem_bytes, b.cols, b.smem_bytes,
            _stream(q.device))
    if err != 0:
        raise RuntimeError(f"train_attention backward kernel launch failed with CUDA error {err}")
    launches_bwd += 1
    return dq, dk, dv


class FusedCausalAttendFn(torch.autograd.Function):
    """Differentiable fused causal attention (the counterpart of the JAX
    custom VJP). On CUDA the forward kernel also returns the rows'
    log-sum-exp, which is saved with q, k, v, keep and the output for the
    backward kernel; on the CPU the plain backward recomputes everything."""

    @staticmethod
    def forward(ctx, q, k, v, keep, n_pairs):
        ctx.n_pairs = n_pairs
        if q.device.type == "cuda":
            out, lse = fused_causal_attend_fwd(q, k, v, keep, n_pairs)
            ctx.save_for_backward(q, k, v, keep, out, lse)
            return out
        _check(q, k, v, keep, n_pairs)  # raises for devices other than the CPU
        ctx.save_for_backward(q, k, v, keep)
        return fused_causal_attend_reference(q, k, v, keep, n_pairs)

    @staticmethod
    def backward(ctx, do):
        do = do.float().contiguous()
        if len(ctx.saved_tensors) == 4:
            q, k, v, keep = ctx.saved_tensors
            grads = fused_causal_attend_bwd_reference(q, k, v, keep, do, ctx.n_pairs)
        else:
            grads = fused_causal_attend_bwd(*ctx.saved_tensors, do, ctx.n_pairs)
        return (*grads, None, None)


def fused_causal_attend(q, k, v, keep, n_pairs: int):
    """Causal attention over merged groups, the (L, L) scores kept on chip.

    Args:
        q: (G, L, hd) float32 queries pre-scaled by 1/sqrt(hd); G is pair-major
            (pairs x batch x heads), so group g takes keep[g // (G // n_pairs)].
        k, v: (G, L, hd) float32.
        keep: (n_pairs, L, L) float32 pre-scaled dropout keep mask
            (keep / keep_prob), or a (1, L, L) all-ones tensor with
            ``n_pairs = 1`` without dropout. Not differentiable.
        n_pairs: pairs in G.
    Returns:
        (G, L, hd) float32 ``softmax(q k^T + causal) * keep @ v``,
        differentiable in q, k and v. A CPU tensor takes the plain versions; a
        CUDA tensor takes the kernels, or the call raises.
    """
    return FusedCausalAttendFn.apply(q, k, v, keep, n_pairs)
