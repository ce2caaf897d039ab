"""Masked GRU recurrence: the Hopper kernels' wrappers and their plain versions.

Counterpart of artspeech_tpu/ops/pallas_gru.py:gru_sequence (the fused Pallas
time loop, ``_gru_fwd_kernel`` and ``_gru_bwd_kernel`` wired by a custom VJP).
The kernels are ``csrc/gru_fwd.cu`` and ``csrc/gru_bwd.cu``;
:class:`GRUSequenceFn` wires them as a ``torch.autograd.Function``. Each
takes every H from 1 to ``MAX_HIDDEN``: a thread-block-cluster kernel with
W_h slices resident in shared memory where they fit (the thesis' H = 128), a
wide one that reads W_h through the L2 elsewhere. The forward's cluster
kernel is the step of ``csrc/rnn_fwd_step.cuh`` (shared with the LSTM's
forward), launched with the geometry of :func:`gru_launch_geometry`; the
backward's is the step of
``csrc/rnn_bwd_step.cuh`` (shared with the LSTM's backward), launched with
the geometry of :func:`rnn_bwd_launch_geometry`.

Also the counterpart of artspeech_tpu/ops/pallas_kernels.py:
gru_sequence_pallas, the batch-major one-direction forward that JAX keeps as
a measured reference: :func:`gru_sequence_batch_major` on ``csrc/gru_seq.cu``,
the same cluster step with batch-major addressing and the same geometry.
No model path calls it, in JAX or here.

- A CPU tensor takes the plain versions, :func:`gru_sequence_reference`,
  :func:`gru_sequence_backward_reference` and
  :func:`gru_sequence_batch_major_reference`.
- A CUDA tensor takes the kernels, or the call raises. Nothing falls back.

``launches`` counts forward kernel launches, ``bwd_launches`` backward ones
and ``launches_seq`` those of the batch-major kernel, so a run can show that
its GRUs went through the kernels.
"""

import ctypes
from typing import NamedTuple, Tuple

import torch

from artspeech_tpu_torch.ops import _build

#: Forward kernel launches so far (the plain version does not count).
launches = 0
#: Backward kernel launches so far (the plain version does not count).
bwd_launches = 0
#: Batch-major kernel launches so far (the plain version does not count).
launches_seq = 0

#: Widest hidden size the kernels take.
MAX_HIDDEN = 1024

#: The storage dtypes the recurrent kernels take, by their dtype code.
_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
#: Each kernel's entry point: (device pointers, ints), then the stream.
_POINTERS_INTS = {"gru_fwd": (5, 9), "gru_bwd": (12, 9), "gru_seq": (5, 6)}
_libs = {}


def _library(name):
    lib = _libs.get(name)
    if lib is None:
        lib = _build.load(name)
        pointers, ints = _POINTERS_INTS[name]
        entry = getattr(lib, name)
        entry.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * ints + [ctypes.c_void_p]
        entry.restype = ctypes.c_int
        _libs[name] = lib
    return lib


# -- the launch geometry of the forward kernels (csrc/rnn_fwd_step.cuh) -------

#: Threads that split k for one hidden unit (rnn_fwd_step.cuh's LANES).
LANES = 8
#: Threads a CTA of the cluster step at most.
MAX_THREADS = 512
#: Bytes of shared memory one Hopper block may use.
MAX_SMEM = 232448
#: Batch rows a cluster may walk (the cluster step's instances), fewest first.
CLUSTER_ROWS = (2, 4, 8)
#: Cluster sizes, largest first (8 is the portable limit).
CLUSTER_SIZES = (8, 4, 2, 1)
#: Batch rows a block of a wide instance walks (the forwards' and backwards' BT).
WIDE_ROWS = 4
#: Streaming multiprocessors of an H100 SXM.
H100_SMS = 132


class GRUGeometry(NamedTuple):
    """How the recurrent forward kernels launch at one shape (:func:`gru_launch_geometry`).

    The kernels are passed ``cluster``, ``rows`` and ``smem_bytes`` and lay
    out the same threads and grid from them; the other fields describe that
    launch for the tests and for ``chip_smoke.py``'s prints.
    """

    resident: bool      #: W_h slices in shared memory (the cluster step), else the wide instance
    cluster: int        #: CTAs a cluster (1: the wide instance's plain blocks)
    rows: int           #: batch rows a cluster (or a wide block) walks
    threads: int        #: threads a CTA
    grid: Tuple[int, int]  #: CTAs along the batch, directions
    ctas: int
    smem_bytes: int     #: dynamic shared memory a CTA
    waves: int          #: ceil(ctas / sm_count)


def cluster_smem_bytes(hidden, cluster, rows, gates, elem_bytes):
    """Shared memory of one CTA of the forward's cluster step
    (rnn_fwd_step.cuh:smem_bytes): its (HP, G*H/C) W_h slice in the storage
    type, 16-byte aligned, and two (rows, HP) f32 h buffers, HP = H rounded
    up to 32."""
    quad = 4 * LANES
    hp = -(-hidden // quad) * quad
    return -(-hp * gates * (hidden // cluster) * elem_bytes // 16) * 16 + 2 * rows * hp * 4


def gru_launch_geometry(batch, n_dir, hidden, gates, elem_bytes, sm_count=H100_SMS):
    """The launch of the recurrent forward kernels (gru_fwd.cu with
    ``gates`` = 3 and D = n_dir, gru_seq.cu with 3 and D = 1, lstm_fwd.cu
    with 4 and D = n_dir) for a shape, from the shape and the card alone.

    A cluster of C CTAs owns one direction and a tile of R batch rows; each
    CTA owns U = H/C hidden units and their G gate columns, with 8 threads a
    unit, each thread summing its share of k for all R rows. The candidates
    are R in 2, 4, 8 and C in 8, 4, 2, 1 with C dividing H, R <= 4C (never
    fewer CTAs than one 4-row block a tile), 8U <= 512 threads, and a CTA's
    W_h slice and h buffers within its shared memory. The rule takes the first candidate, fewest rows
    first and then the largest cluster, that puts ceil(B/R) * D * C <=
    ``sm_count`` CTAs on the step (one an SM, every cluster resident at
    once); where none does, the candidate with the fewest CTAs. Fewer rows a
    thread shortens its chain of FMAs; a larger cluster spreads a step over
    more SMs, and a smaller one packs the card when the batch is large.
    Without a candidate (W_h beyond a CTA's shared memory, or U > 64) the
    wide instance runs: 4-row blocks of 512 threads reading W_h through the
    L2, with the carries (the GRU's h; the LSTM's h and c) and the G gates of
    each row in shared memory.
    """
    candidates = [(rows, c) for rows in CLUSTER_ROWS for c in CLUSTER_SIZES
                  if hidden % c == 0 and rows <= 4 * c
                  and LANES * (hidden // c) <= MAX_THREADS
                  and cluster_smem_bytes(hidden, c, rows, gates, elem_bytes) <= MAX_SMEM]
    if not candidates:
        tiles = -(-batch // WIDE_ROWS)
        carries = 1 if gates == 3 else 2
        return GRUGeometry(False, 1, WIDE_ROWS, MAX_THREADS, (tiles, n_dir), tiles * n_dir,
                           WIDE_ROWS * (carries + gates) * hidden * 4,
                           -(-tiles * n_dir // sm_count))

    def ctas(rows, c):
        return -(-batch // rows) * n_dir * c

    rows, c = next(((r, c) for r, c in candidates if ctas(r, c) <= sm_count),
                   min(candidates, key=lambda rc: ctas(*rc)))
    return GRUGeometry(True, c, rows, LANES * (hidden // c), (c * -(-batch // rows), n_dir),
                       ctas(rows, c), cluster_smem_bytes(hidden, c, rows, gates, elem_bytes),
                       -(-ctas(rows, c) // sm_count))


# -- the launch geometry of the backward kernels (csrc/rnn_bwd_step.cuh) -------

#: Threads a CTA of the backward's cluster step (rnn_bwd_step.cuh's THREADS).
BWD_THREADS = 256
#: (step, row) pairs the backward's prologue and epilogue stage at once.
BWD_PRO_ROWS, BWD_EPI_ROWS = 64, 32
#: f32 values the backward's prologue keeps a (step, row, unit), by gate
#: count: the GRU's r, z, h_prev - n, 1 - n^2 and hg_n; the LSTM's i, f, g,
#: o, c_prev and tanh(c').
BWD_VALUES = {3: 5, 4: 6}
#: Shared memory of an H100 SM, and what the card keeps back of it a CTA.
SM_SMEM, CTA_RESERVED_SMEM = 233472, 1024


class RNNBwdGeometry(NamedTuple):
    """How the backward kernels launch at one shape (:func:`rnn_bwd_launch_geometry`).

    The kernels are passed ``cluster``, ``rows`` and ``smem_bytes``; the
    wrappers size the scratch and the per-tile partials from ``tiles`` and
    ``scratch_per_step``; the other fields describe the launch.
    """

    resident: bool      #: W_h slices in shared memory (the cluster step), else the wide instance
    cluster: int        #: CTAs a cluster (1: the wide instance's plain blocks)
    rows: int           #: batch rows a cluster (or a wide block) walks
    threads: int        #: threads a CTA
    grid: Tuple[int, int]  #: CTAs along the batch, directions
    ctas: int
    smem_bytes: int     #: dynamic shared memory a CTA
    ctas_per_sm: int    #: CTAs an SM holds at once (2 where two CTAs' shared memory fits)
    waves: int          #: ceil(ctas / (sm_count * ctas_per_sm))
    tiles: int          #: batch tiles a direction: the partial sums of dW_h and db_h
    scratch_per_step: int  #: f32 scratch values a time step


def bwd_cluster_smem_bytes(hidden, cluster, rows, gates, elem_bytes):
    """Shared memory of one CTA of the backward's cluster step
    (rnn_bwd_step.cuh:smem_bytes): its (HK, cols) W_h slice in the storage
    type, 16-byte aligned (HK = H rounded up to 8; cols = G columns for each
    of the U = H/C units rounded up to 4, rounded up to 8), then in f32 two
    (rows, H) carry buffers, two (rows, cols) dgates buffers and the stage:
    the prologue's (HK, 68) h_prev^T or the epilogue's (32, HK + 4 + cols),
    the larger."""
    units = hidden // cluster
    cols = -(-4 * -(-units // 4) * gates // 8) * 8
    hk = -(-hidden // 8) * 8
    stage = max(hk * (BWD_PRO_ROWS + 4), BWD_EPI_ROWS * (hk + 4 + cols))
    return -(-hk * cols * elem_bytes // 16) * 16 + 4 * (2 * rows * hidden + 2 * rows * cols + stage)


def _ctas_per_sm(smem_bytes):
    """CTAs of the backward's cluster step an SM holds at once: two (256
    threads of at most 128 registers each) where two CTAs' shared memory
    fits, else one."""
    return 2 if 2 * (smem_bytes + CTA_RESERVED_SMEM) <= SM_SMEM else 1


def rnn_bwd_launch_geometry(batch, n_dir, hidden, gates, elem_bytes, sm_count=H100_SMS):
    """The launch of the recurrent backward kernels (gru_bwd.cu with
    ``gates`` = 3, lstm_bwd.cu with 4) for a shape, from the shape and the
    card alone; the kernels derive nothing else.

    A cluster of C CTAs owns one direction and a tile of R batch rows; each
    CTA of 256 threads owns U = H/C hidden units and their G gate columns,
    with one thread a (row, unit) for the cell and one a k of H for the dh
    product. The rule is :func:`gru_launch_geometry`'s: R in 2, 4, 8 and C
    in 8, 4, 2, 1 with C dividing H, H <= 256, R * U <= 256 and a CTA's W_h
    slice, buffers and stage within its shared memory; the first candidate, fewest rows first and then the
    largest cluster, whose ceil(B/R) * D * C CTAs are all resident at once
    (``sm_count`` SMs, two CTAs an SM where their shared memory fits); where
    none is, the candidate with the fewest CTAs. Without a candidate the
    wide instance runs: 4-row blocks of 512 threads reading W_h through the
    L2.

    ``tiles`` (ceil(B/R)) sizes the per-tile partials of dW_h and db_h,
    ``scratch_per_step`` the f32 scratch: the cluster step's V values a
    (step, row, unit) of every tile's rows, D * tiles * R * V * H a step;
    the wide instance's rounded dgates, D * B * G * H a step.
    """
    candidates = [(rows, c) for rows in CLUSTER_ROWS for c in CLUSTER_SIZES
                  if hidden % c == 0 and hidden <= BWD_THREADS
                  and rows * (hidden // c) <= BWD_THREADS
                  and bwd_cluster_smem_bytes(hidden, c, rows, gates, elem_bytes) <= MAX_SMEM]
    if not candidates:
        tiles = -(-batch // WIDE_ROWS)
        smem = max(4 * (WIDE_ROWS * 3 * gates * hidden + gates * hidden), 256 * 32 * 4)
        return RNNBwdGeometry(False, 1, WIDE_ROWS, MAX_THREADS, (tiles, n_dir), tiles * n_dir,
                              smem, 1, -(-tiles * n_dir // sm_count), tiles,
                              n_dir * batch * gates * hidden)

    def ctas(rows, c):
        return -(-batch // rows) * n_dir * c

    def per_sm(rows, c):
        return _ctas_per_sm(bwd_cluster_smem_bytes(hidden, c, rows, gates, elem_bytes))

    rows, c = next(((r, c) for r, c in candidates if ctas(r, c) <= sm_count * per_sm(r, c)),
                   min(candidates, key=lambda rc: ctas(*rc)))
    tiles = -(-batch // rows)
    return RNNBwdGeometry(True, c, rows, BWD_THREADS, (c * tiles, n_dir), ctas(rows, c),
                          bwd_cluster_smem_bytes(hidden, c, rows, gates, elem_bytes),
                          per_sm(rows, c), -(-ctas(rows, c) // (sm_count * per_sm(rows, c))),
                          tiles, n_dir * tiles * rows * BWD_VALUES[gates] * hidden)


def bwd_launch_buffers(x_proj, n_dir, hidden, gates):
    """A backward launch on x_proj's card: its geometry, the f32 scratch and
    the f32 per-tile partials of dW_h (D, tiles, H, G*H) and db_h
    (D, tiles, G*H) that it needs."""
    n_steps, batch, _ = x_proj.shape
    dev = x_proj.device
    geometry = rnn_bwd_launch_geometry(batch, n_dir, hidden, gates, x_proj.element_size(),
                                       _sm_count(dev))
    f32 = dict(dtype=torch.float32, device=dev)
    return (geometry, torch.empty(n_steps * geometry.scratch_per_step, **f32),
            torch.empty(n_dir, geometry.tiles, hidden, gates * hidden, **f32),
            torch.empty(n_dir, geometry.tiles, gates * hidden, **f32))


def geometry_args(geometry):
    """The geometry as the kernels' entry points take it (cluster 0: wide)."""
    return geometry.cluster if geometry.resident else 0, geometry.rows, geometry.smem_bytes


def _sm_count(device):
    return torch.cuda.get_device_properties(device).multi_processor_count


def gru_sequence_reference(x_proj, w_h, b_h, mask, reverse=False):
    """Plain PyTorch masked GRU over hoisted projections (a loop over T).

    Args:
        x_proj: (T, B, 3H) f32, bf16 or f16 — ``x @ W_i + b_i`` for every step.
        w_h: (H, 3H) recurrent weights; b_h: (3H,) recurrent bias.
        mask: (T, B); nonzero on valid steps, where the carry updates.
        reverse: walk time backward; outputs stay at their own time index.
    Returns:
        (T, B, H) in x_proj's dtype. Gate math and the product's accumulation
        are f32; the carry is rounded to x_proj's dtype after every step.
    """
    n_steps, batch, gates = x_proj.shape
    hidden = gates // 3
    dtype = x_proj.dtype
    w = w_h.float()
    b = b_h.float()
    valid = mask != 0
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=x_proj.device)
    ys = []
    for s in range(n_steps):
        t = n_steps - 1 - s if reverse else s
        hg = h @ w + b
        xg = x_proj[t].float()
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
        cand = (1.0 - z) * n + z * h
        out = torch.where(valid[t][:, None], cand, h).to(dtype)
        ys.append(out)
        h = out.float()
    if reverse:
        ys.reverse()
    if not ys:
        return x_proj.new_zeros(0, batch, hidden)
    return torch.stack(ys)


def gru_sequence_backward_reference(x_proj, w_h, b_h, mask, ys, g, reverse=False):
    """Plain PyTorch backward of :func:`gru_sequence_reference` (a loop over T).

    Mirrors ``_gru_bwd_kernel`` step by step, in reverse traversal order: the
    gates are recomputed in f32 from the carry before each step (``ys`` at
    the previous traversal step, zero at the first), dL/dh is carried in f32,
    the gradient of ``h @ W_h + b_h`` is rounded to x_proj's dtype before the
    two products, and ``dW_h``/``db_h`` accumulate in f32.

    Args:
        x_proj, w_h, b_h, mask, reverse: as in :func:`gru_sequence_reference`.
        ys: (T, B, H) its output; g: (T, B, H) the gradient of the loss by ys.
    Returns:
        (dx_proj (T, B, 3H) in x_proj's dtype, dW_h (H, 3H) f32, db_h (3H,) f32).
        The mask gets no gradient.
    """
    n_steps, batch, gates = x_proj.shape
    hidden = gates // 3
    dtype = x_proj.dtype
    w = w_h.float()
    b = b_h.float()
    m_all = (mask != 0).float()
    dh = torch.zeros(batch, hidden, dtype=torch.float32, device=x_proj.device)
    dw = torch.zeros(hidden, gates, dtype=torch.float32, device=x_proj.device)
    db = torch.zeros(gates, dtype=torch.float32, device=x_proj.device)
    dxp = torch.empty_like(x_proj)
    for s in reversed(range(n_steps)):
        t = n_steps - 1 - s if reverse else s
        if s == 0:
            h_prev = torch.zeros(batch, hidden, dtype=torch.float32, device=x_proj.device)
        else:
            h_prev = ys[t + 1 if reverse else t - 1].float()
        hg = h_prev @ w + b
        xg = x_proj[t].float()
        hn = hg[:, 2 * hidden:]
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hn)
        m = m_all[t][:, None]
        dh_tot = g[t].float() + dh
        dcand = m * dh_tot
        dz = dcand * (h_prev - n)
        dn = dcand * (1.0 - z)
        dn_pre = dn * (1.0 - n * n)
        dr = dn_pre * hn
        dz_pre = dz * z * (1.0 - z)
        dr_pre = dr * r * (1.0 - r)
        dhg = torch.cat([dr_pre, dz_pre, dn_pre * r], dim=-1)
        dhg_c = dhg.to(dtype).float()
        dh = (1.0 - m) * dh_tot + dcand * z + dhg_c @ w.T
        dw += h_prev.T @ dhg_c
        db += dhg.sum(dim=0)
        dxp[t] = torch.cat([dr_pre, dz_pre, dn_pre], dim=-1).to(dtype)
    return dxp, dw, db


def _check(x_proj, w_h, b_h, mask, n_dir, gates=3, name="gru"):
    """Raises for what the recurrent kernels do not take: x_proj (T, B, D*gH),
    w_h (D, H, gH) and b_h (D, gH) of one storage type in ``_DTYPES``, on one
    card and contiguous, a mask (T, B) there, and 1 <= H <= ``MAX_HIDDEN``.
    ``gates`` is g (3 for the GRU; hopper_lstm binds 4) and ``name`` ("gru"
    or "lstm") begins each message."""
    if x_proj.dtype not in _DTYPES:
        raise ValueError(f"{name} kernel takes float32, bfloat16 or float16, got {x_proj.dtype}")
    if x_proj.dim() != 3 or w_h.dim() != 3 or b_h.dim() != 2 or mask.dim() != 2:
        raise ValueError(f"{name} kernel shapes: x_proj (T,B,D*{gates}H), w_h (D,H,{gates}H), "
                         f"b_h (D,{gates}H), mask (T,B)")
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    width = gates * hidden
    if (tuple(x_proj.shape) != (n_steps, batch, n_dir * width)
            or tuple(w_h.shape) != (n_dir, hidden, width)
            or tuple(b_h.shape) != (n_dir, width)
            or tuple(mask.shape) != (n_steps, batch)):
        raise ValueError(
            f"{name} kernel shape mismatch: x_proj {tuple(x_proj.shape)}, w_h {tuple(w_h.shape)}, "
            f"b_h {tuple(b_h.shape)}, mask {tuple(mask.shape)}")
    for arg, t in (("x_proj", x_proj), ("w_h", w_h), ("b_h", b_h)):
        if t.dtype != x_proj.dtype or t.device != x_proj.device:
            raise ValueError(f"{name} kernel: {arg} must match x_proj's dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"{name} kernel: {arg} must be contiguous")
    if mask.device != x_proj.device:
        raise ValueError(f"{name} kernel: mask must be on x_proj's device")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"{name} kernel takes 1 <= H <= {MAX_HIDDEN}, got H={hidden}")
    if x_proj.device.type != "cuda":
        raise ValueError(f"{name} kernel needs CUDA tensors, got {x_proj.device}")


def resident(name, hidden, dtype):
    """Whether kernel ``name`` ("gru_fwd" or "gru_bwd") runs H in ``dtype``
    with W_h slices resident in shared memory (else its wide instance): the
    answer of :func:`gru_launch_geometry` or :func:`rnn_bwd_launch_geometry`,
    which needs no card."""
    elem = torch.empty(0, dtype=dtype).element_size()
    if name == "gru_fwd":
        return gru_launch_geometry(1, 1, hidden, 3, elem).resident
    return rnn_bwd_launch_geometry(1, 1, hidden, 3, elem).resident


def _launch(x_proj, w_h, b_h, mask, n_dir, rev_bits):
    global launches
    _check(x_proj, w_h, b_h, mask, n_dir)
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    mask_f = mask.to(torch.float32).contiguous()
    ys = torch.empty(n_steps, batch, n_dir * hidden, dtype=x_proj.dtype, device=x_proj.device)
    if n_steps == 0 or batch == 0:
        return ys
    geometry = gru_launch_geometry(batch, n_dir, hidden, 3, x_proj.element_size(),
                                   _sm_count(x_proj.device))
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("gru_fwd").gru_fwd(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(),
            ys.data_ptr(), n_steps, batch, hidden, n_dir, rev_bits,
            _DTYPES[x_proj.dtype], *geometry_args(geometry), stream)
    if err != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return ys


def _launch_bwd(x_proj, w_h, b_h, mask, ys, g, n_dir, rev_bits):
    global bwd_launches
    _check(x_proj, w_h, b_h, mask, n_dir)
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    gates = 3 * hidden
    for arg, t in (("ys", ys), ("g", g)):
        if tuple(t.shape) != (n_steps, batch, n_dir * hidden):
            raise ValueError(f"gru_bwd kernel: {arg} must be (T, B, D*H), got {tuple(t.shape)}")
        if t.dtype != x_proj.dtype or t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"gru_bwd kernel: {arg} must be contiguous, x_proj's dtype and device")
    dev = x_proj.device
    dw = torch.zeros(n_dir, hidden, gates, dtype=torch.float32, device=dev)
    db = torch.zeros(n_dir, gates, dtype=torch.float32, device=dev)
    if n_steps == 0 or batch == 0:
        return torch.zeros_like(x_proj), dw, db
    geometry, scratch, dw_part, db_part = bwd_launch_buffers(x_proj, n_dir, hidden, 3)
    mask_f = mask.to(torch.float32).contiguous()
    dxp = torch.empty_like(x_proj)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("gru_bwd").gru_bwd(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(), ys.data_ptr(),
            g.data_ptr(), dxp.data_ptr(), scratch.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dw.data_ptr(), db.data_ptr(), n_steps, batch, hidden, n_dir,
            rev_bits, _DTYPES[x_proj.dtype], *geometry_args(geometry), stream)
    if err != 0:
        raise RuntimeError(f"gru_bwd kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return dxp, dw, db


def _directions(n_dir, rev_bits):
    return [bool((rev_bits >> d) & 1) for d in range(n_dir)]


def gru_forward_reference(x_proj, w_h, b_h, mask, rev_bits):
    """:func:`gru_sequence_reference` for each of D directions, in the
    kernels' layout: x_proj (T, B, D*3H), w_h (D, H, 3H), b_h (D, 3H) ->
    (T, B, D*H); direction d walks time backward iff bit d of ``rev_bits``."""
    gates = w_h.shape[-1]
    return torch.cat([
        gru_sequence_reference(x_proj[..., d * gates:(d + 1) * gates], w_h[d], b_h[d], mask, rev)
        for d, rev in enumerate(_directions(w_h.shape[0], rev_bits))
    ], dim=-1)


def gru_backward_reference(x_proj, w_h, b_h, mask, ys, g, rev_bits):
    """:func:`gru_sequence_backward_reference` for each of D directions, in
    the kernels' layout: (dx_proj, dW_h (D, H, 3H) f32, db_h (D, 3H) f32)."""
    gates, hidden = w_h.shape[-1], w_h.shape[1]
    parts = [
        gru_sequence_backward_reference(
            x_proj[..., d * gates:(d + 1) * gates], w_h[d], b_h[d], mask,
            ys[..., d * hidden:(d + 1) * hidden], g[..., d * hidden:(d + 1) * hidden], rev)
        for d, rev in enumerate(_directions(w_h.shape[0], rev_bits))
    ]
    return (torch.cat([p[0] for p in parts], dim=-1), torch.stack([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]))


def gru_forward(x_proj, w_h, b_h, mask, rev_bits):
    """D directions of the recurrence (layout of :func:`gru_forward_reference`).
    CPU: the plain version; CUDA: one launch of the forward kernel."""
    if x_proj.device.type == "cpu":
        return gru_forward_reference(x_proj, w_h, b_h, mask, rev_bits)
    return _launch(x_proj, w_h, b_h, mask, w_h.shape[0], rev_bits)


def gru_backward(x_proj, w_h, b_h, mask, ys, g, rev_bits):
    """Backward of :func:`gru_forward` given its output ``ys`` and the
    gradient ``g`` by ys: (dx_proj, dW_h (D, H, 3H) f32, db_h (D, 3H) f32).
    CPU: the plain version; CUDA: one launch of the backward kernel."""
    if x_proj.device.type == "cpu":
        return gru_backward_reference(x_proj, w_h, b_h, mask, ys, g, rev_bits)
    return _launch_bwd(x_proj, w_h, b_h, mask, ys, g, w_h.shape[0], rev_bits)


class GRUSequenceFn(torch.autograd.Function):
    """Differentiable :func:`gru_forward`, its backward :func:`gru_backward`
    (the counterpart of the JAX custom VJP). Saves x_proj, w_h, b_h, mask and
    ys; the backward recomputes the gates from ys."""

    @staticmethod
    def forward(ctx, x_proj, w_h, b_h, mask, rev_bits):
        ys = gru_forward(x_proj, w_h, b_h, mask, rev_bits)
        ctx.save_for_backward(x_proj, w_h, b_h, mask, ys)
        ctx.rev_bits = rev_bits
        return ys

    @staticmethod
    def backward(ctx, g):
        x_proj, w_h, b_h, mask, ys = ctx.saved_tensors
        g = g.to(ys.dtype).contiguous()
        dxp, dw, db = gru_backward(x_proj, w_h, b_h, mask, ys, g, ctx.rev_bits)
        return dxp, dw.to(w_h.dtype), db.to(b_h.dtype), None, None


def gru_sequence(x_proj, w_h, b_h, mask, reverse=False):
    """Masked GRU recurrence over hoisted input projections, time-major.

    Args:
        x_proj: (T, B, 3H); w_h: (H, 3H); b_h: (3H,); mask: (T, B), nonzero on
            valid steps; reverse: walk time backward (outputs in forward order).
    Returns:
        (T, B, H), differentiable in x_proj, w_h and b_h. A CPU tensor takes
        the plain versions; a CUDA tensor takes the kernels, or the call raises.
    """
    return GRUSequenceFn.apply(x_proj, w_h[None], b_h[None], mask, int(bool(reverse)))


def bigru_sequence(x_proj, w_h, b_h, mask):
    """Both directions of a bidirectional layer in one kernel launch.

    Args:
        x_proj: (T, B, 2*3H) — forward gates, then backward gates.
        w_h: (2, H, 3H); b_h: (2, 3H); mask: (T, B).
    Returns:
        (T, B, 2H): the forward direction's states, then the backward one's.
    """
    return GRUSequenceFn.apply(x_proj, w_h, b_h, mask, 0b10)


# -- the batch-major recurrence (pallas_kernels.py:gru_sequence_pallas) -------

def gru_sequence_batch_major_reference(x_proj, w_h, b_h, mask):
    """Plain PyTorch batch-major masked GRU, one direction, f32 (a loop over T).

    The TPU kernel's step (JAX pallas_kernels.py:_gru_seq_kernel): the carry
    starts at zero and updates as ``m * h_new + (1 - m) * h``.

    Args:
        x_proj: (B, T, 3H) hoisted input projections; w_h: (H, 3H); b_h: (3H,);
        mask: (B, T), nonzero on valid steps.
    Returns:
        (B, T, H) float32.
    """
    batch, n_steps, gates = x_proj.shape
    hidden = gates // 3
    x_proj, w, b = x_proj.float(), w_h.float(), b_h.float()
    m_all = (mask != 0).float()
    h = torch.zeros(batch, hidden, dtype=torch.float32, device=x_proj.device)
    out = torch.empty(batch, n_steps, hidden, dtype=torch.float32, device=x_proj.device)
    for t in range(n_steps):
        hg = h @ w + b
        xg = x_proj[:, t]
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
        m = m_all[:, t, None]
        h = m * ((1.0 - z) * n + z * h) + (1.0 - m) * h
        out[:, t] = h
    return out


def batch_major_resident(hidden):
    """Whether the batch-major kernel keeps W_h resident in shared memory at
    this width (else it reads W_h through the L2 every step): the answer of
    :func:`gru_launch_geometry`, the same as the forward kernel's with one
    direction in f32. The batch tile does not change it."""
    return gru_launch_geometry(1, 1, hidden, 3, 4).resident


def _launch_seq(x_proj, w_h, b_h, mask):
    global launches_seq
    batch, n_steps, gates = x_proj.shape
    hidden = gates // 3
    for arg, t in (("x_proj", x_proj), ("w_h", w_h), ("b_h", b_h)):
        if t.device != x_proj.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"gru_seq kernel: {arg} must be a contiguous float32 tensor on "
                             f"{x_proj.device}")
    if mask.device != x_proj.device:
        raise ValueError("gru_seq kernel: mask must be on x_proj's device")
    out = torch.empty(batch, n_steps, hidden, dtype=torch.float32, device=x_proj.device)
    if batch == 0 or n_steps == 0:
        return out
    mask_f = mask.to(torch.float32).contiguous()
    geometry = gru_launch_geometry(batch, 1, hidden, 3, 4, _sm_count(x_proj.device))
    with torch.cuda.device(x_proj.device):
        err = _library("gru_seq").gru_seq(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(), out.data_ptr(),
            batch, n_steps, hidden, *geometry_args(geometry),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"gru_seq kernel launch failed with CUDA error {err}")
    launches_seq += 1
    return out


def gru_sequence_batch_major(x_proj, w_h, b_h, mask, batch_tile: int = 16):
    """Masked GRU recurrence, one direction, forward only, batch-major: the
    counterpart of JAX ``gru_sequence_pallas``.

    Args:
        x_proj: (B, T, 3H) hoisted input projections (x @ w_i + b_i).
        w_h: (H, 3H); b_h: (3H,); mask: (B, T), nonzero (True) on valid
            steps. x_proj, w_h and b_h are cast to float32, as JAX casts them.
        batch_tile: the TPU kernel's batch tile (16 by default), any tile
            >= 1, as JAX's API takes it (JAX pads the batch to a multiple of
            it). It does not change the result. On the card the launch
            geometry comes from :func:`gru_launch_geometry` (the TPU's tiles
            do not carry over), not from this tile.
    Returns:
        (B, T, H) float32 hidden states; at padded steps they repeat the last
        valid one. A CPU tensor takes
        :func:`gru_sequence_batch_major_reference`; a CUDA tensor takes the
        kernel, or the call raises. Not differentiable, like the TPU kernel.
    """
    if x_proj.dim() != 3 or x_proj.shape[-1] % 3:
        raise ValueError(f"gru_sequence_batch_major: x_proj must be (B, T, 3H), got "
                         f"{tuple(x_proj.shape)}")
    batch, n_steps, gates = x_proj.shape
    hidden = gates // 3
    if (tuple(w_h.shape) != (hidden, gates) or tuple(b_h.shape) != (gates,)
            or tuple(mask.shape) != (batch, n_steps)):
        raise ValueError(f"gru_sequence_batch_major shapes: w_h (H, 3H), b_h (3H,), mask (B, T); "
                         f"got {tuple(w_h.shape)}, {tuple(b_h.shape)}, {tuple(mask.shape)} for "
                         f"x_proj {tuple(x_proj.shape)}")
    if not 1 <= hidden <= MAX_HIDDEN:
        raise ValueError(f"gru_sequence_batch_major takes 1 <= H <= {MAX_HIDDEN}, got H={hidden}")
    if batch_tile < 1:
        raise ValueError(f"gru_sequence_batch_major: batch_tile must be >= 1, got {batch_tile}")
    x_proj, w_h, b_h = x_proj.float(), w_h.float(), b_h.float()
    if x_proj.device.type == "cpu":
        return gru_sequence_batch_major_reference(x_proj, w_h, b_h, mask)
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru_seq kernel needs CUDA tensors, got {x_proj.device}")
    return _launch_seq(x_proj, w_h, b_h, mask)
