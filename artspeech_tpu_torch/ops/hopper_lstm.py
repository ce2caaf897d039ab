"""Masked LSTM recurrence: the Hopper kernels' wrappers and their plain versions.

Counterpart of artspeech_tpu/ops/pallas_gru.py:lstm_sequence (the fused
Pallas time loop, ``_lstm_fwd_kernel`` and ``_lstm_bwd_kernel`` wired by a
custom VJP). The kernels are ``csrc/lstm_fwd.cu`` and ``csrc/lstm_bwd.cu``;
:class:`LSTMSequenceFn` wires them as a ``torch.autograd.Function``. Each
takes every H from 1 to ``MAX_HIDDEN``: a thread-block-cluster kernel with
W_h slices resident in shared memory where they fit (the latent RNN's
H = 128, and up to H = 256), a wide one that reads W_h through the L2
elsewhere. The forward's is the cluster step of ``csrc/rnn_fwd_step.cuh``
(shared with the GRU's forwards) with a four-gate cell, launched with the
geometry of ``hopper_gru.gru_launch_geometry``; the backward's is the
cluster step of ``csrc/rnn_bwd_step.cuh`` (shared with the GRU's backward),
launched with the geometry of ``hopper_gru.rnn_bwd_launch_geometry``.

- A CPU tensor takes the plain versions, :func:`lstm_sequence_reference` and
  :func:`lstm_sequence_backward_reference`.
- A CUDA tensor takes the kernels, or the call raises. Nothing falls back.

Gate order i, f, g, o; gate math and the product's accumulation in f32; the
h and c carries freeze on padded steps and are rounded to the storage dtype
after every step. The forward also returns the cell state after every step
when autograd will need it for the backward. ``launches`` counts forward
kernel launches and ``bwd_launches`` backward ones.
"""

import ctypes
import functools

import torch

from artspeech_tpu_torch.ops import _build, hopper_gru

#: Forward kernel launches so far (the plain version does not count).
launches = 0
#: Backward kernel launches so far (the plain version does not count).
bwd_launches = 0

#: Widest hidden size the kernels take (the recurrences' one bound).
MAX_HIDDEN = hopper_gru.MAX_HIDDEN
#: The recurrences' one argument check, at four gates.
_check = functools.partial(hopper_gru._check, gates=4, name="lstm")

#: Each kernel's entry point: (device pointers, ints), then the stream.
_POINTERS_INTS = {"lstm_fwd": (6, 9), "lstm_bwd": (13, 9)}
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


def _acc(dtype):
    """The plain versions' compute type: f32 for f32, bf16 and f16 storage (as the
    kernels), f64 for f64 inputs (so the tests can take exact gradients)."""
    return torch.promote_types(dtype, torch.float32)


def _cell(gates, c, hidden):
    """(i, f, g, o, c') of one step from the pre-activations (B, 4H) and the
    cell state before it, in the compute type."""
    i = torch.sigmoid(gates[:, :hidden])
    f = torch.sigmoid(gates[:, hidden:2 * hidden])
    g = torch.tanh(gates[:, 2 * hidden:3 * hidden])
    o = torch.sigmoid(gates[:, 3 * hidden:])
    return i, f, g, o, f * c + i * g


def lstm_sequence_reference(x_proj, w_h, b_h, mask, reverse=False, return_cells=False):
    """Plain PyTorch masked LSTM over hoisted projections (a loop over T).

    Args:
        x_proj: (T, B, 4H) f32, bf16 or f16 — ``x @ W_i + b_i`` for every step,
            gate blocks i, f, g, o.
        w_h: (H, 4H) recurrent weights; b_h: (4H,) recurrent bias.
        mask: (T, B); nonzero on valid steps, where the carries update.
        reverse: walk time backward; outputs stay at their own time index.
        return_cells: also return the cell state after every step.
    Returns:
        ys (T, B, H) in x_proj's dtype, and with ``return_cells`` the cell
        states cs (T, B, H) as well. Gate math and the product's
        accumulation are f32; h and c are rounded to x_proj's dtype after
        every step (f64 inputs compute in f64).
    """
    n_steps, batch, gates = x_proj.shape
    hidden = gates // 4
    dtype = x_proj.dtype
    acc = _acc(dtype)
    w = w_h.to(acc)
    b = b_h.to(acc)
    valid = mask != 0
    h = torch.zeros(batch, hidden, dtype=acc, device=x_proj.device)
    c = torch.zeros_like(h)
    ys, cs = [], []
    for s in range(n_steps):
        t = n_steps - 1 - s if reverse else s
        _, _, _, o, c_new = _cell(h @ w + b + x_proj[t].to(acc), c, hidden)
        keep = valid[t][:, None]
        h_out = torch.where(keep, o * torch.tanh(c_new), h).to(dtype)
        c_out = torch.where(keep, c_new, c).to(dtype)
        ys.append(h_out)
        cs.append(c_out)
        h, c = h_out.to(acc), c_out.to(acc)
    if reverse:
        ys.reverse()
        cs.reverse()
    empty = x_proj.new_zeros(0, batch, hidden)
    ys = torch.stack(ys) if ys else empty
    if return_cells:
        return ys, (torch.stack(cs) if cs else empty)
    return ys


def lstm_sequence_backward_reference(x_proj, w_h, b_h, mask, ys, cs, g, reverse=False):
    """Plain PyTorch backward of :func:`lstm_sequence_reference` (a loop over T).

    Mirrors ``_lstm_bwd_kernel`` step by step, in reverse traversal order:
    the gates are recomputed in f32 from the carries before each step (``ys``
    and ``cs`` at the previous traversal step, zero at the first), dL/dh and
    dL/dc are carried in f32, the gradient of the gate pre-activations is
    rounded to x_proj's dtype before the two products, and ``dW_h``/``db_h``
    accumulate in f32.

    Args:
        x_proj, w_h, b_h, mask, reverse: as in :func:`lstm_sequence_reference`.
        ys, cs: (T, B, H) its outputs and cell states; g: (T, B, H) the
            gradient of the loss by ys.
    Returns:
        (dx_proj (T, B, 4H) in x_proj's dtype, dW_h (H, 4H) f32, db_h (4H,) f32;
        f64 for f64 inputs). The mask gets no gradient.
    """
    n_steps, batch, gates = x_proj.shape
    hidden = gates // 4
    dtype = x_proj.dtype
    dev = x_proj.device
    acc = _acc(dtype)
    w = w_h.to(acc)
    b = b_h.to(acc)
    m_all = (mask != 0).to(acc)
    dh = torch.zeros(batch, hidden, dtype=acc, device=dev)
    dc = torch.zeros_like(dh)
    dw = torch.zeros(hidden, gates, dtype=acc, device=dev)
    db = torch.zeros(gates, dtype=acc, device=dev)
    dxp = torch.empty_like(x_proj)
    for s in reversed(range(n_steps)):
        t = n_steps - 1 - s if reverse else s
        if s == 0:
            h_prev = torch.zeros(batch, hidden, dtype=acc, device=dev)
            c_prev = torch.zeros_like(h_prev)
        else:
            t_prev = t + 1 if reverse else t - 1
            h_prev, c_prev = ys[t_prev].to(acc), cs[t_prev].to(acc)
        i, f, gg, o, c_new = _cell(h_prev @ w + b + x_proj[t].to(acc), c_prev, hidden)
        th = torch.tanh(c_new)
        m = m_all[t][:, None]
        dh_tot = g[t].to(acc) + dh
        dh_c = m * dh_tot
        dc_c = m * dc
        d_o = dh_c * th
        dc_c = dc_c + dh_c * o * (1.0 - th * th)
        dc = (1.0 - m) * dc + dc_c * f
        dgates = torch.cat([dc_c * gg * i * (1.0 - i), dc_c * c_prev * f * (1.0 - f),
                            dc_c * i * (1.0 - gg * gg), d_o * o * (1.0 - o)], dim=-1)
        dgates_c = dgates.to(dtype)
        dh = (1.0 - m) * dh_tot + dgates_c.to(acc) @ w.T
        dw += h_prev.T @ dgates_c.to(acc)
        db += dgates.sum(dim=0)
        dxp[t] = dgates_c
    return dxp, dw, db


def resident(name, hidden, dtype):
    """Whether kernel ``name`` ("lstm_fwd" or "lstm_bwd") runs H in ``dtype``
    as the cluster kernel with W_h slices in shared memory (else its wide
    instance): the answer of ``hopper_gru.gru_launch_geometry`` or
    ``hopper_gru.rnn_bwd_launch_geometry`` with 4 gates, which needs no card."""
    elem = torch.empty(0, dtype=dtype).element_size()
    if name == "lstm_fwd":
        return hopper_gru.gru_launch_geometry(1, 1, hidden, 4, elem).resident
    return hopper_gru.rnn_bwd_launch_geometry(1, 1, hidden, 4, elem).resident


def _launch(x_proj, w_h, b_h, mask, n_dir, rev_bits, with_cells):
    global launches
    _check(x_proj, w_h, b_h, mask, n_dir)
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    mask_f = mask.to(torch.float32).contiguous()
    ys = torch.empty(n_steps, batch, n_dir * hidden, dtype=x_proj.dtype, device=x_proj.device)
    cs = torch.empty_like(ys) if with_cells else None
    if n_steps == 0 or batch == 0:
        return ys, cs
    geometry = hopper_gru.gru_launch_geometry(batch, n_dir, hidden, 4, x_proj.element_size(),
                                              hopper_gru._sm_count(x_proj.device))
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("lstm_fwd").lstm_fwd(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(),
            ys.data_ptr(), None if cs is None else cs.data_ptr(), n_steps, batch, hidden, n_dir,
            rev_bits, hopper_gru._DTYPES[x_proj.dtype], *hopper_gru.geometry_args(geometry),
            stream)
    if err != 0:
        raise RuntimeError(f"lstm_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return ys, cs


def _launch_bwd(x_proj, w_h, b_h, mask, ys, cs, g, n_dir, rev_bits):
    global bwd_launches
    _check(x_proj, w_h, b_h, mask, n_dir)
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    gates = 4 * hidden
    for arg, t in (("ys", ys), ("cs", cs), ("g", g)):
        if tuple(t.shape) != (n_steps, batch, n_dir * hidden):
            raise ValueError(f"lstm_bwd kernel: {arg} must be (T, B, D*H), got {tuple(t.shape)}")
        if t.dtype != x_proj.dtype or t.device != x_proj.device or not t.is_contiguous():
            raise ValueError(f"lstm_bwd kernel: {arg} must be contiguous, x_proj's dtype and device")
    dev = x_proj.device
    dw = torch.zeros(n_dir, hidden, gates, dtype=torch.float32, device=dev)
    db = torch.zeros(n_dir, gates, dtype=torch.float32, device=dev)
    if n_steps == 0 or batch == 0:
        return torch.zeros_like(x_proj), dw, db
    geometry, scratch, dw_part, db_part = hopper_gru.bwd_launch_buffers(x_proj, n_dir, hidden, 4)
    mask_f = mask.to(torch.float32).contiguous()
    dxp = torch.empty_like(x_proj)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library("lstm_bwd").lstm_bwd(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(), ys.data_ptr(),
            cs.data_ptr(), g.data_ptr(), dxp.data_ptr(), scratch.data_ptr(), dw_part.data_ptr(),
            db_part.data_ptr(), dw.data_ptr(), db.data_ptr(), n_steps, batch, hidden, n_dir,
            rev_bits, hopper_gru._DTYPES[x_proj.dtype], *hopper_gru.geometry_args(geometry),
            stream)
    if err != 0:
        raise RuntimeError(f"lstm_bwd kernel launch failed with CUDA error {err}")
    bwd_launches += 1
    return dxp, dw, db


def _directions(n_dir, rev_bits):
    return [bool((rev_bits >> d) & 1) for d in range(n_dir)]


def lstm_forward_reference(x_proj, w_h, b_h, mask, rev_bits, with_cells=False):
    """:func:`lstm_sequence_reference` for each of D directions, in the
    kernels' layout: x_proj (T, B, D*4H), w_h (D, H, 4H), b_h (D, 4H) ->
    (ys (T, B, D*H), cs (T, B, D*H) or None); direction d walks time
    backward iff bit d of ``rev_bits`` is set."""
    gates = w_h.shape[-1]
    parts = [lstm_sequence_reference(x_proj[..., d * gates:(d + 1) * gates], w_h[d], b_h[d],
                                     mask, rev, return_cells=True)
             for d, rev in enumerate(_directions(w_h.shape[0], rev_bits))]
    ys = torch.cat([p[0] for p in parts], dim=-1)
    return ys, (torch.cat([p[1] for p in parts], dim=-1) if with_cells else None)


def lstm_backward_reference(x_proj, w_h, b_h, mask, ys, cs, g, rev_bits):
    """:func:`lstm_sequence_backward_reference` for each of D directions, in
    the kernels' layout: (dx_proj, dW_h (D, H, 4H) f32, db_h (D, 4H) f32)."""
    gates, hidden = w_h.shape[-1], w_h.shape[1]
    units = lambda v, d: v[..., d * hidden:(d + 1) * hidden]  # noqa: E731
    parts = [
        lstm_sequence_backward_reference(
            x_proj[..., d * gates:(d + 1) * gates], w_h[d], b_h[d], mask, units(ys, d),
            units(cs, d), units(g, d), rev)
        for d, rev in enumerate(_directions(w_h.shape[0], rev_bits))
    ]
    return (torch.cat([p[0] for p in parts], dim=-1), torch.stack([p[1] for p in parts]),
            torch.stack([p[2] for p in parts]))


def lstm_forward(x_proj, w_h, b_h, mask, rev_bits, with_cells=False):
    """D directions of the recurrence (layout of :func:`lstm_forward_reference`):
    (ys, cs or None). CPU: the plain version; CUDA: one launch of the forward
    kernel, which writes cs only when ``with_cells``."""
    if x_proj.device.type == "cpu":
        return lstm_forward_reference(x_proj, w_h, b_h, mask, rev_bits, with_cells)
    return _launch(x_proj, w_h, b_h, mask, w_h.shape[0], rev_bits, with_cells)


def lstm_backward(x_proj, w_h, b_h, mask, ys, cs, g, rev_bits):
    """Backward of :func:`lstm_forward` given its outputs ``ys`` and ``cs``
    and the gradient ``g`` by ys: (dx_proj, dW_h (D, H, 4H) f32, db_h (D, 4H)
    f32). CPU: the plain version; CUDA: one launch of the backward kernel."""
    if x_proj.device.type == "cpu":
        return lstm_backward_reference(x_proj, w_h, b_h, mask, ys, cs, g, rev_bits)
    return _launch_bwd(x_proj, w_h, b_h, mask, ys, cs, g, w_h.shape[0], rev_bits)


class LSTMSequenceFn(torch.autograd.Function):
    """Differentiable :func:`lstm_forward`, its backward :func:`lstm_backward`
    (the counterpart of the JAX custom VJP). The forward keeps the cell
    states only ``with_cells`` (see :func:`_apply`); the backward recomputes
    the gates from ys and cs."""

    @staticmethod
    def forward(ctx, x_proj, w_h, b_h, mask, rev_bits, with_cells):
        ys, cs = lstm_forward(x_proj, w_h, b_h, mask, rev_bits, with_cells)
        if with_cells:
            ctx.save_for_backward(x_proj, w_h, b_h, mask, ys, cs)
        ctx.rev_bits = rev_bits
        return ys

    @staticmethod
    def backward(ctx, g):
        x_proj, w_h, b_h, mask, ys, cs = ctx.saved_tensors
        g = g.to(ys.dtype).contiguous()
        dxp, dw, db = lstm_backward(x_proj, w_h, b_h, mask, ys, cs, g, ctx.rev_bits)
        return dxp, dw.to(w_h.dtype), db.to(b_h.dtype), None, None, None


def _apply(x_proj, w_h, b_h, mask, rev_bits):
    """:class:`LSTMSequenceFn`, keeping the cell states only where autograd
    records the call (grad mode on and an input that requires grad): under
    ``torch.no_grad`` or ``inference_mode`` the forward writes ys alone."""
    with_cells = torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_h, b_h))
    return LSTMSequenceFn.apply(x_proj, w_h, b_h, mask, rev_bits, with_cells)


def lstm_sequence(x_proj, w_h, b_h, mask, reverse=False):
    """Masked LSTM recurrence over hoisted input projections, time-major.

    Args:
        x_proj: (T, B, 4H); w_h: (H, 4H); b_h: (4H,); mask: (T, B), nonzero on
            valid steps; reverse: walk time backward (outputs in forward order).
    Returns:
        (T, B, H), differentiable in x_proj, w_h and b_h. A CPU tensor takes
        the plain versions; a CUDA tensor takes the kernels, or the call raises.
    """
    return _apply(x_proj, w_h[None], b_h[None], mask, int(bool(reverse)))


def bilstm_sequence(x_proj, w_h, b_h, mask):
    """Both directions of a bidirectional layer in one kernel launch.

    Args:
        x_proj: (T, B, 2*4H) — forward gates, then backward gates.
        w_h: (2, H, 4H); b_h: (2, 4H); mask: (T, B).
    Returns:
        (T, B, 2H): the forward direction's states, then the backward one's.
    """
    return _apply(x_proj, w_h, b_h, mask, 0b10)
