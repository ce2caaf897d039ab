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
``MAX_HEAD_DIM``, ``L`` above ``MAX_L`` and a ``G`` that ``n_pairs`` does
not divide. The kernels take any G: up to hd = 32 (and, in the backward,
while a group's rows fit a block's shared memory) those that hold a row in a
thread's registers, the thesis transformer's hd = 16 among them; elsewhere
the wide ones, a row a warp. The TPU wrapper's tile rules (``supported``,
``G_BLOCK``, ``L % 128``, ``_spmd_safe``) and its
``ARTSPEECH_NO_TRAIN_ATTENTION_KERNEL`` switch are not ported.

``launches_fwd`` and ``launches_bwd`` count kernel launches.
"""

import ctypes

import torch

from artspeech_tpu_torch.ops import _build

#: Forward kernel launches so far (the plain version does not count).
launches_fwd = 0
#: Backward kernel launches so far (the plain version does not count).
launches_bwd = 0

#: Longest sequence the kernels take: the largest default bucket
#: (data/batching.py DEFAULT_BUCKETS).
MAX_L = 512
#: Largest head dim the kernels take (csrc/train_attention.cu).
MAX_HEAD_DIM = 128

_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("train_attention")
        lib.train_attention_fwd.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.train_attention_fwd.restype = ctypes.c_int
        lib.train_attention_bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        lib.train_attention_bwd.restype = ctypes.c_int
        lib.train_attention_resident.argtypes = [ctypes.c_int] * 3
        lib.train_attention_resident.restype = ctypes.c_int
        _lib = lib
    return _lib


def resident(l: int, hd: int, backward: bool) -> bool:
    """Whether the forward (or backward) at (L, hd) runs the kernels that
    hold a row in a thread's registers (else the wide ones, a row a warp)."""
    return bool(_library().train_attention_resident(l, hd, int(backward)))


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
    if not 1 <= l <= MAX_L:
        raise ValueError(f"fused_causal_attend: L={l} outside the kernels' [1, {MAX_L}]")
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
    global launches_fwd
    _check(q, k, v, keep, n_pairs)
    if q.device.type != "cuda":
        raise ValueError(f"train_attention forward kernel needs CUDA tensors, got {q.device}")
    g, l, hd = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((g, l), dtype=torch.float32, device=q.device)
    err = _library().train_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(), out.data_ptr(), lse.data_ptr(),
        g, l, hd, n_pairs, _stream(q.device))
    if err != 0:
        raise RuntimeError(f"train_attention forward kernel launch failed with CUDA error {err}")
    launches_fwd += 1
    return out, lse


def fused_causal_attend_bwd(q, k, v, keep, out, lse, do, n_pairs: int):
    """One launch of the backward kernel (CUDA tensors only), given the
    forward kernel's ``out`` and ``lse`` and the gradient ``do`` by out:
    returns (dq, dk, dv), each (G, L, hd) float32."""
    global launches_bwd
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
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    dsum = torch.empty_like(lse)  # the wide kernels' D_q = dO_q . out_q
    err = _library().train_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), keep.data_ptr(), out.data_ptr(), lse.data_ptr(),
        do.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dsum.data_ptr(), g, l, hd,
        n_pairs, _stream(dev))
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
