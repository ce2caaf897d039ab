"""Masked GRU recurrence: the Hopper kernel's wrapper and its plain version.

Counterpart of artspeech_tpu/ops/pallas_gru.py:gru_sequence (the fused Pallas
forward time loop, ``_gru_fwd_kernel``). The kernel is ``csrc/gru_fwd.cu``.

- A CPU tensor takes the plain version, :func:`gru_sequence_reference`.
- A CUDA tensor takes the kernel, or the call raises. Nothing falls back.

``launches`` counts kernel launches, so a run can show that its GRUs went
through the kernel.
"""

import ctypes

import torch

from artspeech_tpu_torch.ops import _build

#: Kernel launches so far (the plain version does not count).
launches = 0

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 232448  # bytes of shared memory one Hopper block may use
_lib = None


def _library():
    global _lib
    if _lib is None:
        lib = _build.load("gru_fwd")
        lib.gru_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.gru_fwd.restype = ctypes.c_int
        lib.gru_fwd_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.gru_fwd_smem_bytes.restype = ctypes.c_size_t
        _lib = lib
    return _lib


def gru_sequence_reference(x_proj, w_h, b_h, mask, reverse=False):
    """Plain PyTorch masked GRU over hoisted projections (a loop over T).

    Args:
        x_proj: (T, B, 3H) f32 or bf16 — ``x @ W_i + b_i`` for every step.
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
    ys = torch.empty(n_steps, batch, hidden, dtype=dtype, device=x_proj.device)
    for s in range(n_steps):
        t = n_steps - 1 - s if reverse else s
        hg = h @ w + b
        xg = x_proj[t].float()
        r = torch.sigmoid(xg[:, :hidden] + hg[:, :hidden])
        z = torch.sigmoid(xg[:, hidden:2 * hidden] + hg[:, hidden:2 * hidden])
        n = torch.tanh(xg[:, 2 * hidden:] + r * hg[:, 2 * hidden:])
        cand = (1.0 - z) * n + z * h
        out = torch.where(valid[t][:, None], cand, h).to(dtype)
        ys[t] = out
        h = out.float()
    return ys


def _check(x_proj, w_h, b_h, mask, n_dir):
    if x_proj.device.type != "cuda":
        raise ValueError(f"gru kernel needs CUDA tensors, got {x_proj.device}")
    if x_proj.dtype not in _DTYPES:
        raise ValueError(f"gru kernel takes float32 or bfloat16, got {x_proj.dtype}")
    if x_proj.dim() != 3 or w_h.dim() != 3 or b_h.dim() != 2 or mask.dim() != 2:
        raise ValueError("gru kernel shapes: x_proj (T,B,D*3H), w_h (D,H,3H), b_h (D,3H), mask (T,B)")
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    gates = 3 * hidden
    if (tuple(x_proj.shape) != (n_steps, batch, n_dir * gates)
            or tuple(w_h.shape) != (n_dir, hidden, gates)
            or tuple(b_h.shape) != (n_dir, gates)
            or tuple(mask.shape) != (n_steps, batch)):
        raise ValueError(
            f"gru kernel shape mismatch: x_proj {tuple(x_proj.shape)}, w_h {tuple(w_h.shape)}, "
            f"b_h {tuple(b_h.shape)}, mask {tuple(mask.shape)}")
    for name, t in (("x_proj", x_proj), ("w_h", w_h), ("b_h", b_h)):
        if t.dtype != x_proj.dtype or t.device != x_proj.device:
            raise ValueError(f"gru kernel: {name} must match x_proj's dtype and device")
        if not t.is_contiguous():
            raise ValueError(f"gru kernel: {name} must be contiguous")
    if mask.device != x_proj.device:
        raise ValueError("gru kernel: mask must be on x_proj's device")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x_proj, w_h, b_h)):
        raise RuntimeError("gru kernel has no backward yet; run it under torch.inference_mode() "
                           "or torch.no_grad()")
    if hidden % 4 or gates > 1024:
        raise ValueError(f"gru kernel takes H % 4 == 0 and H <= 340, got H={hidden}")
    smem = _library().gru_fwd_smem_bytes(hidden, x_proj.element_size())
    if smem > _MAX_SMEM:
        raise ValueError(
            f"gru kernel: H={hidden} in {x_proj.dtype} needs {smem} B of shared memory, "
            f"more than the {_MAX_SMEM} B a block may use")


def _launch(x_proj, w_h, b_h, mask, n_dir, rev_bits):
    global launches
    _check(x_proj, w_h, b_h, mask, n_dir)
    n_steps, batch, _ = x_proj.shape
    hidden = w_h.shape[1]
    mask_f = mask.to(torch.float32).contiguous()
    ys = torch.empty(n_steps, batch, n_dir * hidden, dtype=x_proj.dtype, device=x_proj.device)
    if n_steps == 0 or batch == 0:
        return ys
    with torch.cuda.device(x_proj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().gru_fwd(
            x_proj.data_ptr(), w_h.data_ptr(), b_h.data_ptr(), mask_f.data_ptr(),
            ys.data_ptr(), n_steps, batch, hidden, n_dir, rev_bits,
            _DTYPES[x_proj.dtype], stream)
    if err != 0:
        raise RuntimeError(f"gru_fwd kernel launch failed with CUDA error {err}")
    launches += 1
    return ys


def gru_sequence(x_proj, w_h, b_h, mask, reverse=False):
    """Masked GRU recurrence over hoisted input projections, time-major.

    Args:
        x_proj: (T, B, 3H); w_h: (H, 3H); b_h: (3H,); mask: (T, B), nonzero on
            valid steps; reverse: walk time backward (outputs in forward order).
    Returns:
        (T, B, H). A CPU tensor takes :func:`gru_sequence_reference`; a CUDA
        tensor takes the kernel, or the call raises.
    """
    if x_proj.device.type == "cpu":
        return gru_sequence_reference(x_proj, w_h, b_h, mask, reverse)
    return _launch(x_proj, w_h[None], b_h[None], mask, 1, int(bool(reverse)))


def bigru_sequence(x_proj, w_h, b_h, mask):
    """Both directions of a bidirectional layer in one kernel launch.

    Args:
        x_proj: (T, B, 2*3H) — forward gates, then backward gates.
        w_h: (2, H, 3H); b_h: (2, 3H); mask: (T, B).
    Returns:
        (T, B, 2H): the forward direction's states, then the backward one's.
    """
    if x_proj.device.type == "cpu":
        gates = w_h.shape[-1]
        return torch.cat([
            gru_sequence_reference(x_proj[..., :gates], w_h[0], b_h[0], mask, False),
            gru_sequence_reference(x_proj[..., gates:], w_h[1], b_h[1], mask, True),
        ], dim=-1)
    return _launch(x_proj, w_h, b_h, mask, 2, 0b10)
