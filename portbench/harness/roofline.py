"""The chip's peaks and the least time each kernel's work could take.

The bound functions are copies of ``chip_smoke.py``'s ``gru_bound_ms``,
``gru_bwd_bound_ms`` and ``train_attention_bound_ms`` (the program's smoke
test, which measures each kernel alone): the larger of the bytes the work
must move over the HBM bandwidth and its operations over the float32 peak
outside the tensor cores (the configurations compute in float32 with TF32
off), inputs read and outputs written once.
"""

#: One NVIDIA H100 SXM (NVIDIA's data sheet, dense): HBM3 bandwidth and the
#: float32 rate outside the tensor cores, at the full 700 W power limit.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def _bound(bytes_moved, flops):
    by_bytes, by_ops = bytes_moved / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def gru_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the forward's work: bytes moved once over HBM, FLOPs of
    the recurrent product over the f32 (non-tensor-core) peak; the larger."""
    gates = 3 * h
    bytes_moved = elem_bytes * (t * b * n_dir * gates + n_dir * h * gates + n_dir * gates
                                + t * b * n_dir * h) + 4 * t * b
    flops = n_dir * t * b * (2 * h * gates + 12 * h)
    return _bound(bytes_moved, flops)


def gru_bwd_bound_ms(t, b, h, n_dir, elem_bytes):
    """Least time for the backward's work: x_proj, ys, g, mask, W_h, b_h read
    and dx_proj written once, dW_h and db_h written once in f32; three
    (B, H) x (H, 3H)-sized products a step and direction (recompute, dh, dW)
    plus ~32 elementwise operations per hidden unit, over the f32 peak."""
    gates = 3 * h
    bytes_moved = (elem_bytes * (2 * t * b * n_dir * gates + 2 * t * b * n_dir * h
                                 + n_dir * h * gates + n_dir * gates)
                   + 4 * t * b + 4 * n_dir * (h * gates + gates))
    flops = n_dir * t * b * (3 * 2 * h * gates + 32 * h)
    return _bound(bytes_moved, flops)


def train_attention_bound_ms(g, l, n_pairs, backward, hd):
    """Least time for the work over the causal (q, k) pairs: the forward
    reads q, k, v and keep and writes the output and lse once, 4 hd
    operations a pair (score and PV); the backward's function reads q, k, v,
    keep and dO and writes dq, dk, dv once, 10 hd operations a pair (score,
    dP, dV, dQ, dK)."""
    pairs = g * l * (l + 1) // 2
    rows = 4 * g * l * hd
    keep = 4 * n_pairs * l * l
    bytes_moved = 7 * rows + keep if backward else 4 * rows + keep + 4 * g * l
    ops = (10 if backward else 4) * hd * pairs
    return _bound(bytes_moved, ops)
