"""The training-attention kernels' share of their roofline: the summed least
times of the slice's forward and backward calls over their summed device
time (a streamed backward's dQ and dK/dV launches are one call)."""

LAYER = "kernels (ops/hopper_train_attention.py, ops/csrc/train_attention.cu)"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(r):
    fwd = r.view.kernels("train_attention_fwd")
    bwd = r.view.kernels("train_attention_bwd", "train_attention_dq")
    dkv = r.view.kernels("train_attention_dkv")
    if not fwd or not bwd or "train_attention_fwd" not in r.bounds:
        return None
    bound_ms = (len(fwd) * r.bounds["train_attention_fwd"]
                + len(bwd) * r.bounds["train_attention_bwd"])
    device_ms = 1e-6 * sum(o.end - o.start for o in fwd + bwd + dkv)
    return 100.0 * bound_ms / device_ms
