"""The GRU kernels' share of their roofline in training: the summed least
times of the slice's forward and backward calls over their summed device
time (the backward's partial-sum pass counted with it)."""

LAYER = "kernels (ops/hopper_gru.py, ops/csrc/gru_fwd.cu, gru_bwd.cu)"
UNIT = "%"
MOVES = "train_frames_per_s"


def read(r):
    fwd, bwd = r.view.kernels("gru_fwd"), r.view.kernels("gru_bwd")
    if not fwd or not bwd or "gru_fwd" not in r.bounds:
        return None
    parts = r.view.kernels("sum_partials")
    bound_ms = len(fwd) * r.bounds["gru_fwd"] + len(bwd) * r.bounds["gru_bwd"]
    device_ms = 1e-6 * sum(o.end - o.start for o in fwd + bwd + parts)
    return 100.0 * bound_ms / device_ms
