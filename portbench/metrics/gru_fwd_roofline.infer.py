"""The GRU forward kernel's share of its roofline in synthesis: the summed
least times of the slice's calls over their summed device time."""

LAYER = "kernels (ops/hopper_gru.py, ops/csrc/gru_fwd.cu, gru_bwd.cu)"
UNIT = "%"
MOVES = "infer_frames_per_s"


def read(r):
    fwd = r.view.kernels("gru_fwd")
    if not fwd or "gru_fwd" not in r.bounds:
        return None
    return 100.0 * len(fwd) * r.bounds["gru_fwd"] / (1e-6 * sum(o.end - o.start for o in fwd))
