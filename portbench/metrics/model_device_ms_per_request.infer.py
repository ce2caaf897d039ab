"""Device milliseconds a request of the kernels launched inside the
benchmark's ``portbench.model`` span (the model's forward), from the slice
traced with the host."""

LAYER = "models (models/artspeech_rnn.py, models/heads.py, ops/gru.py)"
UNIT = "ms"
MOVES = "infer_frames_per_s"


def read(r):
    v = r.spans_view
    ops = [o for o in v.launched_in("portbench.model") if o.kind == "kernel"] if v else []
    return 1e-6 * sum(o.end - o.start for o in ops) / r.spans_units if ops else None
