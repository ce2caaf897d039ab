"""The 95th percentile of the window's untraced requests, milliseconds from
the token arrays handed in to every output on the host (host clock; linear
between order statistics). Not an end-to-end metric: the program's copy into
fresh pageable memory moves it from process to process by more than any
bound allows."""

import numpy as np

LAYER = "synthesis step host (synth/pipeline.py)"
UNIT = "ms"
MOVES = "infer_frames_per_s"


def read(r):
    return float(np.percentile(np.asarray(r.host_ms, dtype=np.float64), 95)) if r.host_ms else None
