"""Device-to-host copy milliseconds a request, from the device trace."""

LAYER = "synthesis step host (synth/pipeline.py)"
UNIT = "ms"
MOVES = "infer_frames_per_s"


def read(r):
    copies = r.view.of_kind("memcpy_dtoh")
    return 1e-6 * sum(o.end - o.start for o in copies) / r.units if copies and r.units else None
