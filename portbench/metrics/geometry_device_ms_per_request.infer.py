"""Device milliseconds a request of its other kernels (B-spline smoothing,
incisor, tube walls, area function), copies and sets left out, from the
slice traced with the host."""

LAYER = "geometry (ops/bspline.py, geometry/tube.py, geometry/area_function.py)"
UNIT = "ms"
MOVES = "infer_frames_per_s"


def read(r):
    v = r.spans_view
    if v is None or not v.spans_named("portbench.model"):
        return None
    model = {id(o) for o in v.launched_in("portbench.model")}
    ops = [o for o in v.kernels() if id(o) not in model]
    return 1e-6 * sum(o.end - o.start for o in ops) / r.spans_units if ops else None
