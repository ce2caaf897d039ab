"""Share of the traced slice in which no operation ran on the device (the
union of kernels, copies and sets)."""

LAYER = "device"
UNIT = "%"
MOVES = "infer_frames_per_s"


def read(r):
    window = r.view.window_s
    return 100.0 * (1.0 - r.view.busy_s / window) if window > 0 and r.view.ops else None
