"""Host milliseconds inside the train step call: the mean, over the window's
untraced steps, of the benchmark's span around each call into the program
(host clock; the host runs ahead of the device until the launch queue is
full, so a device-paced step blocks in here)."""

LAYER = "train step host (train/step.py)"
UNIT = "ms"
MOVES = "train_frames_per_s"


def read(r):
    return sum(r.host_ms) / len(r.host_ms) if r.host_ms else None
