"""Vocal-tract shape plots and videos (host-side visualization; copy of
artspeech_tpu/synth/viz.py).

Equivalents of reference generate_vocal_tract_shape.py:80-164
(``save_vocal_tract_shape``, ``make_vocal_tract_shape_video`` via cv2) and
scripts/make_dataset_videos.py / scripts/plot_phoneme_to_articulation_outputs.py.
Each render function returns ``None`` / ``False`` when matplotlib (or cv2)
is absent, as the JAX package's do; the port's generate CLI turns that into
an error naming the package, since its user asked for the files.
"""

import os
from typing import Dict, Optional, Sequence

import numpy as np

from artspeech_tpu_torch.core.constants import COLORS


def pyplot():
    """matplotlib.pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        return plt
    except Exception:
        return None


def plot_vocal_tract_shape(
    contours: Dict[str, np.ndarray],
    save_path: Optional[str] = None,
    phoneme: Optional[str] = None,
    lim: float = 1.0,
    ax=None,
):
    """One frame: articulator contours in normalized coordinates.

    Args:
        contours: articulator -> (2, D) array.
    """
    plt = pyplot()
    if plt is None:
        return None
    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(6, 6))
    for articulator, arr in contours.items():
        arr = np.asarray(arr)
        ax.plot(arr[0], arr[1], color=COLORS.get(articulator, "black"), linewidth=2)
    if phoneme is not None:
        ax.text(0.05, 0.95, str(phoneme), transform=ax.transAxes, fontsize=18)
    ax.set_xlim(0, lim)
    ax.set_ylim(lim, 0)  # image coordinates: y down
    ax.axis("off")
    if own_fig:
        if save_path is not None:
            fig.savefig(save_path, dpi=100, bbox_inches="tight")
        plt.close(fig)
    return ax


def save_vocal_tract_shapes(
    articulators: Sequence[str],
    outputs: np.ndarray,
    phonemes: Sequence[str],
    save_to: str,
):
    """Per-frame plots (reference generate_vocal_tract_shape.py:80-107).

    Args:
        outputs: (T, Nart, 2, D).
    Returns:
        True; False, with nothing written, without matplotlib.
    """
    if pyplot() is None:
        return False
    os.makedirs(save_to, exist_ok=True)
    arts = sorted(articulators)
    for t in range(outputs.shape[0]):
        contours = {art: outputs[t, i] for i, art in enumerate(arts)}
        phoneme = phonemes[t] if t < len(phonemes) else None
        plot_vocal_tract_shape(
            contours,
            save_path=os.path.join(save_to, f"{t + 1:04d}.jpg"),
            phoneme=phoneme,
        )
    return True


def make_vocal_tract_shape_video(
    articulators: Sequence[str],
    outputs: np.ndarray,
    phonemes: Sequence[str],
    video_filepath: str,
    framerate: int = 50,
    frame_size: int = 600,
):
    """Render contour frames into an .avi via cv2 (reference
    generate_vocal_tract_shape.py:110-164 — without its undefined-``i`` bug)."""
    plt = pyplot()
    try:
        import cv2
    except Exception:
        return False
    if plt is None:
        return False

    fourcc = cv2.VideoWriter_fourcc(*"MJPG")
    writer = cv2.VideoWriter(
        video_filepath, fourcc, framerate, (frame_size, frame_size)
    )
    arts = sorted(articulators)
    for t in range(outputs.shape[0]):
        fig, ax = plt.subplots(figsize=(frame_size / 100, frame_size / 100), dpi=100)
        contours = {art: outputs[t, i] for i, art in enumerate(arts)}
        plot_vocal_tract_shape(
            contours, phoneme=phonemes[t] if t < len(phonemes) else None, ax=ax
        )
        fig.canvas.draw()
        buf = np.frombuffer(fig.canvas.buffer_rgba(), dtype=np.uint8)
        w, h = fig.canvas.get_width_height()
        img = buf.reshape(h, w, 4)[..., :3]
        img = cv2.resize(img, (frame_size, frame_size))
        writer.write(cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        plt.close(fig)
    writer.release()
    return True


def missing_packages(*names: str):
    """Those of the named packages that do not import here."""
    missing = []
    for name in names:
        try:
            __import__(name)
        except Exception:
            missing.append(name)
    return missing


def uint16_to_uint8(image: np.ndarray) -> np.ndarray:
    """Dynamic-range conversion (vt_tracker.visualization equivalent,
    used by reference scripts/make_dataset_videos.py:17)."""
    img = image.astype(np.float64)
    lo, hi = img.min(), img.max()
    if hi <= lo:
        return np.zeros_like(img, dtype=np.uint8)
    return ((img - lo) / (hi - lo) * 255.0).astype(np.uint8)
