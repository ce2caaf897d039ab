"""Contour loading and recentering (host-side, cached; copy of the part of
artspeech_tpu/data/loaders.py that ``ArtSpeechDataset`` calls: no
``prefetch_contours``, which needs the native C++ loader, no
``VocalTractShapeLoader``, which serves the recognizer and principal-component
datasets, and no normalization hook, whose callers are not ported).

Equivalents of ``vt_shape_gen.helpers.load_articulator_array`` plus reference
phoneme_to_articulation/__init__.py:52-118 (``InputLoaderMixin``). All arrays
are numpy; the data pipeline stays on the host and feeds fixed-shape batches
to the device.
"""

import os
from typing import Dict, Tuple

import numpy as np

from artspeech_tpu_torch.core.config import DatasetConfig
from artspeech_tpu_torch.core.constants import UPPER_INCISOR
from artspeech_tpu_torch.data.tail_clipper import TAIL_CLIP_REFERENCES, TailClipper
from artspeech_tpu_torch.ops.resample import resample_linear_np

#: Recentering offset added after subtracting the upper-incisor origin
#: (reference phoneme_to_articulation/__init__.py:107-113).
CENTER_OFFSET = (0.3, 0.3)

#: Points per contour (reference encoder_decoder/dataset.py's ``N_SAMPLES``).
N_SAMPLES = 50


#: In-RAM contour cache keyed by (filepath, norm_value) — the explicit-dict
#: version of the reference's lru_cache (phoneme_to_articulation/
#: __init__.py:52-54).
_CONTOUR_CACHE: Dict[Tuple[str, float], np.ndarray] = {}


def cached_load_articulator_array(filepath: str, norm_value: float) -> np.ndarray:
    """Load an articulator contour npy as (N, 2) scaled by 1/norm_value."""
    key = (filepath, float(norm_value))
    hit = _CONTOUR_CACHE.get(key)
    if hit is not None:
        return hit
    arr = np.load(filepath).astype(np.float32)
    if arr.ndim != 2:
        raise ValueError(f"Bad contour array {filepath}: shape {arr.shape}")
    if arr.shape[0] == 2 and arr.shape[1] != 2:
        arr = arr.T
    arr = arr / float(norm_value)
    _CONTOUR_CACHE[key] = arr
    return arr


def contour_path(datadir, subject, sequence, frame_id, articulator) -> str:
    return os.path.join(
        datadir, subject, sequence, "inference_contours", f"{frame_id}_{articulator}.npy"
    )


def prepare_articulator_array(
    datadir: str,
    subject: str,
    sequence: str,
    frame_id: str,
    articulator: str,
    dataset_config: DatasetConfig,
    clip_tails: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load one articulator contour, optionally tail-clip, recentre on the
    upper incisor's last point + (0.3, 0.3).

    Returns:
        (articulator_array, reference_array): both (2, N) arrays, matching
        reference phoneme_to_articulation/__init__.py:57-118.
    """
    arr = cached_load_articulator_array(
        contour_path(datadir, subject, sequence, frame_id, articulator),
        norm_value=dataset_config.RES,
    )
    if arr.shape[0] != N_SAMPLES:
        arr = resample_linear_np(arr, N_SAMPLES)

    if clip_tails:
        refs = {
            ref: cached_load_articulator_array(
                contour_path(datadir, subject, sequence, frame_id, ref),
                norm_value=dataset_config.RES,
            )
            for ref in TAIL_CLIP_REFERENCES
        }
        arr = TailClipper(dataset_config).clip(articulator, arr, refs)

    incisor = cached_load_articulator_array(
        contour_path(datadir, subject, sequence, frame_id, UPPER_INCISOR),
        norm_value=dataset_config.RES,
    )
    if incisor.shape[0] != N_SAMPLES:
        incisor = resample_linear_np(incisor, N_SAMPLES)
    origin = incisor.T[:, -1:]  # (2, 1): last point of the upper incisor

    reference_array = incisor.T - origin
    reference_array = reference_array + np.array(CENTER_OFFSET)[:, None]

    articulator_array = arr.T - origin + np.array(CENTER_OFFSET)[:, None]
    return articulator_array.astype(np.float32), reference_array.astype(np.float32)

