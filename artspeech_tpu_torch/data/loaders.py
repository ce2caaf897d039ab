"""Contour loading and recentering (host-side, cached; copy of
artspeech_tpu/data/loaders.py without the normalization hook, whose callers
are not ported). ``prefetch_contours`` primes the cache through the native
C++ loader (data/native.py), which the port always builds.

Equivalents of ``vt_shape_gen.helpers.load_articulator_array`` plus reference
phoneme_to_articulation/__init__.py:52-118 (``InputLoaderMixin``) and
vocal_tract_loader.py:16-134 (``VocalTractShapeLoader``). All arrays are
numpy; the data pipeline stays on the host and feeds fixed-shape batches to
the device.
"""

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from artspeech_tpu_torch.core.config import DatasetConfig
from artspeech_tpu_torch.core.constants import UPPER_INCISOR
from artspeech_tpu_torch.data import native
from artspeech_tpu_torch.data.tail_clipper import TAIL_CLIP_REFERENCES, TailClipper
from artspeech_tpu_torch.ops.resample import resample_linear_np

#: Recentering offset added after subtracting the upper-incisor origin
#: (reference phoneme_to_articulation/__init__.py:107-113).
CENTER_OFFSET = (0.3, 0.3)

#: Points per contour (reference encoder_decoder/dataset.py's ``N_SAMPLES``).
N_SAMPLES = 50


#: In-RAM contour cache keyed by (filepath, norm_value) — the explicit-dict
#: version of the reference's lru_cache (phoneme_to_articulation/
#: __init__.py:52-54), so the native batch loader can prime it.
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


def prefetch_contours(
    filepaths: Sequence[str], norm_value: float, n_samples: int = N_SAMPLES
) -> int:
    """Bulk-load contours into the cache with the native C++ loader.

    Only files whose original point count equals ``n_samples`` are cached
    (for those the native resample is the identity and the scaling is
    numpy's, so the cached array equals the Python path's bit for bit);
    others, and files that are missing, fall through to the lazy loader.
    Returns the number of files primed.
    """
    todo = [
        fp
        for fp in dict.fromkeys(filepaths)
        if (fp, float(norm_value)) not in _CONTOUR_CACHE
    ]
    if not todo:
        return 0
    contours, ok, orig = native.load_contour_batch(
        todo, norm_value=norm_value, n_samples=n_samples
    )
    primed = 0
    for i, fp in enumerate(todo):
        if ok[i] and orig[i] == n_samples:
            # native layout (2, N) -> cache layout (N, 2)
            _CONTOUR_CACHE[(fp, float(norm_value))] = contours[i].T.copy()
            primed += 1
    return primed


def load_articulator_array(
    filepath: str, norm_value: float, n_samples: Optional[int] = None
) -> np.ndarray:
    arr = cached_load_articulator_array(filepath, norm_value)
    if n_samples is not None and arr.shape[0] != n_samples:
        arr = resample_linear_np(arr, n_samples)
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
    n_samples: int = N_SAMPLES,
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
    if arr.shape[0] != n_samples:
        arr = resample_linear_np(arr, n_samples)

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
    if incisor.shape[0] != n_samples:
        incisor = resample_linear_np(incisor, n_samples)
    origin = incisor.T[:, -1:]  # (2, 1): last point of the upper incisor

    reference_array = incisor.T - origin
    reference_array = reference_array + np.array(CENTER_OFFSET)[:, None]

    articulator_array = arr.T - origin + np.array(CENTER_OFFSET)[:, None]
    return articulator_array.astype(np.float32), reference_array.astype(np.float32)


class VocalTractShapeLoader:
    """Sentence-level loader stacking frames into (T, Nart, 2, D) plus
    (T, 2, D) references (reference vocal_tract_loader.py:16-134)."""

    def __init__(
        self,
        datadir: str,
        articulators: Sequence[str],
        num_samples: int,
        dataset_config: DatasetConfig,
        clip_tails: bool = True,
    ):
        self.datadir = datadir
        self.articulators = list(articulators)
        self.num_samples = num_samples
        self.dataset_config = dataset_config
        self.clip_tails = clip_tails

    def load_vocal_tract_shapes(
        self, subject: str, sequence: str, frame_ids: Sequence[str], skip_missing=False
    ):
        # Prime the contour cache for the whole sentence in one native
        # batched, multithreaded load.
        arts = list(self.articulators)
        if self.clip_tails:
            arts += [r for r in TAIL_CLIP_REFERENCES if r not in arts]
        if UPPER_INCISOR not in arts:
            arts.append(UPPER_INCISOR)
        prefetch_contours(
            [
                contour_path(self.datadir, subject, sequence, fid, art)
                for fid in frame_ids
                for art in arts
            ],
            norm_value=self.dataset_config.RES,
            n_samples=self.num_samples,
        )
        targets: List[np.ndarray] = []
        references: List[np.ndarray] = []
        for frame_id in frame_ids:
            try:
                frame_arrays = []
                ref_array = None
                for articulator in self.articulators:
                    arr, ref_array = prepare_articulator_array(
                        self.datadir,
                        subject,
                        sequence,
                        frame_id,
                        articulator,
                        self.dataset_config,
                        clip_tails=self.clip_tails,
                        n_samples=self.num_samples,
                    )
                    frame_arrays.append(arr)
            except FileNotFoundError:
                if skip_missing:
                    continue
                raise
            targets.append(np.stack(frame_arrays, axis=0))  # (Nart, 2, D)
            references.append(ref_array)  # (2, D)

        if targets:
            sentence_targets = np.stack(targets, axis=0).astype(np.float32)
            sentence_references = np.stack(references, axis=0).astype(np.float32)
        else:
            sentence_targets = np.zeros(
                (0, len(self.articulators), 2, self.num_samples), np.float32
            )
            sentence_references = np.zeros((0, 2, self.num_samples), np.float32)
        return sentence_targets, sentence_references, len(targets)


def clear_contour_cache():
    _CONTOUR_CACHE.clear()
