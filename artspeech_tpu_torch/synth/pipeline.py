"""Phoneme -> contour -> air-column synthesis (counterpart of
artspeech_tpu/synth/pipeline.py).

The serving path: sentences are bucketed into a few fixed shapes; the model
forward, B-spline smoothing, canonical-incisor injection and vocal-tract tube
walls run on the device per batch; the host writes the synthetic corpus
(inference_contours/*.npy, air_column/*.npy, xarticul/*.txt,
target_sequence.txt) in the JAX package's directory schema.
``SynthesisDataset`` is a copy of the JAX package's without its voiced-token
option, which no caller passes (the JAX generate CLI builds it without one);
the recognizer scores the corpus with its own voicing, through the test
CLI's ``synthetic: true``.
"""

import logging
import os
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.config import DatasetConfig
from artspeech_tpu_torch.core.constants import UPPER_INCISOR
from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.core.vocab import token_id
from artspeech_tpu_torch.data.batching import DEFAULT_BUCKETS, pad_to, pick_bucket
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.geometry.tube import generate_vocal_tract_tube_batch
from artspeech_tpu_torch.ops.bspline import regularize_bsplines
from artspeech_tpu_torch.synth.reference_contour import CANONICAL_UPPER_INCISOR
from artspeech_tpu_torch.utils.io import npy_to_xarticul

logger = logging.getLogger(__name__)


class SynthesisDataset:
    """Tokens-only sentence dataset with the canonical incisor reference
    (reference generate_vocal_tract_shape_v2.py:41-121)."""

    def __init__(
        self,
        datadir: str,
        database_name: str,
        sequences,
        vocabulary: Dict[str, int],
        articulators: Sequence[str],
    ):
        self.vocabulary = vocabulary
        self.articulators = sorted(articulators)
        collector = DATABASE_COLLECTORS[database_name](datadir)
        self.data = collector.collect_data(sequences)

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        item = self.data[index]
        tokens = item["phonemes"]
        return {
            "sentence_name": item["sentence_name"],
            "subject": item["subject"],
            "tokens": np.array(
                [token_id(t, self.vocabulary) for t in tokens], np.int32
            ),
            "phonemes": list(tokens),
            "voicing": np.zeros(len(tokens), np.float32),
            "length": len(tokens),
        }


def make_synthesis_step(
    forward_fn: Callable,
    articulators: Sequence[str],
    regularize_outputs: bool = True,
    wall_points: int = 100,
    device: DeviceLike = None,
):
    """tokens -> contours -> smoothed -> +incisor -> tube walls.

    ``forward_fn(tokens, lengths) -> (B, T, Nart, 2, D)`` is the model (an
    ``ArtSpeech`` on ``device``). Returns ``(synth_step, full_arts)``;
    ``synth_step(tokens, lengths)`` takes arrays or tensors and returns
    {contours, internal_wall, external_wall} as tensors on ``device``.
    """
    dev = resolve_device(device)
    articulators = sorted(articulators)
    ref = torch.as_tensor(CANONICAL_UPPER_INCISOR, device=dev)  # (2, D)

    if UPPER_INCISOR in articulators:
        full_arts = list(articulators)
        ref_idx = None
    else:
        full_arts = sorted(articulators + [UPPER_INCISOR])
        ref_idx = full_arts.index(UPPER_INCISOR)

    @torch.inference_mode()
    def synth_step(tokens, lengths):
        tokens = torch.as_tensor(tokens, dtype=torch.int64, device=dev)
        lengths = torch.as_tensor(lengths, dtype=torch.int64, device=dev)
        outputs = forward_fn(tokens, lengths)  # (B, T, Nart, 2, D)
        if regularize_outputs:
            outputs = regularize_bsplines(outputs.transpose(-1, -2)).transpose(-1, -2)
        if ref_idx is not None:
            b, t = outputs.shape[:2]
            ref_full = ref.expand(b, t, 1, *ref.shape)
            merged = torch.cat(
                [outputs[:, :, :ref_idx], ref_full, outputs[:, :, ref_idx:]], dim=2)
        else:
            merged = outputs
        internal, external = generate_vocal_tract_tube_batch(
            merged, full_arts, wall_points=wall_points)
        return {"contours": merged, "internal_wall": internal, "external_wall": external}

    return synth_step, full_arts


def synthesize_corpus(
    forward_fn: Callable,
    dataset,
    save_to: str,
    dataset_config: DatasetConfig,
    regularize_outputs: bool = True,
    batch_size: int = 8,
    buckets: Sequence[int] = DEFAULT_BUCKETS,
    save_air_column: bool = True,
    save_xarticul: bool = True,
    device: DeviceLike = None,
) -> List[str]:
    """Run the synthesis over a dataset, writing the synthetic corpus.

    ``dataset`` has the JAX ``SynthesisDataset`` interface: ``articulators``,
    ``data[i]["phonemes"]``, ``len()`` and items with ``sentence_name``,
    ``subject``, ``tokens``, ``phonemes`` and ``length``.

    Output layout per sentence:
        {save_to}/{subject}/{sentence_name}/inference_contours/{frame}_{art}.npy
        .../air_column/{frame}.npy          ((2, 2, wall_points) walls)
        .../xarticul/{frame}.txt
        .../target_sequence.txt
    Returns the list of sentence directories written.
    """
    synth_step, full_arts = make_synthesis_step(
        forward_fn, dataset.articulators, regularize_outputs, device=device)

    order = sorted(range(len(dataset)), key=lambda i: len(dataset.data[i]["phonemes"]))
    max_len = max((len(dataset.data[i]["phonemes"]) for i in order), default=0)
    if buckets and max_len > max(buckets):
        # pick_bucket would truncate longer sentences; extend the buckets.
        extended = ((max_len + 63) // 64) * 64
        logger.warning(
            "Longest sentence (%d frames) exceeds the largest bucket (%d); "
            "adding a %d-frame bucket.", max_len, max(buckets), extended,
        )
        buckets = tuple(buckets) + (extended,)
    written = []
    for start in range(0, len(order), batch_size):
        idx = order[start : start + batch_size]
        items = [dataset[i] for i in idx]
        bucket = pick_bucket(max(it["length"] for it in items), buckets)
        tokens = np.stack([pad_to(it["tokens"], bucket) for it in items])
        lengths = np.array([min(it["length"], bucket) for it in items], np.int32)
        if len(items) < batch_size:  # pad the batch with zero-length rows
            pad_n = batch_size - len(items)
            tokens = np.concatenate([tokens, np.zeros((pad_n, bucket), np.int32)])
            lengths = np.concatenate([lengths, np.zeros(pad_n, np.int32)])

        result = {k: v.cpu().numpy() for k, v in synth_step(tokens, lengths).items()}

        for j, item in enumerate(items):
            L = int(lengths[j])
            sentence_dir = os.path.join(save_to, item["subject"], item["sentence_name"])
            written.append(sentence_dir)
            contours_dir = os.path.join(sentence_dir, "inference_contours")
            os.makedirs(contours_dir, exist_ok=True)
            with open(os.path.join(sentence_dir, "target_sequence.txt"), "w") as f:
                f.write(" ".join(item["phonemes"][:L]))

            contours = result["contours"][j, :L]  # (L, Nart+1, 2, D)
            for t in range(L):
                frame_id = f"{t + 1:04d}"
                for i_art, art in enumerate(full_arts):
                    np.save(os.path.join(contours_dir, f"{frame_id}_{art}.npy"),
                            contours[t, i_art])
            if save_air_column:
                air_dir = os.path.join(sentence_dir, "air_column")
                os.makedirs(air_dir, exist_ok=True)
                for t in range(L):
                    air = np.stack([result["internal_wall"][j, t].T,
                                    result["external_wall"][j, t].T])  # (2, 2, wall_points)
                    np.save(os.path.join(air_dir, f"{t + 1:04d}.npy"), air)
            if save_xarticul:
                xart_dir = os.path.join(sentence_dir, "xarticul")
                os.makedirs(xart_dir, exist_ok=True)
                res = dataset_config.RES
                for t in range(L):
                    lines = npy_to_xarticul(result["internal_wall"][j, t] * res) + npy_to_xarticul(
                        result["external_wall"][j, t] * res)
                    with open(os.path.join(xart_dir, f"{t + 1:04d}.txt"), "w") as f:
                        f.write("\n".join(lines))
    return written
