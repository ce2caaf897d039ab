"""Datasets for the principal-components (autoencoder) method (copy of
artspeech_tpu/data/pc_datasets.py).

Equivalents of reference principal_components/dataset.py:15-263:
- frame-level ``AutoencoderDataset`` with phoneme-dependent sample weights
  and per-articulator z-normalization from normalization_statistics/*.npy;
- sentence-level dataset with normalized targets, TV critical masks from a
  config-supplied ``TV_to_phoneme_map``, references and voicing;
plus the normalization-statistics computation itself (reference
scripts/calculate_normalization_statistics.py). Frame batches are padded to
the batch size, or to ``pad_to_multiple`` of it for a data-parallel mesh,
with zero-weight rows, as the JAX package pads them.
"""

import os
from typing import Dict, List, Optional, Sequence

import numpy as np

from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.vocab import token_id
from artspeech_tpu_torch.data.batching import round_up_to_multiple
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.loaders import prepare_articulator_array

#: Critical-consonant upweighting (reference dataset.py:15-27).
PHONEME_WEIGHTS = {
    "l": 3.0, "d": 3.0, "t": 3.0, "n": 3.0, "k": 3.0, "g": 3.0,
    "#": 0.1, "-": 0.1, "ih": 0.1, "yh": 0.1, "uh": 0.1,
}


def load_norm_stats(
    datadir: str, articulators: Sequence[str]
) -> Dict[str, Dict[str, np.ndarray]]:
    """Load normalization_statistics/{art}_{mean,std}.npy
    (reference dataset.py:59-89)."""
    stats = {}
    for articulator in articulators:
        stats_dir = os.path.join(datadir, "normalization_statistics")
        stats[articulator] = {
            "mean": np.load(os.path.join(stats_dir, f"{articulator}_mean.npy")),
            "std": np.load(os.path.join(stats_dir, f"{articulator}_std.npy")),
        }
    return stats


def stack_norm_stats(
    stats: Dict[str, Dict[str, np.ndarray]], articulators: Sequence[str]
):
    """(Nart, 2, D) stacked mean/std arrays in sorted-articulator order —
    the vectorized form of the reference's per-articulator Normalize dict."""
    arts = sorted(articulators)
    mean = np.stack([stats[a]["mean"] for a in arts]).astype(np.float32)
    std = np.stack([stats[a]["std"] for a in arts]).astype(np.float32)
    return mean, std


def compute_normalization_statistics(
    datadir: str,
    database_name: str,
    sequences,
    articulators: Sequence[str],
    clip_tails: bool = True,
    save_to: Optional[str] = None,
) -> Dict[str, Dict[str, np.ndarray]]:
    """Per-articulator mean/std over all frames (reference
    scripts/calculate_normalization_statistics.py:16-83)."""
    config = DATASET_CONFIG[database_name]
    collector = DATABASE_COLLECTORS[database_name](datadir)
    data = collector.collect_data(sequences)

    sums: Dict[str, List[np.ndarray]] = {a: [] for a in articulators}
    for sentence in data:
        for frame_id in sentence["frame_ids"]:
            for articulator in articulators:
                arr, _ = prepare_articulator_array(
                    datadir,
                    sentence["subject"],
                    sentence["sequence"],
                    frame_id,
                    articulator,
                    config,
                    clip_tails=clip_tails,
                )
                sums[articulator].append(arr)

    stats = {}
    for articulator in articulators:
        stacked = np.stack(sums[articulator])  # (N, 2, D)
        mean = stacked.mean(axis=0)
        std = np.maximum(stacked.std(axis=0), 1e-6)
        stats[articulator] = {"mean": mean, "std": std}
        if save_to is not None:
            os.makedirs(save_to, exist_ok=True)
            np.save(os.path.join(save_to, f"{articulator}_mean.npy"), mean)
            np.save(os.path.join(save_to, f"{articulator}_std.npy"), std)
    return stats


class AutoencoderDataset:
    """Frame-level items: (frame_name, (Nart, 2*D) normalized contours,
    weight, phoneme) — reference PrincipalComponentsAutoencoderDataset2
    (dataset.py:30-107)."""

    def __init__(
        self,
        datadir: str,
        database_name: str,
        sequences,
        articulators: Sequence[str],
        clip_tails: bool = True,
        norm_stats: Optional[Dict] = None,
    ):
        self.datadir = datadir
        self.dataset_config = DATASET_CONFIG[database_name]
        self.articulators = sorted(articulators)
        self.clip_tails = clip_tails
        self.norm_stats = norm_stats

        collector = DATABASE_COLLECTORS[database_name](datadir)
        self.data = []
        for sentence in collector.collect_data(sequences):
            for frame_id, phoneme in zip(sentence["frame_ids"], sentence["phonemes"]):
                self.data.append(
                    {
                        "subject": sentence["subject"],
                        "sequence": sentence["sequence"],
                        "frame_id": frame_id,
                        "phoneme": phoneme,
                    }
                )

    def __len__(self):
        return len(self.data)

    def _load_frame(self, subject, sequence, frame_id) -> np.ndarray:
        arrays = []
        for articulator in self.articulators:
            arr, _ = prepare_articulator_array(
                self.datadir,
                subject,
                sequence,
                frame_id,
                articulator,
                self.dataset_config,
                clip_tails=self.clip_tails,
            )
            if self.norm_stats is not None:
                s = self.norm_stats[articulator]
                arr = (arr - s["mean"]) / s["std"]
            arrays.append(arr)
        stacked = np.stack(arrays)  # (Nart, 2, D)
        n_art = stacked.shape[0]
        return stacked.reshape(n_art, -1).astype(np.float32)

    def __getitem__(self, index: int) -> dict:
        item = self.data[index]
        frame_name = f"{item['subject']}_{item['sequence']}_{item['frame_id']}"
        return {
            "frame_name": frame_name,
            "inputs": self._load_frame(
                item["subject"], item["sequence"], item["frame_id"]
            ),
            "weight": np.float32(PHONEME_WEIGHTS.get(item["phoneme"], 1.0)),
            "phoneme": item["phoneme"],
        }

    def batches(self, batch_size: int, shuffle=True, seed=0, drop_last=False,
                pad_to_multiple: int = 1):
        """Fixed-shape frame batches: ({inputs (B, Nart, F), weights (B,)},
        {frame_names, phonemes, n_valid}) — arrays and metadata split so the
        batch dict can go straight into a step. Frames are chunked by
        ``batch_size`` and collated to its next multiple of
        ``pad_to_multiple`` with zero-weight dummies, so the batch splits
        evenly over a data-parallel mesh."""
        collate_bs = round_up_to_multiple(batch_size, pad_to_multiple)
        order = np.arange(len(self))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        for start in range(0, len(order), batch_size):
            idx = order[start : start + batch_size]
            if drop_last and len(idx) < batch_size:
                continue
            items = [self[i] for i in idx]
            n = len(items)
            inputs = np.stack([it["inputs"] for it in items])
            weights = np.array([it["weight"] for it in items], np.float32)
            if n < collate_bs:  # pad with zero-weight dummies
                pad = collate_bs - n
                inputs = np.concatenate([inputs, np.zeros((pad,) + inputs.shape[1:], np.float32)])
                weights = np.concatenate([weights, np.zeros(pad, np.float32)])
            batch = {"inputs": inputs, "weights": weights}
            meta = {
                "frame_names": [it["frame_name"] for it in items],
                "phonemes": [it["phoneme"] for it in items],
                "n_valid": n,
            }
            yield batch, meta


class PrincipalComponentsDataset:
    """Sentence-level dataset with NORMALIZED contour targets and TV
    critical masks from ``TV_to_phoneme_map`` — reference
    PrincipalComponentsPhonemeToArticulationDataset2 (dataset.py:110-221).

    Items share the ArtSpeechDataset schema so BucketedLoader collation
    applies unchanged; ``voicing`` is 1.0 for each token in ``voiced_tokens``.
    """

    def __init__(
        self,
        datadir: str,
        database_name: str,
        sequences,
        vocabulary: Dict[str, int],
        articulators: Sequence[str],
        TV_to_phoneme_map: Optional[Dict[str, Sequence[str]]] = None,
        clip_tails: bool = True,
        norm_stats: Optional[Dict] = None,
        voiced_tokens: Optional[Sequence[str]] = None,
    ):
        self.datadir = datadir
        self.dataset_config = DATASET_CONFIG[database_name]
        self.vocabulary = vocabulary
        self.articulators = sorted(articulators)
        self.TV_to_phoneme_map = TV_to_phoneme_map or {}
        self.clip_tails = clip_tails
        self.norm_stats = norm_stats
        self.voiced_tokens = set(voiced_tokens or [])

        collector = DATABASE_COLLECTORS[database_name](datadir)
        self.data = [
            d
            for d in collector.collect_data(sequences)
            if d["has_all"]
        ]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        item = self.data[index]
        tokens = item["phonemes"]
        frames, references = [], []
        for frame_id in item["frame_ids"]:
            arts, ref = [], None
            for articulator in self.articulators:
                arr, ref = prepare_articulator_array(
                    self.datadir,
                    item["subject"],
                    item["sequence"],
                    frame_id,
                    articulator,
                    self.dataset_config,
                    clip_tails=self.clip_tails,
                )
                if self.norm_stats is not None:
                    s = self.norm_stats[articulator]
                    arr = (arr - s["mean"]) / s["std"]
                arts.append(arr)
            frames.append(np.stack(arts))
            references.append(ref[None])

        token_ids = np.array(
            [token_id(t, self.vocabulary) for t in tokens], np.int32
        )
        tvs = sorted(self.TV_to_phoneme_map.keys())
        if tvs:
            critical = np.array(
                [
                    [int(p in self.TV_to_phoneme_map[tv]) for p in tokens]
                    for tv in tvs
                ],
                np.int32,
            )
        else:
            critical = np.zeros((0, len(tokens)), np.int32)

        return {
            "sentence_name": item["sentence_name"],
            "tokens": token_ids,
            "targets": np.stack(frames).astype(np.float32),
            "phonemes": list(tokens),
            "references": np.stack(references).astype(np.float32),
            "critical_masks": critical,
            "frame_ids": list(item["frame_ids"]),
            "voicing": np.array([float(t in self.voiced_tokens) for t in tokens], np.float32),
            "length": len(token_ids),
        }
