"""Sentence datasets for phoneme-to-articulation experiments (copy of
artspeech_tpu/data/datasets.py).

Equivalent of reference phoneme_to_articulation/encoder_decoder/dataset.py:
131-224 (``ArtSpeechDataset``), producing per-sentence numpy items consumed
by the bucketed batcher (data/batching.py) instead of a torch DataLoader +
pad_sequence collate.
"""

from typing import Dict, Optional, Sequence

import numpy as np

from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.vocab import token_id
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.loaders import prepare_articulator_array

#: Critical phonemes per tract variable (reference encoder_decoder/dataset.py:19-24).
PHONEMES_PER_TV = {
    "LA": ("p", "b", "m"),
    "TTCD": ("l", "d", "n", "t"),
    "TBCD": ("k", "g"),
    "VEL": (),
}


def critical_mask(TVs: Sequence[str], phonemes: Sequence[str]) -> np.ndarray:
    """(Ntv, T) int mask: 1 where the phoneme is critical for the TV."""
    return np.array(
        [[int(p in PHONEMES_PER_TV.get(tv, ())) for p in phonemes] for tv in TVs],
        dtype=np.int32,
    )


class ArtSpeechDataset:
    """Sentence -> dict with tokens, contour targets, references, masks and
    the voicing (1.0 for each token in ``voiced_tokens``)."""

    def __init__(
        self,
        datadir: str,
        database_name: str,
        sequences,
        vocabulary: Dict[str, int],
        articulators: Sequence[str],
        clip_tails: bool = False,
        TVs: Optional[Sequence[str]] = None,
        voiced_tokens: Optional[Sequence[str]] = None,
    ):
        self.vocabulary = vocabulary
        self.datadir = datadir
        self.articulators = sorted(articulators)
        self.clip_tails = clip_tails
        self.TVs = sorted(TVs) if TVs else []
        self.dataset_config = DATASET_CONFIG[database_name]
        self.voiced_tokens = set(voiced_tokens or [])

        collector = DATABASE_COLLECTORS[database_name](datadir)
        data = collector.collect_data(sequences)
        self.data = [d for d in data if d["has_all"]]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index: int) -> dict:
        item = self.data[index]
        frame_ids = item["frame_ids"]
        tokens = item["phonemes"]

        frames = []
        references = []
        for frame_id in frame_ids:
            arts = []
            ref = None
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
                arts.append(arr)
            frames.append(np.stack(arts, axis=0))  # (Nart, 2, D)
            references.append(ref[None])  # (1, 2, D)

        targets = np.stack(frames, axis=0).astype(np.float32)  # (T, Nart, 2, D)
        reference_arrays = np.stack(references, axis=0).astype(np.float32)

        token_ids = np.array(
            [token_id(token, self.vocabulary) for token in tokens], dtype=np.int32
        )
        return {
            "sentence_name": item["sentence_name"],
            "tokens": token_ids,
            "targets": targets,
            "phonemes": list(tokens),
            "references": reference_arrays,
            "critical_masks": critical_mask(self.TVs, tokens),
            "frame_ids": list(frame_ids),
            "voicing": np.array([float(token in self.voiced_tokens) for token in tokens],
                                np.float32),
            "length": len(token_ids),
        }
