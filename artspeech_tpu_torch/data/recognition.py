"""Datasets for the phoneme recognizer (copy of the real-corpus part of
artspeech_tpu/data/recognition.py, on one device).

Equivalents of reference phoneme_recognition/datasets.py:51-302
(``PhonemeRecognitionDataset`` + ``collate_fn``) and synthetic_shapes.py:38-158
(``SyntheticPhonemeRecognitionDataset``, over a synthesized corpus). Items carry RAW audio
(resampled to 16 kHz host-side) and the mel spectrogram is computed on the
device by the train and eval steps (ops/melspec.py). Contour and air-column
features stay host-loaded in the reference (C, D, T) layout. Batches are
padded to fixed bucket lengths and to ``batch_size`` rows; padded rows have
``input_lengths`` 0.
"""

import logging
import os
from glob import glob
from itertools import groupby
from typing import Dict, List, Optional, Sequence

import numpy as np

from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import token_id
from artspeech_tpu_torch.data.audio import read_wav
from artspeech_tpu_torch.data.batching import pick_bucket, round_up_to_multiple
from artspeech_tpu_torch.data.collectors import DATABASE_COLLECTORS
from artspeech_tpu_torch.data.loaders import VocalTractShapeLoader, cached_load_articulator_array

MELSPEC = "melspec"
VOCAL_TRACT = "vocal_tract"
AIR_COLUMN = "air_column"
FEATURES = (MELSPEC, VOCAL_TRACT, AIR_COLUMN)

TARGET_CTC = "ctc_target"
TARGET_ACOUSTIC = "acoustic_target"
TARGET_ARTICULATORY = "articulatory_target"

#: The configs' ``target`` names -> batch keys.
TARGET_KEYS = {"ctc": TARGET_CTC, "acoustic": TARGET_ACOUSTIC,
               "articulatory": TARGET_ARTICULATORY}


def resample_audio(audio: np.ndarray, orig_sr: int, new_sr: int) -> np.ndarray:
    if orig_sr == new_sr:
        return audio
    n_new = int(round(len(audio) * new_sr / orig_sr))
    x_old = np.linspace(0.0, 1.0, len(audio), endpoint=False)
    x_new = np.linspace(0.0, 1.0, n_new, endpoint=False)
    return np.interp(x_new, x_old, audio).astype(np.float32)


class PhonemeRecognitionDataset:
    """Sentence items with melspec-audio / vocal-tract / air-column features
    and CTC / acoustic / articulatory targets."""

    def __init__(
        self,
        datadir: str,
        database_name: str,
        sequences,
        vocabulary: Dict[str, int],
        features: Sequence[str],
        sample_rate: int = 16000,
        hop_length: int = 256,
        articulators: Sequence[str] = None,
        num_samples: int = 50,
        voiced_tokens: Optional[Sequence[str]] = None,
        tmp_dir: Optional[str] = None,
        clip_tails: bool = True,
    ):
        self.datadir = datadir
        self.dataset_config = DATASET_CONFIG[database_name]
        self.vocabulary = vocabulary
        self.features = list(features)
        self.sample_rate = sample_rate
        self.hop_length = hop_length
        self.voiced_tokens = set(voiced_tokens or [])
        self.articulators = list(articulators or RECOGNITION_ARTICULATORS)

        save_audio_dir = None
        if tmp_dir is not None:
            save_audio_dir = os.path.join(tmp_dir, "audios")
            os.makedirs(save_audio_dir, exist_ok=True)
        elif MELSPEC in self.features:
            # Without per-sentence wav extraction the item would load the
            # FULL sequence recording while acoustic targets assume
            # sentence-relative times — silently misaligned. Fail fast.
            raise ValueError(
                "features=[melspec] requires tmp_dir so collectors can slice "
                "per-sentence wavs (reference passes TMP_DIR, "
                "train_phoneme_recognition.py:143)."
            )
        collector = DATABASE_COLLECTORS[database_name](datadir, save_audio_dir)
        self.data = collector.collect_data(sequences)
        self.vocal_tract_loader = VocalTractShapeLoader(
            datadir=datadir,
            articulators=self.articulators,
            num_samples=num_samples,
            dataset_config=self.dataset_config,
            clip_tails=clip_tails,
        )

    def __len__(self):
        return len(self.data)

    def _coord_system_reference(self, subject, sequence, frame_id) -> np.ndarray:
        """Last upper-incisor point as (2, 1) (reference datasets.py:134-150)."""
        fp = os.path.join(
            self.datadir,
            subject,
            sequence,
            "inference_contours",
            f"{frame_id}_{UPPER_INCISOR}.npy",
        )
        ref = cached_load_articulator_array(fp, norm_value=self.dataset_config.RES).T
        return ref[:, -1:]

    def load_air_column(self, subject, sequence, frame_ids) -> np.ndarray:
        """(T, 2, 2, 100) recentered air columns (reference datasets.py:151-165)."""
        frames = []
        for frame_id in frame_ids:
            ref = self._coord_system_reference(subject, sequence, frame_id)
            fp = os.path.join(
                self.datadir, subject, sequence, "air_column", f"{frame_id}.npy"
            )
            arr = np.load(fp).astype(np.float32)  # (2, 2, D)
            arr = arr - ref  # broadcast over walls
            arr = arr + 0.3
            frames.append(arr)
        return np.stack(frames, axis=0)

    def __getitem__(self, index: int) -> dict:
        item = self.data[index]
        phonemes = item["phonemes"]
        frame_ids = item["frame_ids"]
        sample = {"sentence_name": item["sentence_name"]}

        if MELSPEC in self.features:
            # Collectors already slice per-sentence wavs when tmp_dir is set.
            audio, sr = read_wav(item["wav_filepath"])
            audio = resample_audio(audio, sr, self.sample_rate)
            sample["audio"] = audio.astype(np.float32)
            sample["audio_length"] = len(audio)
            # center=True STFT frame count.
            melspec_length = len(audio) // self.hop_length + 1
            sample[f"{MELSPEC}_length"] = melspec_length
            # Frame-aligned acoustic CE targets (reference datasets.py:209-220).
            acoustic = np.zeros((melspec_length,), np.int32)
            duration = item["audio_duration"]
            for phoneme, start, end in item["phonemes_with_time"]:
                token = token_id(phoneme, self.vocabulary)
                lo = int(start * melspec_length / duration)
                hi = int(end * melspec_length / duration)
                acoustic[lo:hi] = token
            sample[TARGET_ACOUSTIC] = acoustic
            sample[f"{TARGET_ACOUSTIC}_length"] = melspec_length

        if VOCAL_TRACT in self.features:
            shapes, _, T = self.vocal_tract_loader.load_vocal_tract_shapes(
                item["subject"], item["sequence"], frame_ids
            )  # (T, Nart, 2, D)
            # -> (C, Nart * D, T) reference layout (datasets.py:186-196).
            vt = shapes.transpose(2, 1, 3, 0)
            c, n, d, t = vt.shape
            sample[VOCAL_TRACT] = vt.reshape(c, n * d, t)
            sample[f"{VOCAL_TRACT}_length"] = T

        if AIR_COLUMN in self.features:
            air = self.load_air_column(item["subject"], item["sequence"], frame_ids)
            ac = air.transpose(2, 1, 3, 0)  # (C, walls, D, T)
            c, w, d, t = ac.shape
            sample[AIR_COLUMN] = ac.reshape(c, w * d, t)
            sample[f"{AIR_COLUMN}_length"] = t

        return self._add_targets(sample, phonemes)

    def _add_targets(self, sample: dict, phonemes: Sequence[str]) -> dict:
        """The articulatory and CTC token targets and the voicing of a
        sentence's phonemes, added to ``sample``."""
        token_ids = np.array(
            [token_id(p, self.vocabulary) for p in phonemes], np.int32
        )
        sample[TARGET_ARTICULATORY] = token_ids
        sample[f"{TARGET_ARTICULATORY}_length"] = len(token_ids)
        sample["voicing"] = np.array(
            [float(p in self.voiced_tokens) for p in phonemes], np.float32
        )
        ctc_tokens = np.array(
            [token_id(p, self.vocabulary) for p, _ in groupby(phonemes)], np.int32
        )
        sample[TARGET_CTC] = ctc_tokens
        sample[f"{TARGET_CTC}_length"] = len(ctc_tokens)
        return sample


class SyntheticPhonemeRecognitionDataset(PhonemeRecognitionDataset):
    """Recognition dataset over a SYNTHESIZED corpus (what
    ``synth.pipeline.synthesize_corpus`` and the generate CLI write): closes
    the synthesize -> recognize -> PER loop (reference
    synthetic_shapes.py:38-158).

    Directory schema per sentence: {datadir}/{subject}/{sentence_name}/
    {air_column,inference_contours}/*.npy + target_sequence.txt. Frames are
    the sentence's ``air_column/*.npy``; a sentence without any is skipped.
    ``melspec`` is dropped from ``features`` (a synthesized corpus has no
    audio).
    """

    def __init__(
        self,
        datadir: str,
        sequences,  # (subject, sentence_name) pairs
        vocabulary: Dict[str, int],
        features: Sequence[str],
        database_name: str = "artspeech",
        articulators: Sequence[str] = None,
        voiced_tokens: Optional[Sequence[str]] = None,
    ):
        self.datadir = datadir
        self.dataset_config = DATASET_CONFIG[database_name]
        self.vocabulary = vocabulary
        self.features = [f for f in features if f != MELSPEC]
        self.voiced_tokens = set(voiced_tokens or [])
        self.articulators = list(articulators or RECOGNITION_ARTICULATORS)
        self.data = self._collect(sequences)

    def _collect(self, sequences) -> List[dict]:
        data = []
        for subject, sentence_name in sequences:
            sentence_dir = os.path.join(self.datadir, subject, sentence_name)
            frame_fps = glob(os.path.join(sentence_dir, "air_column", "*.npy"))
            frame_ids = sorted(os.path.basename(fp).split(".")[0] for fp in frame_fps)
            if not frame_ids:
                continue
            with open(os.path.join(sentence_dir, "target_sequence.txt")) as f:
                phonemes = f.read().strip().split()
            data.append({
                "subject": subject,
                "sequence": sentence_name,
                "sentence_name": f"{subject}-{sentence_name}",
                "frame_ids": frame_ids,
                "phonemes": phonemes,
                "phonemes_with_time": [],
                "audio_duration": len(frame_ids) / self.dataset_config.FRAMERATE,
            })
        return data

    def __getitem__(self, index: int) -> dict:
        """Load the synthesized npys RAW: they are already in model-output
        space (normalized, incisor-recentered); the recorded corpus's 1/RES
        scaling and re-centring would corrupt them (reference
        synthetic_shapes.py:86-130 also loads them verbatim)."""
        item = self.data[index]
        frame_ids = item["frame_ids"]
        sample = {"sentence_name": item["sentence_name"]}
        base = os.path.join(self.datadir, item["subject"], item["sequence"])

        if VOCAL_TRACT in self.features:
            frames = [np.stack([
                np.load(os.path.join(base, "inference_contours", f"{frame_id}_{a}.npy"))
                .astype(np.float32) for a in self.articulators]) for frame_id in frame_ids]
            vt = np.stack(frames).transpose(2, 1, 3, 0)  # (C, Nart, D, T)
            c, n, d, t = vt.shape
            sample[VOCAL_TRACT] = vt.reshape(c, n * d, t)
            sample[f"{VOCAL_TRACT}_length"] = t

        if AIR_COLUMN in self.features:
            cols = [np.load(os.path.join(base, "air_column", f"{frame_id}.npy")).astype(np.float32)
                    for frame_id in frame_ids]  # each (2, 2, D)
            ac = np.stack(cols).transpose(2, 1, 3, 0)  # (C, walls, D, T)
            c, w, d, t = ac.shape
            sample[AIR_COLUMN] = ac.reshape(c, w * d, t)
            sample[f"{AIR_COLUMN}_length"] = t

        return self._add_targets(sample, item["phonemes"])

    @staticmethod
    def sequences_from_corpus(datadir: str) -> List:
        """All (subject, sentence_name) pairs under a synthetic corpus dir."""
        pairs = []
        for subject in sorted(os.listdir(datadir)):
            subj_dir = os.path.join(datadir, subject)
            if not os.path.isdir(subj_dir):
                continue
            for name in sorted(os.listdir(subj_dir)):
                if os.path.isdir(os.path.join(subj_dir, name)):
                    pairs.append((subject, name))
        return pairs


def collate_recognition_batch(
    items: List[dict],
    feature: str,
    bucket: int,
    batch_size: int,
    hop_length: int = 256,
) -> Dict[str, np.ndarray]:
    """Pad a list of items into fixed-shape arrays.

    For MELSPEC the batch carries raw ``audio`` (B, S) — the step computes
    the spectrogram on the device; ``bucket`` is then the number of melspec
    FRAMES and S = (bucket - 1) * hop_length. Targets are cut to ``bucket``.
    Features and voicing pad with -1.0, targets with -1; rows past the items
    have ``input_lengths`` 0.
    """
    batch: Dict[str, np.ndarray] = {}
    n = len(items)
    if feature == MELSPEC:
        s = (bucket - 1) * hop_length
        batch["audio"] = np.zeros((batch_size, s), np.float32)
        for i, it in enumerate(items):
            a = it["audio"][:s]
            batch["audio"][i, : len(a)] = a
        batch["input_lengths"] = np.array(
            [min(it[f"{MELSPEC}_length"], bucket) for it in items]
            + [0] * (batch_size - n),
            np.int32,
        )
    else:
        sample = items[0][feature]
        c, d = sample.shape[:2]
        batch["features"] = np.full((batch_size, c, d, bucket), -1.0, np.float32)
        for i, it in enumerate(items):
            t = min(it[feature].shape[-1], bucket)
            batch["features"][i, :, :, :t] = it[feature][..., :t]
        batch["input_lengths"] = np.array(
            [min(it[f"{feature}_length"], bucket) for it in items]
            + [0] * (batch_size - n),
            np.int32,
        )

    tgt_len = bucket
    for name in (TARGET_CTC, TARGET_ACOUSTIC, TARGET_ARTICULATORY):
        if name not in items[0]:
            continue
        batch[name] = np.full((batch_size, tgt_len), -1, np.int32)
        lengths = np.zeros((batch_size,), np.int32)
        for i, it in enumerate(items):
            arr = it[name][:tgt_len]
            batch[name][i, : len(arr)] = arr
            lengths[i] = min(it[f"{name}_length"], tgt_len)
        batch[f"{name}_lengths"] = lengths

    batch["voicing"] = np.full((batch_size, bucket), -1.0, np.float32)
    for i, it in enumerate(items):
        v = it["voicing"][:bucket]
        batch["voicing"][i, : len(v)] = v
    meta = {
        "sentence_names": [it["sentence_name"] for it in items],
        "n_real": len(items),
    }
    return batch, meta


class RecognitionLoader:
    """Bucketed loader over a PhonemeRecognitionDataset for one feature.
    ``pad_to_multiple`` rounds the collated batch up with rows of input
    length 0 (JAX data/recognition.py:388-409)."""

    def __init__(
        self,
        dataset,
        feature: str,
        batch_size: int,
        buckets: Sequence[int] = (64, 128, 256, 512),
        shuffle: bool = True,
        seed: int = 0,
        hop_length: int = 256,
        pad_to_multiple: int = 1,
    ):
        self.dataset = dataset
        self.feature = feature
        self.batch_size = batch_size
        # Chunked by batch_size, collated to a multiple of pad_to_multiple
        # (rows of input length 0) so the batch splits over a mesh's ranks.
        self.collate_batch_size = round_up_to_multiple(batch_size, pad_to_multiple)
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.seed = seed
        self.hop_length = hop_length
        self._epoch = 0
        self._cache = [None] * len(dataset)

    def _get(self, i):
        """Items are loaded once and kept (the dataset reads files)."""
        if self._cache[i] is None:
            self._cache[i] = self.dataset[i]
        return self._cache[i]

    def __len__(self):
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        length_key = f"{self.feature}_length"
        lengths = [self._get(int(i))[length_key] for i in order]
        buckets = self.buckets
        max_len = max(lengths, default=0)
        if buckets and max_len > buckets[-1]:
            extended = ((max_len + 63) // 64) * 64
            logging.getLogger(__name__).warning(
                "Longest %s sequence (%d) exceeds the largest bucket (%d); "
                "adding a %d bucket.",
                self.feature, max_len, buckets[-1], extended,
            )
            buckets = buckets + (extended,)
        by_bucket: Dict[int, List[int]] = {}
        for i, L in zip(order, lengths):
            by_bucket.setdefault(pick_bucket(L, buckets), []).append(int(i))
        for bucket in sorted(by_bucket):
            indices = by_bucket[bucket]
            for start in range(0, len(indices), self.batch_size):
                items = [self._get(i) for i in indices[start : start + self.batch_size]]
                yield collate_recognition_batch(
                    items,
                    self.feature,
                    bucket,
                    self.collate_batch_size,
                    hop_length=self.hop_length,
                )
