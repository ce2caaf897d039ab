"""Bucketed fixed-shape batching (copy of artspeech_tpu/data/batching.py:
``DEFAULT_BUCKETS``, ``pick_bucket``, ``pad_to``,
``collate_articulation_batch``, ``BucketedLoader``),
and :func:`to_device`, the single-device counterpart of its
``prefetch_to_device``.

Sentences are padded up to a small set of bucket lengths, so the steps see a
few shapes only. Short batches are padded with zero-length dummy rows; every
loss and metric is padding-mask aware, so dummies contribute nothing.
"""

import logging
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

logger = logging.getLogger(__name__)

DEFAULT_BUCKETS = (32, 64, 128, 256, 512)


def pick_bucket(length: int, buckets: Sequence[int]) -> int:
    for b in buckets:
        if length <= b:
            return b
    return buckets[-1]


def pad_to(arr: np.ndarray, length: int, pad_value=0.0) -> np.ndarray:
    """Pad (or truncate) axis 0 of arr to ``length``."""
    if arr.shape[0] >= length:
        return arr[:length]
    pad_width = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad_width, constant_values=pad_value)


def collate_articulation_batch(
    items: List[dict],
    bucket: int,
    batch_size: int,
    voicing_pad: float = -1.0,
) -> Dict[str, np.ndarray]:
    """Pad a list of ArtSpeechDataset items to a fixed-shape batch dict.

    The torch collate sorts by descending length for pack_padded
    (reference dataset.py:29-32); masked scans need no sorting, but we keep
    it for deterministic parity of batch statistics.
    """
    items = sorted(items, key=lambda it: -it["length"])
    sample = items[0]
    n_art, _, n_samples = sample["targets"].shape[1:]
    n_tv = sample["critical_masks"].shape[0]

    batch = {
        "tokens": np.zeros((batch_size, bucket), np.int32),
        "targets": np.zeros((batch_size, bucket, n_art, 2, n_samples), np.float32),
        "references": np.zeros((batch_size, bucket, 1, 2, n_samples), np.float32),
        "critical_masks": np.zeros((batch_size, n_tv, bucket), np.int32),
        "voicing": np.full((batch_size, bucket), voicing_pad, np.float32),
        "lengths": np.zeros((batch_size,), np.int32),
    }
    names, phonemes, frame_ids = [], [], []
    for i, item in enumerate(items):
        L = min(item["length"], bucket)
        batch["tokens"][i, :L] = item["tokens"][:L]
        batch["targets"][i, :L] = item["targets"][:L]
        batch["references"][i, :L] = item["references"][:L]
        if n_tv:
            batch["critical_masks"][i, :, :L] = item["critical_masks"][:, :L]
        batch["voicing"][i, :L] = item["voicing"][:L]
        batch["lengths"][i] = L
        names.append(item["sentence_name"])
        phonemes.append(item["phonemes"][:L])
        frame_ids.append(item["frame_ids"][:L])
    meta = {
        "sentence_names": names,
        "phonemes": phonemes,
        "frame_ids": frame_ids,
        "n_real": len(items),
    }
    return batch, meta


class BucketedLoader:
    """Length-bucketed batch iterator over an ArtSpeechDataset-like dataset.

    Yields (batch_dict, meta) with static shapes per (bucket, batch_size).
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        shuffle: bool = True,
        seed: int = 0,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.seed = seed
        self._epoch = 0
        self._cache = [None] * len(dataset)

    def _get(self, i: int) -> dict:
        if self._cache[i] is None:
            self._cache[i] = self.dataset[i]
        return self._cache[i]

    def __len__(self):
        # Upper bound on number of batches (bucket split may add a few).
        n = len(self.dataset)
        return (n + self.batch_size - 1) // self.batch_size

    def _length(self, i: int) -> int:
        # Collector metadata gives the length for free; materializing the
        # item (full contour IO) just to read one int would force the whole
        # dataset to load before the first batch.
        data = getattr(self.dataset, "data", None)
        if data is not None and "frame_ids" in data[i]:
            return len(data[i]["frame_ids"])
        return self._get(i)["length"]

    def __iter__(self) -> Iterator:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self._epoch)
            rng.shuffle(order)
        self._epoch += 1

        lengths = [self._length(i) for i in order]
        buckets = self.buckets
        max_len = max(lengths, default=0)
        if buckets and max_len > buckets[-1]:
            # Never silently truncate: extend the bucket list (one more
            # shape) and say so.
            extended = ((max_len + 63) // 64) * 64
            logger.warning(
                "Longest sentence (%d frames) exceeds the largest bucket "
                "(%d); adding a %d-frame bucket.",
                max_len, buckets[-1], extended,
            )
            buckets = buckets + (extended,)

        by_bucket: Dict[int, List[int]] = {}
        for i, L in zip(order, lengths):
            by_bucket.setdefault(pick_bucket(L, buckets), []).append(int(i))

        for bucket in sorted(by_bucket):
            indices = by_bucket[bucket]
            for start in range(0, len(indices), self.batch_size):
                items = [self._get(i) for i in indices[start : start + self.batch_size]]
                yield collate_articulation_batch(items, bucket, self.batch_size)


def to_device(loader, device):
    """Yield a loader's (batch, meta) pairs with the batch's arrays as tensors
    on ``device``, copied one batch ahead: on CUDA from pinned host memory
    with ``non_blocking=True``, so the next batch's copy overlaps the current
    step. ``meta`` stays on the host."""
    device = torch.device(device)
    pinned = device.type == "cuda"

    def put(batch):
        out = {}
        for key, value in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(value))
            if pinned:
                host = host.pin_memory()
            out[key] = host.to(device, non_blocking=pinned)
        return out

    pending = None
    for batch, meta in loader:
        item = (put(batch), meta)
        if pending is not None:
            yield pending
        pending = item
    if pending is not None:
        yield pending
