"""Bucketed fixed-shape batching (copy of artspeech_tpu/data/batching.py:
``DEFAULT_BUCKETS``, ``pick_bucket``, ``pad_to``,
``collate_articulation_batch``, ``round_up_to_multiple``, ``BucketedLoader``,
``CachedLoader``), and ``prefetch_to_device``, which copies batches to the
device one ahead and, on a mesh, keeps the rank's rows.

Sentences are padded up to a small set of bucket lengths, so the steps see a
few shapes only. Short batches are padded with zero-length dummy rows; every
loss and metric is padding-mask aware, so dummies contribute nothing.
"""

import collections
import logging
from typing import Dict, Iterator, List, Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device

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


def round_up_to_multiple(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` >= n (multiple <= 1: n itself).

    Shared by every loader that pads the collated batch so that it splits
    evenly over a data-parallel mesh's ranks.
    """
    m = max(int(multiple), 1)
    return ((int(n) + m - 1) // m) * m


class BucketedLoader:
    """Length-bucketed batch iterator over an ArtSpeechDataset-like dataset.

    Yields (batch_dict, meta) with static shapes per (bucket, batch_size).
    Sentences are chunked by ``batch_size`` (the configured batch's gradient
    semantics) and collated to ``collate_batch_size``, the next multiple of
    ``pad_to_multiple``, with zero-length dummy rows, so the batch splits
    evenly over a data-parallel mesh. ``drop_last`` skips a short chunk;
    ``cache_items`` keeps every item once loaded.
    """

    def __init__(
        self,
        dataset,
        batch_size: int,
        buckets: Sequence[int] = DEFAULT_BUCKETS,
        shuffle: bool = True,
        seed: int = 0,
        drop_last: bool = False,
        cache_items: bool = True,
        pad_to_multiple: int = 1,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.buckets = tuple(sorted(buckets))
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_batch_size = round_up_to_multiple(batch_size, pad_to_multiple)
        self._epoch = 0
        self._cache = [None] * len(dataset) if cache_items else None

    def _get(self, i: int) -> dict:
        if self._cache is None:
            return self.dataset[i]
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
                chunk = indices[start : start + self.batch_size]
                if self.drop_last and len(chunk) < self.batch_size:
                    continue
                items = [self._get(i) for i in chunk]
                yield collate_articulation_batch(items, bucket, self.collate_batch_size)


def prefetch_to_device(iterator, size: int = 2, sharding=None, device: DeviceLike = None):
    """Yield an iterator's (batch, meta) pairs with the batch's arrays as
    tensors on the device, ``size - 1`` batches ahead: on CUDA from pinned
    host memory with ``non_blocking=True``, so the next batch's copy overlaps
    the current step. With ``sharding`` (``parallel.mesh.batch_sharding``)
    only the rank's rows are copied, to the mesh's device; ``meta`` stays
    global and on the host. ``device``: ``cuda`` unless the caller passes
    ``device="cpu"`` (ignored with a ``sharding``)."""
    device = sharding.mesh.device if sharding is not None else resolve_device(device)
    pinned = device.type == "cuda"

    def put(batch):
        out = {}
        for key, value in batch.items():
            host = torch.from_numpy(np.ascontiguousarray(value))
            if sharding is not None:
                host = host[sharding.rows(host.shape[0])]
            if pinned:
                host = host.pin_memory()
            out[key] = host.to(device, non_blocking=pinned)
        return out

    queue = collections.deque()
    for batch, meta in iterator:
        queue.append((put(batch), meta))
        if len(queue) >= size:
            yield queue.popleft()
    while queue:
        yield queue.popleft()


class CachedLoader:
    """Materialise a loader's batches once and replay them (a deterministic
    eval loader would otherwise collate the same batches every epoch)."""

    def __init__(self, loader):
        self._loader = loader
        self._batches = None

    def __getattr__(self, name):
        # Delegate the loader's attributes (batch_size, collate_batch_size,
        # ...), never underscored ones: copy and unpickle probe attributes
        # before __init__ ran, and self._loader would recurse.
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._loader, name)

    def __len__(self):
        return len(self._batches) if self._batches is not None else len(self._loader)

    def __iter__(self):
        if self._batches is None:
            self._batches = list(self._loader)
        return iter(self._batches)
