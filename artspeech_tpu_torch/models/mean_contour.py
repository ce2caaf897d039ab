"""Phoneme-wise mean-contour baseline, method A (counterpart of
artspeech_tpu/models/mean_contour.py).

Equivalent of reference phoneme_wise_mean_contour/__init__.py:19-159:
"training" collects per-frame (token, contour) rows, inference returns the
per-token mean contour (optionally mixed over the frame's relative position
inside its phoneme). As in the JAX package, training reduces the corpus into
a dense lookup table

    table[token]            -> (Nart, 2, D) mean contour, or
    table[token, pos_bin]   -> (Nart, 2, D), the positional variant,

and inference is a gather (plain torch on the device; no kernel lies under
it). The table is fitted with numpy on the host and saved as the same
``.npz`` (``table``, ``counts``, ``positional``), so a table written by either
package loads in the other.
"""

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device


@dataclass
class MeanContourTable:
    """Dense per-token (optionally per-position-bin) mean contour table."""

    table: np.ndarray  # (V, Nart, 2, D) or (V, K, Nart, 2, D)
    counts: np.ndarray  # (V,) or (V, K)
    positional: bool = False

    @property
    def n_bins(self) -> int:
        return self.table.shape[1] if self.positional else 1

    def save(self, path: str):
        np.savez(path, table=self.table, counts=self.counts, positional=self.positional)

    @classmethod
    def load(cls, path: str) -> "MeanContourTable":
        z = np.load(path)
        return cls(table=z["table"], counts=z["counts"], positional=bool(z["positional"]))


def relative_positions(tokens: Sequence[int]) -> np.ndarray:
    """Relative position in (0, 1] of each frame inside its phoneme run
    (reference phoneme_wise_mean_contour/__init__.py:19-29)."""
    tokens = list(tokens)
    rel = np.zeros(len(tokens), dtype=np.float32)
    i = 0
    while i < len(tokens):
        j = i
        while j < len(tokens) and tokens[j] == tokens[i]:
            j += 1
        run = j - i
        for k in range(run):
            rel[i + k] = (k + 1) / run
        i = j
    return rel


def fit_mean_contour(dataset, vocab_size: int, n_bins: int = 0, sample_frac: float = 1.0,
                     seed: int = 0) -> MeanContourTable:
    """Accumulate per-token (x position bin) contour means over a dataset.

    Args:
        dataset: ArtSpeechDataset-like; items carry ``tokens`` (T,) ids and
            ``targets`` (T, Nart, 2, D).
        n_bins: 0 -> plain per-token mean; > 0 -> that many position bins,
            each empty bin backfilled with its token's overall mean.
        sample_frac: fraction of frames kept, drawn per frame from
            ``np.random.default_rng(seed)`` as JAX draws them; 1.0 keeps all.
    """
    rng = np.random.default_rng(seed)
    positional = n_bins > 0
    k = max(n_bins, 1)
    sums = None
    counts = np.zeros((vocab_size, k), dtype=np.int64)
    for idx in range(len(dataset)):
        item = dataset[idx]
        tokens = np.asarray(item["tokens"])
        targets = np.asarray(item["targets"], dtype=np.float64)
        if sums is None:
            sums = np.zeros((vocab_size, k) + targets.shape[1:], dtype=np.float64)
        if positional:
            bins = np.minimum((relative_positions(tokens) * k).astype(np.int64), k - 1)
        else:
            bins = np.zeros(len(tokens), dtype=np.int64)
        keep = (rng.random(len(tokens)) < sample_frac if sample_frac < 1.0
                else np.ones(len(tokens), bool))
        for t in np.nonzero(keep)[0]:
            sums[tokens[t], bins[t]] += targets[t]
            counts[tokens[t], bins[t]] += 1

    safe = np.maximum(counts, 1)[(...,) + (None,) * 3]
    table = (sums / safe).astype(np.float32)
    if positional:
        tok_counts = counts.sum(axis=1)
        tok_mean = sums.sum(axis=1) / np.maximum(tok_counts, 1)[:, None, None, None]
        empty = counts == 0
        table[empty] = tok_mean.astype(np.float32)[np.nonzero(empty)[0]]
        return MeanContourTable(table=table, counts=counts, positional=True)
    return MeanContourTable(table=table[:, 0], counts=counts[:, 0], positional=False)


def fit_mean_contour_reference_sampling(dataset, vocab_size: int, frac: float = 0.1,
                                        random_state: int = 0) -> MeanContourTable:
    """The reference's fixed-seed row subsample per token, precomputed.

    Reference phoneme_wise_mean_contour/__init__.py:103,130-135 averages
    ``df[df.token == token].sample(frac=0.1, random_state=0)``. pandas picks
    those rows as the first ``round(frac * n)`` of
    ``np.random.RandomState(random_state).permutation(n)``; the port draws
    them so, without pandas (which it does not import). A token whose
    ``round(frac * n)`` is 0 would crash the reference; it uses all of its
    rows here, as in JAX.
    """
    per_token = [[] for _ in range(vocab_size)]
    shape = None
    for idx in range(len(dataset)):
        item = dataset[idx]
        tokens = np.asarray(item["tokens"])
        targets = np.asarray(item["targets"], dtype=np.float32)
        shape = targets.shape[1:]
        for t, tok in enumerate(tokens):
            per_token[int(tok)].append(targets[t])
    if shape is None:
        raise ValueError("empty dataset")
    table = np.zeros((vocab_size,) + shape, dtype=np.float32)
    counts = np.zeros(vocab_size, dtype=np.int64)
    for tok, rows in enumerate(per_token):
        if not rows:
            continue
        n = len(rows)
        pos = np.random.RandomState(random_state).permutation(n)[:round(frac * n)]
        chosen = [rows[p] for p in pos] if len(pos) else rows
        table[tok] = np.mean(np.stack(chosen, axis=0), axis=0)
        counts[tok] = len(chosen)
    return MeanContourTable(table=table, counts=counts, positional=False)


def make_mean_contour_forward(table: MeanContourTable, beta: float = 10.0,
                              device: DeviceLike = None):
    """The table's forward on ``device`` (``cuda`` unless the caller passes
    ``device="cpu"``): ``forward(tokens (B, T), lengths=None,
    rel_positions=None)`` -> (B, T, Nart, 2, D) float32.

    Plain table: one gather. Positional table: a softmin mix over the bins by
    |bin centre - relative position| with weight ``beta`` (relative positions
    0.5 when not given), as JAX's forward.
    """
    dev = resolve_device(device)
    values = torch.as_tensor(table.table, device=dev)

    if not table.positional:
        def forward(tokens, lengths=None, rel_positions=None):
            return values[torch.as_tensor(tokens, device=dev).long()]

        return forward

    k = table.n_bins
    centers = (torch.arange(k, dtype=values.dtype, device=dev) + 0.5) / k

    def forward(tokens, lengths=None, rel_positions=None):
        tokens = torch.as_tensor(tokens, device=dev).long()
        if rel_positions is None:
            rel_positions = torch.full(tokens.shape, 0.5, dtype=values.dtype, device=dev)
        rel = torch.as_tensor(rel_positions, dtype=values.dtype, device=dev)
        w = torch.softmax(-beta * (rel[..., None] - centers).abs(), dim=-1)  # (B, T, K)
        return torch.einsum("btk,btk...->bt...", w, values[tokens])

    return forward
