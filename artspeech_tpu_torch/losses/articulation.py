"""Losses and metrics for phoneme-to-articulation models (counterpart of
artspeech_tpu/losses/articulation.py: ``masked_euclidean_loss``,
``p2cp_distance_mm``, ``euclidean_distance_mm`` and
``recognition_feature_loss``).

Masked reductions over padded (B, T, Nart, 2, D) contour batches: the
per-sentence mean over valid frames is a masked sum, no host loop. The masked
means are also exposed split, as (numerator, count) (``masked_euclidean_parts``,
``recognition_feature_parts``, ``p2cp_distance_mm(reduce=False)``), so that a
step over microbatches or ranks divides each part by the whole batch's count.
"""

from typing import Optional

import torch

from artspeech_tpu_torch.core.config import DatasetConfig, mm_per_unit
from artspeech_tpu_torch.ops.distances import euclidean_distance, mean_p2cp_channel_major
from artspeech_tpu_torch.utils.masks import make_padding_mask


def masked_euclidean_loss(outputs, targets, lengths):
    """Mean per-point Euclidean distance over valid frames.

    Args:
        outputs, targets: (B, T, Nart, 2, D); lengths: (B,) valid frames.
    Returns:
        scalar (reference train_phoneme_to_articulation.py:85-90).
    """
    num, n_frames = masked_euclidean_parts(outputs, targets, lengths)
    return num / euclidean_denominator(n_frames, outputs)


def masked_euclidean_parts(outputs, targets, lengths):
    """``(numerator, n_frames)`` of :func:`masked_euclidean_loss`: the point
    distances summed over valid frames, and the number of valid frames."""
    dist = euclidean_distance(outputs, targets)  # (B, T, Nart, D)
    mask = make_padding_mask(lengths, outputs.shape[1])
    w = mask[:, :, None, None].to(dist.dtype)
    return (dist * w).sum(), mask.sum().to(dist.dtype)


def euclidean_denominator(n_frames, outputs):
    """The masked-Euclidean mean's divisor for ``n_frames`` valid frames
    (of the batch, or of a whole group's batches) of (.., Nart, 2, D) outputs."""
    return torch.clamp(n_frames, min=1.0) * outputs.shape[-3] * outputs.shape[-1]


def p2cp_distance_mm(outputs, targets, lengths,
                     dataset_config: Optional[DatasetConfig] = None,
                     to_mm: Optional[float] = None, reduce: bool = True):
    """Mean P2CP distance in millimetres, masked per sentence (reference
    encoder_decoder/metrics.py:7-26): P2CP per (frame, articulator) in mm,
    averaged over valid frames per sentence, then over real sentences.

    Args:
        outputs, targets: (B, T, Nart, 2, D); lengths: (B,).
        reduce: if False, return ``(per_sentence, valid)``, both (B,).
    """
    if to_mm is None:
        to_mm = mm_per_unit(dataset_config) if dataset_config is not None else 1.0
    p2cp = mean_p2cp_channel_major(outputs, targets)  # (B, T, Nart)
    mask = make_padding_mask(lengths, outputs.shape[1]).to(p2cp.dtype)
    lengths_f = lengths.to(p2cp.dtype)
    per_sentence = (p2cp * to_mm * mask[:, :, None]).sum(dim=(1, 2)) / (
        torch.clamp(lengths_f, min=1.0) * p2cp.shape[2])
    # Zero-length dummy rows (bucket padding) must not dilute the batch mean.
    valid = (lengths > 0).to(p2cp.dtype)
    if not reduce:
        return per_sentence * valid, valid
    return (per_sentence * valid).sum() / torch.clamp(valid.sum(), min=1.0)


def euclidean_distance_mm(outputs, targets, lengths, to_mm: float):
    """Masked mean Euclidean distance in mm: per-sentence mean over valid
    frames, then mean over real sentences (the reference run_test
    aggregation, encoder_decoder/evaluation.py:68-84,148-157)."""
    dist = euclidean_distance(outputs, targets)  # (B, T, Nart, D)
    mask = make_padding_mask(lengths, outputs.shape[1]).to(dist.dtype)
    per_sentence = (dist.mean(dim=-1) * mask[:, :, None]).sum(dim=(1, 2)) / (
        torch.clamp(lengths.to(dist.dtype), min=1.0) * dist.shape[2])
    valid = (lengths > 0).to(dist.dtype)
    return (per_sentence * valid).sum() / torch.clamp(valid.sum(), min=1.0) * to_mm


def recognition_feature_loss(output_features, target_features, lengths):
    """MSE between a frozen recognizer's features of the outputs and of the
    targets over valid frames: the deep perceptual supervision term of
    reference encoder_decoder/loss.py:6-37 (``ArtSpeechLoss``).

    Args:
        output_features, target_features: (B, T, F); lengths: (B,).
    Returns:
        the masked sum of squares over (valid frames x F).
    """
    num, n_frames = recognition_feature_parts(output_features, target_features, lengths)
    return num / (torch.clamp(n_frames, min=1.0) * output_features.shape[-1])


def recognition_feature_parts(output_features, target_features, lengths):
    """``(numerator, n_frames)`` of :func:`recognition_feature_loss`."""
    mask = make_padding_mask(lengths, output_features.shape[1])
    sq = (output_features - target_features) ** 2
    w = mask[:, :, None].to(sq.dtype)
    return (sq * w).sum(), mask.sum().to(sq.dtype)
