"""Losses for the autoencoder / principal-components method (counterpart of
artspeech_tpu/losses/autoencoder.py).

Equivalents of reference principal_components/losses.py:
- ``critical_loss``       <- CriticalLoss (losses.py:23-99)
- ``regularized_latents_mse_loss`` <- RegularizedLatentsMSELoss2 (:254-285)
- ``make_autoencoder_loss``        <- AutoencoderLoss2 (:100-251)

The frozen encoder and decoder of AutoencoderLoss2 are callables over modules
whose parameters do not require grad: the latent targets are encoded under
``torch.no_grad()`` (JAX's ``stop_gradient``), and the decoder passes
gradients to its input only. The optional recognizer term (``recognizer_fn``,
``beta4``) is the feature MSE of a frozen DeepSpeech2 between the decoded
and the target contours, the targets' features under ``torch.no_grad()``.

Each loss takes an optional process ``group`` (``parallel/mesh.py``'s data
group): its counts are then the group's, so a rank's loss is its share of the
whole batch's and the step sums losses and gradients over the group. The
latent covariance is not a mean of rows: with a group its sums run over the
group's rows through an all-reduce whose backward sums too, and each rank
carries 1 / (group size) of the penalty.
"""

from typing import Callable, Dict, Optional, Sequence

import torch

from artspeech_tpu_torch.core.constants import (
    LOWER_LIP,
    PHARYNX,
    SOFT_PALATE,
    SOFT_PALATE_MIDLINE,
    TONGUE,
    UPPER_INCISOR,
    UPPER_LIP,
)
from artspeech_tpu_torch.models.deepspeech2 import to_recognizer_layout
from artspeech_tpu_torch.ops.distances import (
    mean_p2cp_channel_major,
    min_pairwise_distance_channel_major,
)
from artspeech_tpu_torch.parallel.collectives import (
    differentiable_group_sum,
    group_size,
    group_sum,
)
from artspeech_tpu_torch.utils.masks import make_padding_mask

#: reference losses.py:24-29. The reference maps VEL to SOFT_PALATE; corpora
#: annotate the midline, so accept either name at lookup time.
TV_TO_ARTICULATOR_MAP = {
    "LA": [LOWER_LIP, UPPER_LIP],
    "TTCD": [TONGUE, UPPER_INCISOR],
    "TBCD": [TONGUE, UPPER_INCISOR],
    "VEL": [SOFT_PALATE, PHARYNX],
}


def _resolve_index(articulator: str, indices: Dict[str, int]) -> int:
    if articulator in indices:
        return indices[articulator]
    if articulator == SOFT_PALATE and SOFT_PALATE_MIDLINE in indices:
        return indices[SOFT_PALATE_MIDLINE]
    raise KeyError(articulator)


def critical_loss(output_shapes, reference_arrays, critical_mask, TVs: Sequence[str],
                  articulators: Sequence[str], denorm_mean=None, denorm_std=None, group=None):
    """Mean minimum TV distance over critical frames.

    Args:
        output_shapes: (B, T, Nart, 2, D) predicted shapes (normalized if
            denorm stats given).
        reference_arrays: (B, T, 1, 2, D) upper-incisor reference.
        critical_mask: (B, Ntv, T) 1 where the frame's phoneme is critical.
        denorm_mean/denorm_std: optional (Nart, 2, D) stats applied before
            measuring distances (reference losses.py:76-88).
    """
    TVs = sorted(TVs)
    if len(TVs) == 0:
        return output_shapes.new_zeros(())
    if denorm_mean is not None:
        output_shapes = output_shapes * denorm_std + denorm_mean

    arts = list(articulators)
    if UPPER_INCISOR not in arts:
        full_arts = sorted(arts + [UPPER_INCISOR])
        ref_idx = full_arts.index(UPPER_INCISOR)
        output_shapes = torch.cat([output_shapes[:, :, :ref_idx], reference_arrays,
                                   output_shapes[:, :, ref_idx:]], dim=2)
    else:
        full_arts = arts
    indices = {a: i for i, a in enumerate(full_arts)}

    dists = []
    for tv in TVs:
        art1, art2 = TV_TO_ARTICULATOR_MAP[tv]
        a1 = output_shapes[..., _resolve_index(art1, indices), :, :]
        a2 = output_shapes[..., _resolve_index(art2, indices), :, :]
        dists.append(min_pairwise_distance_channel_major(a1, a2))  # (B, T)
    per_tv = torch.stack(dists, dim=1)  # (B, Ntv, T)
    w = (critical_mask == 1).to(per_tv.dtype)
    return torch.sum(per_tv * w) / torch.clamp(group_sum(torch.sum(w), group), min=1.0)


def offdiag_cov_penalty(latents, indices_dict: Dict[str, Sequence[int]], valid=None,
                        group=None):
    """Sum over articulator blocks of squared off-diagonal covariance
    entries (reference losses.py:275-283).

    Args:
        valid: optional (B,) 0/1 mask — zero-padded dummy rows of a batch
            must not enter the covariance estimate.
        group: with ``valid``, the covariance of the group's rows (every
            rank returns the same penalty).
    """
    if valid is None:
        n = latents.shape[0]
        centered = latents - latents.mean(dim=0, keepdim=True)
        cov = centered.T @ centered / max(n - 1, 1)  # (L, L)
    else:
        v = valid.to(latents.dtype)[:, None]
        n = torch.clamp(group_sum(torch.sum(v), group), min=1.0)
        mean = differentiable_group_sum(torch.sum(latents * v, dim=0, keepdim=True), group) / n
        centered = (latents - mean) * v
        cov = differentiable_group_sum(centered.T @ centered, group) \
            / torch.clamp(n - 1.0, min=1.0)
    total = latents.new_zeros(())
    for idx in indices_dict.values():
        if len(idx) <= 1:
            continue
        ix = torch.as_tensor(idx, device=latents.device)
        block = cov[ix][:, ix]
        total = total + torch.sum(block**2) - torch.sum(torch.diagonal(block) ** 2)
    return total


def regularized_latents_mse_loss(outputs, latents, targets, indices_dict: Dict[str, Sequence[int]],
                                 alpha: float, sample_weights=None, group=None):
    """Weighted reconstruction MSE + alpha * off-diagonal latent covariance
    (reference losses.py:254-285).

    Args:
        outputs/targets: (B, Nart, F); latents: (B, L);
        sample_weights: (B,). Zero-weight rows (batch-padding dummies) are
            excluded from BOTH the MSE denominator and the covariance.
        group: with ``sample_weights``, this rank's share of the loss of
            the group's rows (module docstring).
    """
    sq = (outputs - targets) ** 2
    if sample_weights is not None:
        sq = sq * sample_weights[:, None, None]
        valid = (sample_weights > 0).to(sq.dtype)
        n_rows = torch.clamp(group_sum(torch.sum(valid), group), min=1.0)
        mse = torch.sum(sq) / (n_rows * sq.shape[1] * sq.shape[2])
        penalty = offdiag_cov_penalty(latents, indices_dict, valid, group)
        if group is not None:
            penalty = penalty / group_size(group)
        return mse + alpha * penalty
    return sq.mean() + alpha * offdiag_cov_penalty(latents, indices_dict)


def make_autoencoder_loss(encode_fn: Callable, decode_fn: Callable, TVs: Sequence[str],
                          articulators: Sequence[str], beta1: float = 1.0, beta2: float = 1.0,
                          beta3: float = 1.0, beta4: float = 0.0, rescale_factor: float = 1.0,
                          denorm_mean=None, denorm_std=None,
                          recognizer_fn: Optional[Callable] = None):
    """Composite sequence loss (reference AutoencoderLoss2, losses.py:100-251).

    Args:
        encode_fn: (B*T, Nart, 2*D) -> (B*T, L) FROZEN encoder (tanh'd).
        decode_fn: (B, T, L) -> (B, T, Nart, 2*D) FROZEN decoder.
        recognizer_fn: optional (shapes (B, C, Nart*D, T), voicing) ->
            (B, T, F) features of a FROZEN recognizer
            (``models.deepspeech2.frozen_recognizer_fn``); its term, weighted
            by ``beta4``, is the features' MSE over valid frames.
    Returns loss_fn(output_pcs, target_shapes, reference_arrays, lengths,
                    critical_mask, voicing=None, group=None) -> scalar; with a
    ``group`` every term's count is the group's.
    """

    def loss_fn(output_pcs, target_shapes, reference_arrays, lengths, critical_mask,
                voicing=None, group=None):
        b, t, n_art, _, d = target_shapes.shape
        mask = make_padding_mask(lengths, t).to(target_shapes.dtype)
        n_valid = torch.clamp(group_sum(torch.sum(mask), group), min=1.0)

        # Frozen-encoder latent targets: targets, not a path for gradients.
        with torch.no_grad():
            target_pcs = encode_fn(target_shapes.reshape(b * t, n_art, 2 * d)).reshape(b, t, -1)

        # Frozen-decoder shapes from the predicted latents: gradients flow
        # through the decoder's input, not its parameters.
        output_shapes = decode_fn(rescale_factor * output_pcs).reshape(b, t, n_art, 2, d)

        latent_sq = (output_pcs - target_pcs) ** 2  # (B, T, L)
        latent_loss = torch.sum(latent_sq.mean(dim=-1) * mask) / n_valid
        recon_sq = (output_shapes - target_shapes) ** 2  # (B, T, Nart, 2, D)
        recon_loss = torch.sum(recon_sq.mean(dim=(-3, -2, -1)) * mask) / n_valid
        crit_loss = critical_loss(output_shapes, reference_arrays, critical_mask, TVs,
                                  articulators, denorm_mean=denorm_mean, denorm_std=denorm_std,
                                  group=group)
        loss = beta1 * latent_loss + beta2 * recon_loss + beta3 * crit_loss
        if recognizer_fn is not None:
            with torch.no_grad():
                tgt_feats = recognizer_fn(to_recognizer_layout(target_shapes), voicing)
            out_feats = recognizer_fn(to_recognizer_layout(output_shapes), voicing)
            rec_sq = (out_feats - tgt_feats) ** 2  # (B, T, F)
            loss = loss + beta4 * torch.sum(rec_sq.mean(dim=-1) * mask) / n_valid
        return loss

    return loss_fn


def decoder_mean_p2cp_mm(output_pcs, target_shapes, lengths, decode_fn: Callable, denorm_mean,
                         denorm_std, to_mm: float, rescale_factor: float = 1.0, group=None):
    """Valid metric: decode latents, denormalize, P2CP in mm (reference
    principal_components/metrics.py:12-61). The P2CP kernel on CUDA has no
    backward: call it on detached latents under ``torch.no_grad()``. With a
    ``group``, this rank's share of the group's mean."""
    b, t, n_art, _, d = target_shapes.shape
    shapes = decode_fn(rescale_factor * output_pcs).reshape(b, t, n_art, 2, d)
    shapes = shapes * denorm_std + denorm_mean
    targets = target_shapes * denorm_std + denorm_mean
    p2cp = mean_p2cp_channel_major(shapes, targets)  # (B, T, Nart)
    mask = make_padding_mask(lengths, t).to(p2cp.dtype)[:, :, None]
    return torch.sum(p2cp * mask * to_mm) / torch.clamp(group_sum(torch.sum(mask), group) * n_art,
                                                        min=1.0)
