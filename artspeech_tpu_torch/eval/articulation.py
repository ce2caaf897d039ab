"""Test harness for phoneme-to-articulation models (counterpart of
artspeech_tpu/eval/articulation.py).

Equivalent of reference encoder_decoder/evaluation.py:17-161 (``run_test``):
one test step per batch computes, on the device and under
``torch.inference_mode``, the masked loss, per-(sentence, articulator) P2CP /
MED / Pearson correlations, upper-incisor injection, the tract variables of
predictions and targets (the min-distance kernel on CUDA) and optionally the
B-spline regularized outputs; the host then copies each batch's results once
and writes the artifacts.
"""

from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from artspeech_tpu_torch.core.constants import REQUIRED_ARTICULATORS_FOR_TVS, UPPER_INCISOR
from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.data.batching import prefetch_to_device
from artspeech_tpu_torch.eval.artifacts import (
    save_contours,
    save_tract_variables_csv,
    tvs_to_records,
)
from artspeech_tpu_torch.geometry.tract_variables import tract_variables_from_stack
from artspeech_tpu_torch.losses.articulation import masked_euclidean_loss
from artspeech_tpu_torch.ops.bspline import regularize_bsplines
from artspeech_tpu_torch.ops.distances import (
    euclidean_distance,
    mean_p2cp_channel_major,
    pearson_correlation,
)
from artspeech_tpu_torch.utils.masks import make_padding_mask


def inject_upper_incisor(stack, references, articulators: Sequence[str]):
    """Insert the reference (upper incisor) contour into the articulator axis.

    Equivalent of reference encoder_decoder/evaluation.py:93-109. ``stack`` is
    (B, T, Nart, 2, D), ``references`` (B, T, 1, 2, D). Returns
    (stack_with_ref, tv_articulators).
    """
    if UPPER_INCISOR in articulators:
        return stack, list(articulators)
    tv_articulators = sorted(list(articulators) + [UPPER_INCISOR])
    ref_idx = tv_articulators.index(UPPER_INCISOR)
    merged = torch.cat([stack[:, :, :ref_idx], references, stack[:, :, ref_idx:]], dim=2)
    return merged, tv_articulators


def per_sentence_metrics(outputs, targets, lengths):
    """Per-(sentence, articulator) metrics, padding-masked.

    Returns dict of (B, Nart) tensors: p2cp, med, x_corr, y_corr.
    """
    mask = make_padding_mask(lengths, outputs.shape[1])  # (B, T)
    fmask = mask[:, :, None].to(outputs.dtype)  # (B, T, 1)
    denom_t = torch.clamp(lengths.to(outputs.dtype), min=1.0)[:, None]

    # P2CP / MED per frame -> masked time mean.
    p2cp = mean_p2cp_channel_major(outputs, targets)  # (B, T, Nart)
    p2cp = torch.sum(p2cp * fmask, dim=1) / denom_t  # (B, Nart)

    med = euclidean_distance(outputs, targets).mean(dim=-1)  # (B, T, Nart)
    med = torch.sum(med * fmask, dim=1) / denom_t

    # Pearson over time per (articulator, axis, sample point), then mean over
    # points — masked.
    corr_mask = mask[:, :, None, None]  # broadcast over (Nart, D)
    x_corr = pearson_correlation(outputs[:, :, :, 0, :], targets[:, :, :, 0, :],
                                 mask=corr_mask, axis=1).mean(dim=-1)
    y_corr = pearson_correlation(outputs[:, :, :, 1, :], targets[:, :, :, 1, :],
                                 mask=corr_mask, axis=1).mean(dim=-1)
    return {"p2cp": p2cp, "med": med, "x_corr": x_corr, "y_corr": y_corr}


def make_test_step(
    forward_fn: Callable,
    articulators: Sequence[str],
    regularize_out: bool = False,
    compute_tvs: bool = True,
    device: DeviceLike = None,
):
    """The full evaluation of one batch, on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``).

    ``forward_fn(tokens, lengths) -> (B, T, Nart, 2, D)`` is the model (an
    ``ArtSpeech`` on ``device``; a module is put in eval mode). Returns
    ``(test_step, tv_articulators)``; ``test_step(batch)`` takes a batch
    dict (``tokens``, ``targets``, ``references``, ``lengths``) of arrays or
    tensors and returns tensors on ``device``: ``loss``, ``metrics``,
    ``outputs`` and ``targets`` with the incisor injected, and ``tvs_pred`` /
    ``tvs_tgt`` (None when the articulators cannot give TVs).
    """
    dev = resolve_device(device)
    articulators = sorted(articulators)

    @torch.inference_mode()
    def test_step(batch):
        if isinstance(forward_fn, nn.Module):
            forward_fn.eval()
        tokens, targets, references, lengths = (
            torch.as_tensor(batch[k], device=dev)
            for k in ("tokens", "targets", "references", "lengths"))
        outputs = forward_fn(tokens, lengths)
        loss = masked_euclidean_loss(outputs, targets, lengths)
        metrics = per_sentence_metrics(outputs, targets, lengths)

        merged_raw, tv_articulators = inject_upper_incisor(outputs, references, articulators)
        merged_tgt, _ = inject_upper_incisor(targets, references, articulators)

        # TVs are computed on the RAW outputs (reference run_test calls
        # tract_variables before save_outputs' optional regularization,
        # encoder_decoder/evaluation.py:111-140).
        tvs_pred = tvs_tgt = None
        if compute_tvs and all(a in tv_articulators for a in REQUIRED_ARTICULATORS_FOR_TVS):
            tvs_pred = {k: v for k, v in tract_variables_from_stack(
                merged_raw, tv_articulators).items() if v is not None}
            tvs_tgt = {k: v for k, v in tract_variables_from_stack(
                merged_tgt, tv_articulators).items() if v is not None}

        merged_out = merged_raw
        if regularize_out:
            merged_out = regularize_bsplines(merged_raw.transpose(-1, -2)).transpose(-1, -2)

        return {
            "loss": loss,
            "metrics": metrics,
            "outputs": merged_out,
            "targets": merged_tgt,
            "tvs_pred": tvs_pred,
            "tvs_tgt": tvs_tgt,
        }

    tv_articulators = (sorted(set(articulators) | {UPPER_INCISOR})
                       if UPPER_INCISOR not in articulators else list(articulators))
    return test_step, tv_articulators


def _to_host(tree):
    """Nested dicts of tensors -> the same structure of numpy arrays."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.cpu().numpy()
    return tree


def run_test(
    forward_fn: Callable,
    loader,
    articulators: Sequence[str],
    to_mm: float,
    outputs_dir: Optional[str] = None,
    regularize_out: bool = False,
    save_artifacts: bool = True,
    loss_agg: str = "batch",
    device: DeviceLike = None,
) -> Dict:
    """Evaluate over a loader; write contour npys + TV CSVs; return the
    reference run_test info dict {loss, {articulator: {x_corr, y_corr, p2cp,
    p2cp_mm, med, med_mm}}} (encoder_decoder/evaluation.py:141-161).

    ``forward_fn`` is the model on ``device`` (``cuda`` unless the caller
    passes ``device="cpu"``); ``loader`` yields ``(batch, meta)`` pairs of
    numpy arrays, as ``BucketedLoader`` does. ``loss_agg`` picks the loss's
    aggregation, as in JAX: "batch" is the mean over batches of each batch's
    masked frame-mean loss (encoder_decoder/evaluation.py:58-63,87);
    "sentence" the mean over sentences of each sentence's ``med`` averaged
    over articulators (the mean-contour harness,
    phoneme_wise_mean_contour/__init__.py:180,241).
    """
    if loss_agg not in ("batch", "sentence"):
        raise ValueError(f"loss_agg must be 'batch' or 'sentence': {loss_agg!r}")
    dev = resolve_device(device)
    articulators = sorted(articulators)
    test_step, tv_articulators = make_test_step(forward_fn, articulators,
                                                regularize_out=regularize_out, device=dev)

    losses = []
    acc = {k: [] for k in ("p2cp", "med", "x_corr", "y_corr")}
    for batch, meta in prefetch_to_device(loader, device=dev):
        result = _to_host(test_step(batch))
        lengths = batch["lengths"].cpu().numpy()
        valid = lengths > 0
        for k in acc:
            acc[k].append(result["metrics"][k][valid])
        if loss_agg == "sentence":
            losses.append(acc["med"][-1].mean(axis=1))
        else:
            losses.append(np.asarray([float(result["loss"])]))

        if outputs_dir is not None and save_artifacts:
            _write_batch_artifacts(result, meta, lengths, tv_articulators, outputs_dir)

    info = {"loss": float(np.mean(np.concatenate(losses)))}
    stacked = {k: np.concatenate(v, axis=0) for k, v in acc.items()}
    for i_art, art in enumerate(articulators):
        info[art] = {
            "x_corr": float(np.mean(stacked["x_corr"][:, i_art])),
            "y_corr": float(np.mean(stacked["y_corr"][:, i_art])),
            "p2cp": float(np.mean(stacked["p2cp"][:, i_art])),
            "p2cp_mm": float(np.mean(stacked["p2cp"][:, i_art]) * to_mm),
            "med": float(np.mean(stacked["med"][:, i_art])),
            "med_mm": float(np.mean(stacked["med"][:, i_art]) * to_mm),
        }
    return info


def _write_batch_artifacts(result, meta, lengths, tv_articulators, outputs_dir):
    outputs = result["outputs"]
    targets = result["targets"]
    for i, sentence_id in enumerate(meta["sentence_names"]):
        L = int(lengths[i])
        if L == 0:
            continue
        frame_ids = meta["frame_ids"][i][:L]
        phonemes = meta["phonemes"][i][:L]
        save_contours(sentence_id, frame_ids, outputs[i, :L], targets[i, :L], phonemes,
                      tv_articulators, outputs_dir)
        if result["tvs_pred"]:
            pred_tvs = {k: {kk: vv[i] for kk, vv in v.items()}
                        for k, v in result["tvs_pred"].items()}
            tgt_tvs = {k: {kk: vv[i] for kk, vv in v.items()}
                       for k, v in result["tvs_tgt"].items()}
            records = tvs_to_records(sentence_id, frame_ids, phonemes, pred_tvs, tgt_tvs)
            save_tract_variables_csv(sentence_id, records, outputs_dir)
