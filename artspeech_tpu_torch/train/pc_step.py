"""Train and eval steps for the autoencoder / principal-components method
(counterpart of artspeech_tpu/train/pc_step.py).

Covers the two trainers of the reference:
- the frame autoencoder (train_principal_components_autoencoder.py:67-356,
  RegularizedLatentsMSELoss2, best metric = reconstruction p2cp_mm), and
- the latent sequence model (train_phoneme_to_principal_components.py:58-471,
  the AutoencoderLoss2 composite with a frozen AE, valid metric
  DecoderMeanP2CPDistance2).

Each train step runs the model in training mode, one backward (the GRU or
LSTM backward kernel on CUDA for the latent RNN) and one AdamW step. P2CP is
a metric computed on detached outputs under ``torch.no_grad()`` (no
gradient is taken through it): opt-in in the train steps, as in the JAX
package, and always in the eval steps. Dropout masks come from the caller's
``torch.Generator``. Metrics are 0-d tensors on the device.

Given a ``mesh`` (``parallel/mesh.py``) each step runs on the rank's rows and
computes the whole batch's loss, as JAX's automatic partitioning does: every
count in the losses and metrics is the data group's, the rank's shares of the
loss and metrics and its gradients are summed over the group in one
all-reduce, and ``manual_spmd`` is 1.0 (0.0 without a mesh).
"""

from typing import Callable, Dict

import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.losses.autoencoder import (
    decoder_mean_p2cp_mm,
    regularized_latents_mse_loss,
)
from artspeech_tpu_torch.models.autoencoder import normalize_indices_dict
from artspeech_tpu_torch.ops.distances import mean_p2cp_channel_major
from artspeech_tpu_torch.parallel.collectives import all_reduce_flat, group_sum, reduce_gradients
from artspeech_tpu_torch.train.state import TrainState
from artspeech_tpu_torch.train.step import data_group, spmd_marker


def reconstruction_p2cp_mm(recon, targets, denorm_mean, denorm_std, to_mm, weights=None,
                           group=None):
    """AE reconstruction error in mm (reference
    train_principal_components_autoencoder.py:40-64 ``reconstruction_error``).

    Args:
        recon/targets: (B, Nart, 2 * n_samples) normalized flat contours.
        denorm_mean/denorm_std: (Nart, 2, n_samples) on their device.
        weights: optional (B,) sample weights; zero-weight rows (batch
            padding, whose p2cp is trivially 0) are excluded from the mean.
        group: with ``weights``, this rank's share of the group's mean.
    """
    b, n_art, flat = recon.shape
    n_samples = flat // 2
    r = recon.reshape(b, n_art, 2, n_samples) * denorm_std + denorm_mean
    t = targets.reshape(b, n_art, 2, n_samples) * denorm_std + denorm_mean
    p2cp = mean_p2cp_channel_major(r, t)  # (B, Nart)
    if weights is None:
        return p2cp.mean() * to_mm
    valid = (weights > 0).to(p2cp.dtype)
    n_valid = group_sum(torch.sum(valid), group)
    return torch.sum(p2cp * valid[:, None]) / torch.clamp(n_valid * n_art, min=1.0) * to_mm


def _frames(batch, device):
    return (torch.as_tensor(batch["inputs"], device=device),
            torch.as_tensor(batch["weights"], device=device))


def _summed(metrics: Dict[str, torch.Tensor], group) -> Dict[str, torch.Tensor]:
    """The metrics' rank shares summed over ``group`` in one all-reduce."""
    return dict(zip(metrics, all_reduce_flat(list(metrics.values()), group)))


def make_autoencoder_train_step(indices_dict: Dict, alpha: float, denorm_mean, denorm_std,
                                to_mm: float, with_p2cp: bool = False, device: DeviceLike = None,
                                mesh=None):
    """Frame AE train step over {inputs (B, Nart, F), weights (B,)}:
    ``step(state, batch, generator=None) -> metrics`` (``generator`` unused:
    the autoencoder has no dropout; the argument keeps ``fit``'s signature).

    ``with_p2cp`` adds the reconstruction-P2CP metric. Off by default: the
    reference computes it in the VALID phase only
    (train_principal_components_autoencoder.py:200-226)."""
    dev = resolve_device(device)
    indices = normalize_indices_dict(indices_dict)
    mean, std = (torch.as_tensor(v, device=dev) for v in (denorm_mean, denorm_std))
    group = data_group(mesh)

    def train_step(state: TrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        inputs, weights = _frames(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        recon, latents = model(inputs)
        loss = regularized_latents_mse_loss(recon, latents, inputs, indices, alpha,
                                            sample_weights=weights, group=group)
        loss.backward()
        metrics = {"loss": loss.detach()}
        if with_p2cp:
            with torch.no_grad():
                metrics["p2cp_mm"] = reconstruction_p2cp_mm(recon.detach(), inputs, mean, std,
                                                             to_mm, weights=weights, group=group)
        metrics = dict(zip(metrics, reduce_gradients(model.parameters(), group,
                                                     list(metrics.values()))))
        state.optimizer.step()
        state.step += 1
        return {**metrics, "manual_spmd": spmd_marker(mesh, dev)}

    return train_step


def make_autoencoder_eval_step(indices_dict: Dict, alpha: float, denorm_mean, denorm_std,
                               to_mm: float, device: DeviceLike = None, mesh=None):
    """``eval_step(state, batch) -> (metrics, (recon, latents))`` in eval mode
    under ``torch.no_grad()``; metrics ``loss`` and ``p2cp_mm`` (the whole
    batch's over a ``mesh``; the outputs the rank's)."""
    dev = resolve_device(device)
    indices = normalize_indices_dict(indices_dict)
    mean, std = (torch.as_tensor(v, device=dev) for v in (denorm_mean, denorm_std))
    group = data_group(mesh)

    def eval_step(state: TrainState, batch):
        inputs, weights = _frames(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            recon, latents = model(inputs)
            metrics = {
                "loss": regularized_latents_mse_loss(recon, latents, inputs, indices, alpha,
                                                     sample_weights=weights, group=group),
                "p2cp_mm": reconstruction_p2cp_mm(recon, inputs, mean, std, to_mm,
                                                  weights=weights, group=group),
            }
        return _summed(metrics, group), (recon, latents)

    return eval_step


def _sentences(batch, device):
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "targets", "references", "lengths", "critical_masks"))


def _voicing(batch, device):
    """The batch's voicing (padded frames -1) for the loss's recognizer
    term, or None where the batch has none (JAX pc_step.py:150,192)."""
    voicing = batch.get("voicing")
    return None if voicing is None else torch.as_tensor(voicing, device=device)


def make_latent_rnn_train_step(loss_fn: Callable, decode_fn: Callable, denorm_mean, denorm_std,
                               to_mm: float, rescale_factor: float = 1.0, with_p2cp: bool = False,
                               device: DeviceLike = None, mesh=None):
    """Latent-RNN train step, ``loss_fn`` from ``make_autoencoder_loss``:
    ``step(state, batch, generator=None) -> metrics``; ``generator`` is a
    ``torch.Generator`` on ``device`` for the recurrence's dropout.

    ``with_p2cp`` adds the decoded-contour P2CP metric (an extra frozen-AE
    decode of every frame). Off by default: the reference computes
    DecoderMeanP2CPDistance2 only in the VALID phase
    (train_phoneme_to_principal_components.py:360-380)."""
    dev = resolve_device(device)
    mean, std = (torch.as_tensor(v, device=dev) for v in (denorm_mean, denorm_std))
    group = data_group(mesh)

    def train_step(state: TrainState, batch, generator=None) -> Dict[str, torch.Tensor]:
        tokens, targets, references, lengths, critical = _sentences(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        pcs = model(tokens, lengths, generator=generator)
        loss = loss_fn(pcs, targets, references, lengths, critical, voicing=_voicing(batch, dev),
                       group=group)
        loss.backward()
        metrics = {"loss": loss.detach()}
        if with_p2cp:
            with torch.no_grad():
                metrics["p2cp_mm"] = decoder_mean_p2cp_mm(pcs.detach(), targets, lengths,
                                                          decode_fn, mean, std, to_mm,
                                                          rescale_factor=rescale_factor,
                                                          group=group)
        metrics = dict(zip(metrics, reduce_gradients(model.parameters(), group,
                                                     list(metrics.values()))))
        state.optimizer.step()
        state.step += 1
        return {**metrics, "manual_spmd": spmd_marker(mesh, dev)}

    return train_step


def make_latent_rnn_eval_step(loss_fn: Callable, decode_fn: Callable, denorm_mean, denorm_std,
                              to_mm: float, rescale_factor: float = 1.0, device: DeviceLike = None,
                              mesh=None):
    """``eval_step(state, batch) -> (metrics, pcs)`` in eval mode under
    ``torch.no_grad()``; metrics ``loss`` and ``p2cp_mm`` (the whole batch's
    over a ``mesh``; the outputs the rank's)."""
    dev = resolve_device(device)
    mean, std = (torch.as_tensor(v, device=dev) for v in (denorm_mean, denorm_std))
    group = data_group(mesh)

    def eval_step(state: TrainState, batch):
        tokens, targets, references, lengths, critical = _sentences(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            pcs = model(tokens, lengths)
            metrics = {
                "loss": loss_fn(pcs, targets, references, lengths, critical,
                                voicing=_voicing(batch, dev), group=group),
                "p2cp_mm": decoder_mean_p2cp_mm(pcs, targets, lengths, decode_fn, mean, std,
                                                to_mm, rescale_factor=rescale_factor,
                                                group=group),
            }
        return _summed(metrics, group), pcs

    return eval_step
