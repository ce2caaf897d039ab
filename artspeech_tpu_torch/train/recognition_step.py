"""Train and eval steps for the DeepSpeech2 phoneme recognizer (counterpart
of artspeech_tpu/train/recognition_step.py).

Equivalent role to reference phoneme_recognition/__init__.py:63-153 (the
``run_epoch`` body). For the melspec feature the batch carries raw audio and
the step computes the spectrogram on the device (ops/melspec.py), so the
whole step — melspec, conv stack, GRU (the GRU kernels), loss, backward,
AdamW — runs there. The eval step also decodes greedily on the device.

A batch is the dict ``data/recognition.collate_recognition_batch`` makes,
as numpy arrays or tensors. The optimizer is the state's AdamW (``optax.adamw``
semantics, train/state.py); ``schedule`` sets its learning rate before every
update from the number of updates taken so far (0 for the first), as optax
evaluates a schedule. Dropout masks and the large-margin logit noise come
from the ``torch.Generator`` the caller passes to the step.

Given a ``mesh`` (``parallel/mesh.py``) the train step runs on the rank's rows
and takes the whole batch's loss, as JAX's automatic partitioning does: the
loss's denominator is summed over the data group before the backward (the
exact accumulation's global denominator, a rank being one more microbatch),
and the loss and gradients are summed over it after. JAX's
``recognizer_accum_steps`` policy is not ported: ``accum_steps`` is the
caller's (the train CLI's default is 1).
"""

import math
from typing import Callable, Dict, Optional

import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.eval.decoders import greedy_ctc_decode
from artspeech_tpu_torch.losses.recognition import (
    cross_entropy_loss,
    cross_entropy_loss_parts,
    cross_entropy_weights,
    ctc_loss,
    ctc_loss_parts,
    ctc_valid,
)
from artspeech_tpu_torch.models.deepspeech2 import get_noise_logits
from artspeech_tpu_torch.ops.melspec import dynamic_range_compression, melspectrogram
from artspeech_tpu_torch.parallel.collectives import group_sum, reduce_gradients
from artspeech_tpu_torch.train.state import TrainState, set_learning_rate
from artspeech_tpu_torch.train.step import data_group, spmd_marker


def cyclic_triangular_schedule(base_lr: float, max_lr: float,
                               step_size: int = 2000) -> Callable[[int], float]:
    """torch.optim.lr_scheduler.CyclicLR(triangular) equivalent (reference
    train_phoneme_recognition.py:184-189: base_lr = lr/25, max_lr = lr,
    cycle_momentum=False), as a function of the update count."""

    def schedule(step):
        cycle = math.floor(1 + step / (2.0 * step_size))
        x = abs(step / step_size - 2.0 * cycle + 1.0)
        return base_lr + (max_lr - base_lr) * max(0.0, 1.0 - x)

    return schedule


def make_feature_fn(feature: str):
    """The feature extractor batch -> (B, C, D, T) on the batch's device:
    for melspec the reference's 16 kHz, n_fft 1024, hop 256, 80-mel
    spectrogram of the raw audio."""

    if feature == "melspec":

        def feature_fn(batch):
            mel = dynamic_range_compression(melspectrogram(batch["audio"]))  # (B, 80, T)
            # mono duplicated to stereo channels (reference datasets.py:129).
            return torch.stack([mel, mel], dim=1)  # (B, 2, D, T)

    else:

        def feature_fn(batch):
            return batch["features"]

    return feature_fn


def batch_to_device(batch: Dict, device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def _loss_terms(criterion: str, parts: bool, logits, batch, target_key, class_weights,
                blank_id):
    """The loss (``parts``: its numerator) of one (micro)batch's logits."""
    targets, input_lengths = batch[target_key], batch["input_lengths"]
    if criterion == "ctc":
        log_probs = torch.log_softmax(logits, dim=-1)
        fn = ctc_loss_parts if parts else ctc_loss
        out = fn(log_probs, targets, input_lengths, batch[f"{target_key}_lengths"],
                 blank_id=blank_id)
    else:
        fn = cross_entropy_loss_parts if parts else cross_entropy_loss
        out = fn(logits, targets, input_lengths, class_weights=class_weights)
    return out[0] if parts else out


def make_recognition_train_step(
    criterion: str,
    target_key: str,
    feature: str = "melspec",
    use_voicing: bool = False,
    logits_large_margins: float = 0.0,
    class_weights: Optional[torch.Tensor] = None,
    blank_id: int = 0,
    accum_steps: int = 1,
    schedule: Optional[Callable[[int], float]] = None,
    device: DeviceLike = None,
    mesh=None,
):
    """``step(state, batch, generator=None) -> {"loss", "manual_spmd"}``, 0-d
    tensors.

    criterion: "ctc" | "ce"; target_key: e.g. "ctc_target". ``generator`` is
    a ``torch.Generator`` on ``device`` for the dropout masks and the logit
    noise (needed when either is on).

    ``accum_steps > 1`` splits the batch into that many microbatches, each
    with its own forward and backward, the gradients summed in ``p.grad``,
    and takes one AdamW step. It is exact for both criteria: the loss
    denominators (valid-sequence count for CTC, pad/class-weight sum for CE)
    depend only on the batch, so they are taken over the whole batch first
    (``ctc_valid``, ``cross_entropy_weights``) and every microbatch adds
    numerator / global denominator. Dropout and noise draw from the one
    generator in turn, so steps with different ``accum_steps`` agree only
    with both off. With a ``mesh`` the batch is the rank's rows, split into
    ``accum_steps`` microbatches inside the rank, and the denominator is the
    data group's (module docstring).
    """
    dev = resolve_device(device)
    group = data_group(mesh)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    feature_fn = make_feature_fn(feature)
    weights = None if class_weights is None else class_weights.to(dev)

    def micro_loss(model, mb, generator, parts):
        logits = model(feature_fn(mb), voicing=mb["voicing"] if use_voicing else None,
                       lengths=mb["input_lengths"], generator=generator)
        if logits_large_margins > 0.0:
            logits = get_noise_logits(logits, logits_large_margins, generator)
        return _loss_terms(criterion, parts, logits, mb, target_key, weights, blank_id)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        batch = batch_to_device(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        if accum_steps == 1 and group is None:
            loss = micro_loss(model, batch, generator, parts=False)
            loss.backward()
        else:
            b = batch["input_lengths"].shape[0]
            if b % accum_steps:
                raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
            mb_size = b // accum_steps
            if criterion == "ctc":
                den = ctc_valid(batch[f"{target_key}_lengths"]).sum()
            else:
                den = cross_entropy_weights(batch[target_key], batch["input_lengths"],
                                            batch[target_key].shape[1], weights).sum()
            den = torch.clamp(group_sum(den.float(), group), min=1.0)
            loss = torch.zeros((), device=dev)
            for i in range(accum_steps):
                mb = {k: v[i * mb_size:(i + 1) * mb_size] for k, v in batch.items()}
                part = micro_loss(model, mb, generator, parts=True) / den
                part.backward()
                loss = loss + part.detach()
        (loss,) = reduce_gradients(model.parameters(), group, [loss.detach()])
        if schedule is not None:
            set_learning_rate(state, schedule(state.step))
        state.optimizer.step()
        state.step += 1
        return {"loss": loss, "manual_spmd": spmd_marker(mesh, dev)}

    return train_step


def make_recognition_eval_step(
    criterion: str,
    target_key: str,
    feature: str = "melspec",
    use_voicing: bool = False,
    class_weights: Optional[torch.Tensor] = None,
    blank_id: int = 0,
    return_features: bool = False,
    device: DeviceLike = None,
):
    """``eval_step(state, batch) -> dict`` of device tensors: ``loss``,
    ``decoded`` and ``decoded_lengths`` (greedy, on the device),
    ``log_probs`` and, with ``return_features``, ``features``; the model in
    eval mode under ``torch.no_grad()``."""
    dev = resolve_device(device)
    feature_fn = make_feature_fn(feature)
    weights = None if class_weights is None else class_weights.to(dev)

    def eval_step(state: TrainState, batch) -> Dict[str, torch.Tensor]:
        batch = batch_to_device(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            out = model(feature_fn(batch), voicing=batch["voicing"] if use_voicing else None,
                        lengths=batch["input_lengths"], return_features=return_features)
            logits, features = out if return_features else (out, None)
            log_probs = torch.log_softmax(logits, dim=-1)
            loss = _loss_terms(criterion, False, logits, batch, target_key, weights, blank_id)
            decoded, decoded_lengths = greedy_ctc_decode(log_probs, batch["input_lengths"],
                                                         blank_id=blank_id)
        result = {"loss": loss, "decoded": decoded, "decoded_lengths": decoded_lengths,
                  "log_probs": log_probs}
        if return_features:
            result["features"] = features
        return result

    return eval_step
