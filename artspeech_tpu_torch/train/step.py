"""Train and eval steps (counterpart of artspeech_tpu/train/step.py):
``make_artspeech_train_step`` with ``mesh=None`` and
``make_artspeech_eval_step`` for ArtSpeech-family models, and the
transformer's ``make_transformer_train_step`` (with exact microbatch
accumulation), ``make_transformer_eval_step`` and ``transformer_accum_steps``.

A batch is a dict with ``tokens`` (B, T), ``targets`` (B, T, Nart, 2, D) and
``lengths`` (B,), as tensors or numpy arrays. The train step runs the model in
training mode (dropout drawn from the caller's generator), the
masked-Euclidean loss, one backward (the GRU backward kernel on CUDA) and one
AdamW step. P2CP is a metric computed on detached outputs under
``torch.no_grad()`` (the P2CP kernel on CUDA): opt-in in the train step, as in
the JAX package, and always in the eval step. With a frozen recognizer
(``recognizer_fn``) the ArtSpeech train step adds the recognizer-feature
loss. The shard_map variant is not ported yet.
"""

from typing import Callable, Dict, Optional

import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.losses.articulation import (
    masked_euclidean_loss,
    p2cp_distance_mm,
    recognition_feature_loss,
)
from artspeech_tpu_torch.models.deepspeech2 import to_recognizer_layout
from artspeech_tpu_torch.ops.distances import euclidean_distance
from artspeech_tpu_torch.train.state import TrainState
from artspeech_tpu_torch.utils.masks import make_padding_mask


def _inputs(batch, device):
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "targets", "lengths"))


def make_artspeech_train_step(to_mm: float, with_p2cp: bool = False, device: DeviceLike = None,
                              recognizer_fn: Optional[Callable] = None,
                              recognition_weight: float = 1.0):
    """``step(state, batch, generator=None) -> metrics``.

    ``generator`` is a ``torch.Generator`` on ``device`` for the dropout
    masks (needed when the model's dropout is > 0). The state's gradients
    stay in ``p.grad`` after the step. Metrics are 0-d tensors on the device:
    ``loss`` and, with ``with_p2cp``, ``p2cp_mm``.

    With ``recognizer_fn`` (a FROZEN feature extractor, (shapes (B, 2,
    Nart * D, T), voicing (B, T) or None) -> (B, T, F), from
    ``models.deepspeech2.frozen_recognizer_fn``), the loss adds
    ``recognition_weight`` times the MSE between its features of the outputs
    and of the targets (reference encoder_decoder/loss.py:6-37,
    ``ArtSpeechLoss``). The targets' features take no gradient; the outputs'
    pass theirs through the recognizer into the model. The batch's
    ``voicing`` (padded frames -1), where it has one, goes to the recognizer
    as it is.
    """
    dev = resolve_device(device)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        outputs = model(tokens, lengths, generator=generator)
        loss = masked_euclidean_loss(outputs, targets, lengths)
        if recognizer_fn is not None:
            voicing = batch.get("voicing")
            if voicing is not None:
                voicing = torch.as_tensor(voicing, device=dev)
            out_feats = recognizer_fn(to_recognizer_layout(outputs), voicing)
            with torch.no_grad():
                tgt_feats = recognizer_fn(to_recognizer_layout(targets), voicing)
            loss = loss + recognition_weight * recognition_feature_loss(out_feats, tgt_feats,
                                                                        lengths)
        loss.backward()
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss.detach()}
        if with_p2cp:
            with torch.no_grad():
                metrics["p2cp_mm"] = p2cp_distance_mm(outputs.detach(), targets, lengths,
                                                      to_mm=to_mm)
        return metrics

    return train_step


def make_artspeech_eval_step(to_mm: float, device: DeviceLike = None):
    """``eval_step(state, batch) -> (metrics, outputs)``: the model in eval
    mode under ``torch.no_grad()``; metrics ``loss`` and ``p2cp_mm``."""
    dev = resolve_device(device)

    def eval_step(state: TrainState, batch):
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            outputs = model(tokens, lengths)
            metrics = {
                "loss": masked_euclidean_loss(outputs, targets, lengths),
                "p2cp_mm": p2cp_distance_mm(outputs, targets, lengths, to_mm=to_mm),
            }
        return metrics, outputs

    return eval_step


def shift_targets_right(targets):
    """(B, T, Nart, 2, D) -> (B, T, Nart, 2 D) teacher-forcing input with a
    zero start frame (reference train_phoneme_to_articulation_transformer.py:99-111)."""
    b, t, n_art, two, d = targets.shape
    flat = targets.reshape(b, t, n_art, two * d)
    return torch.cat([torch.zeros_like(flat[:, :1]), flat[:, :-1]], dim=1)


def transformer_accum_steps(collate_batch_size: int) -> int:
    """Microbatches the transformer train step splits a batch of
    ``collate_batch_size`` sentences into by default: 1, at every batch size.
    A config's ``accum_steps`` key overrides it in the train CLI.

    The JAX package's default (microbatches of 2 f32 / 4 bf16 sentences from
    B >= 32) was measured on a TPU v5e, where the materialised
    (B, C, C-1, H, L, L) scores outgrew its memory, and does not carry over:
    the port's pair attention never materialises them. On the card the whole
    batch wins. chip_smoke.py's ``[train_transformer]`` sweep of the thesis
    transformer (train_transformer.yaml) at B = 64, T = 128 on an NVIDIA H100
    80GB HBM3 at 700 W (PERF.md): microbatches of 64 (no accumulation)
    188.4 ms a step (43,481 frames/s, 21.8 GiB peak), 16: 503.6 ms, 8: 1,168
    ms, 4: 2,139 ms, 2: 4,497 ms. The whole batch fits in a quarter of the
    card's memory, and each microbatch repeats the forward's and backward's
    ~4,000 kernel launches, so accumulation only adds host time.
    """
    return 1


def make_transformer_train_step(to_mm: float, with_p2cp: bool = False, accum_steps: int = 1,
                                device: DeviceLike = None):
    """Teacher-forced train step for ``ArtSpeechTransformer``:
    ``step(state, batch, generator=None) -> metrics`` (as
    :func:`make_artspeech_train_step`).

    ``accum_steps`` splits the batch into that many microbatches, each with
    its own forward and backward, the gradients summed in ``p.grad``, and takes
    one AdamW step. The loss is exact: every microbatch contributes
    ``masked_sum / n_valid`` with ``n_valid`` counted over the whole batch's
    lengths up front, so the accumulated loss and gradients equal the whole
    batch's up to float summation order (JAX train/step.py:362-447). One
    microbatch is the plain step. Dropout masks come from the one
    ``generator`` in turn, so steps with different ``accum_steps`` agree
    exactly only at dropout 0. With ``with_p2cp``, P2CP is summed per sentence
    over the microbatches, on detached outputs.
    """
    dev = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens, targets, lengths = _inputs(batch, dev)
        b, t = tokens.shape
        if b % accum_steps:
            raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
        mb = b // accum_steps
        mask = make_padding_mask(lengths, t)
        n_valid = torch.clamp(mask.sum().float(), min=1.0) * targets.shape[2] * targets.shape[4]
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        loss = torch.zeros((), device=dev)
        p2cp_num = p2cp_den = torch.zeros((), device=dev)
        for i in range(accum_steps):
            rows = slice(i * mb, (i + 1) * mb)
            outputs = model(tokens[rows], shift_targets_right(targets[rows]), lengths[rows],
                            lengths[rows], generator=generator)
            dist = euclidean_distance(outputs, targets[rows])  # (mb, T, Nart, D)
            loss_i = (dist * mask[rows][:, :, None, None]).sum() / n_valid
            loss_i.backward()
            loss += loss_i.detach()
            if with_p2cp:
                with torch.no_grad():
                    per_sentence, valid = p2cp_distance_mm(outputs.detach(), targets[rows],
                                                           lengths[rows], to_mm=to_mm, reduce=False)
                    p2cp_num = p2cp_num + per_sentence.sum()
                    p2cp_den = p2cp_den + valid.sum()
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss}
        if with_p2cp:
            metrics["p2cp_mm"] = p2cp_num / torch.clamp(p2cp_den, min=1.0)
        return metrics

    return train_step


def make_transformer_eval_step(to_mm: float, device: DeviceLike = None):
    """``eval_step(state, batch) -> (metrics, outputs)``: the teacher-forced
    forward in eval mode under ``torch.no_grad()``; metrics ``loss`` and
    ``p2cp_mm``. Autoregressive evaluation is the test harness's, through
    ``make_auto_generate``."""
    dev = resolve_device(device)

    def eval_step(state: TrainState, batch):
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            outputs = model(tokens, shift_targets_right(targets), lengths, lengths)
            metrics = {
                "loss": masked_euclidean_loss(outputs, targets, lengths),
                "p2cp_mm": p2cp_distance_mm(outputs, targets, lengths, to_mm=to_mm),
            }
        return metrics, outputs

    return eval_step
