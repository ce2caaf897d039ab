"""Train and eval steps (counterpart of artspeech_tpu/train/step.py):
``make_artspeech_train_step`` and ``make_artspeech_eval_step`` for
ArtSpeech-family models, and the transformer's ``make_transformer_train_step``
(with exact microbatch accumulation), ``make_transformer_eval_step`` and
``transformer_accum_steps``.

A batch is a dict with ``tokens`` (B, T), ``targets`` (B, T, Nart, 2, D) and
``lengths`` (B,), as tensors or numpy arrays. The train step runs the model in
training mode (dropout drawn from the caller's generator), the
masked-Euclidean loss, one backward (the GRU backward kernel on CUDA) and one
AdamW step. P2CP is a metric computed on detached outputs under
``torch.no_grad()`` (the P2CP kernel on CUDA): opt-in in the train step, as in
the JAX package, and always in the eval step. With a frozen recognizer
(``recognizer_fn``) the ArtSpeech train step adds the recognizer-feature
loss.

Given a ``mesh`` (``parallel/mesh.py``), each step runs on the rank's rows
of the batch, with JAX's shard_map semantics (JAX train/step.py:133-231):
every masked mean is the rank's numerator over the GLOBAL count (valid frames
all-reduced over the data group before the backward), so that the loss, the
P2CP sums and one flattened gradient, all-reduced (SUM) after the backward,
equal the whole batch's up to float summation order. On a mesh with a model
axis the model's stacked parts compute the rank's slice (the heads'
articulators, the transformer's channels); their parameters' gradients are
reduced over the data group only, like every other, and the replicated
parameters get their whole gradient on every model rank, because what feeds
a sharded part goes through ``copy_to_model_axis``, whose backward sums over
the model group (``parallel/collectives.py``). A rank is one more
microbatch of the transformer's exact accumulation, and both share
``_accumulate``. Every train step reports ``manual_spmd``: 1.0 over a mesh,
0.0 without one. JAX's ``prefer_manual_spmd`` (a TPU dispatch floor between
two multi-device paths) is not ported: the port's kernels run on every
rank's shard, so a mesh always takes the explicit all-reduce.
"""

from typing import Callable, Dict, Optional

import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.losses.articulation import (
    euclidean_denominator,
    masked_euclidean_parts,
    p2cp_distance_mm,
    recognition_feature_parts,
)
from artspeech_tpu_torch.models.deepspeech2 import to_recognizer_layout
from artspeech_tpu_torch.parallel.collectives import all_reduce_flat, group_sum, reduce_gradients
from artspeech_tpu_torch.train.state import TrainState
from artspeech_tpu_torch.utils.masks import make_padding_mask


def _inputs(batch, device):
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "targets", "lengths"))


def data_group(mesh):
    """The group a step all-reduces over: the mesh's data group, or None."""
    return None if mesh is None else mesh.data_group


def spmd_marker(mesh, device) -> torch.Tensor:
    """The ``manual_spmd`` metric: 1.0 for a step over a mesh, else 0.0."""
    return torch.full((), 0.0 if mesh is None else 1.0, device=device)


def _accumulate(forward, targets, lengths, accum_steps: int, with_p2cp: bool, to_mm: float,
                group=None, extra=None):
    """Forward and backward of each of ``accum_steps`` microbatches of the
    rank's rows, each adding its masked-Euclidean sum over the valid-frame
    count of the WHOLE batch: over ``group``'s batches when it is given
    (JAX train/step.py:133-231, 362-447). ``forward(rows)`` runs the model on
    a slice of rows; ``extra(outputs, rows, n_frames)`` adds a term to a
    microbatch's loss. Returns the local (loss, P2CP numerator, P2CP count),
    the gradients left in ``p.grad``."""
    b, t = targets.shape[:2]
    if b % accum_steps:
        raise ValueError(f"batch {b} not divisible by accum_steps={accum_steps}")
    mb = b // accum_steps
    n_frames = group_sum(make_padding_mask(lengths, t).sum().float(), group)
    n_valid = euclidean_denominator(n_frames, targets)
    loss = torch.zeros((), device=targets.device)
    p2cp_num = p2cp_den = torch.zeros((), device=targets.device)
    for i in range(accum_steps):
        rows = slice(i * mb, (i + 1) * mb)
        outputs = forward(rows)
        loss_i = masked_euclidean_parts(outputs, targets[rows], lengths[rows])[0] / n_valid
        if extra is not None:
            loss_i = loss_i + extra(outputs, rows, n_frames)
        loss_i.backward()
        loss += loss_i.detach()
        if with_p2cp:
            with torch.no_grad():
                per_sentence, valid = p2cp_distance_mm(outputs.detach(), targets[rows],
                                                       lengths[rows], to_mm=to_mm, reduce=False)
                p2cp_num = p2cp_num + per_sentence.sum()
                p2cp_den = p2cp_den + valid.sum()
    return loss, p2cp_num, p2cp_den


def _global_metrics(outputs, targets, lengths, to_mm: float, group):
    """The eval metrics ``loss`` and ``p2cp_mm`` of the whole batch from the
    rank's rows: each mean's numerator and count summed over ``group``."""
    num, n_frames = masked_euclidean_parts(outputs, targets, lengths)
    per_sentence, valid = p2cp_distance_mm(outputs, targets, lengths, to_mm=to_mm, reduce=False)
    num, n_frames, p2cp_num, p2cp_den = all_reduce_flat(
        [num, n_frames, per_sentence.sum(), valid.sum()], group)
    return {"loss": num / euclidean_denominator(n_frames, outputs),
            "p2cp_mm": p2cp_num / torch.clamp(p2cp_den, min=1.0)}


def make_artspeech_train_step(to_mm: float, with_p2cp: bool = False, device: DeviceLike = None,
                              recognizer_fn: Optional[Callable] = None,
                              recognition_weight: float = 1.0, mesh=None):
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

    With a ``mesh`` the batch is the rank's rows and the step is the
    multi-rank one (module docstring): the recognizer term is normalised by
    the group's valid frames too, and ``p2cp_mm`` is the group's P2CP sum over
    its count of real sentences, so ranks holding only dummy rows do not bias
    it. ``generator`` should then fold in the rank's data coordinate
    (``train/loop.epoch_generator``): at dropout 0 the trajectory is the
    one-rank one.
    """
    dev = resolve_device(device)
    group = data_group(mesh)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)
        extra = None
        if recognizer_fn is not None:
            voicing = batch.get("voicing")
            if voicing is not None:
                voicing = torch.as_tensor(voicing, device=dev)

            def extra(outputs, rows, n_frames):
                rows_voicing = None if voicing is None else voicing[rows]
                out_feats = recognizer_fn(to_recognizer_layout(outputs), rows_voicing)
                with torch.no_grad():
                    tgt_feats = recognizer_fn(to_recognizer_layout(targets[rows]), rows_voicing)
                num, _ = recognition_feature_parts(out_feats, tgt_feats, lengths[rows])
                return recognition_weight * num / (torch.clamp(n_frames, min=1.0)
                                                   * out_feats.shape[-1])

        loss, p2cp_num, p2cp_den = _accumulate(
            lambda rows: model(tokens[rows], lengths[rows], generator=generator), targets,
            lengths, 1, with_p2cp, to_mm, group, extra)
        loss, p2cp_num, p2cp_den = reduce_gradients(model.parameters(), group,
                                                    [loss, p2cp_num, p2cp_den])
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss, "manual_spmd": spmd_marker(mesh, dev)}
        if with_p2cp:
            metrics["p2cp_mm"] = p2cp_num / torch.clamp(p2cp_den, min=1.0)
        return metrics

    return train_step


def make_artspeech_eval_step(to_mm: float, device: DeviceLike = None, mesh=None):
    """``eval_step(state, batch) -> (metrics, outputs)``: the model in eval
    mode under ``torch.no_grad()``; metrics ``loss`` and ``p2cp_mm``. With a
    ``mesh`` the batch is the rank's rows, the metrics the whole batch's
    (numerators and counts summed over the data group) and ``outputs`` the
    rank's."""
    dev = resolve_device(device)
    group = data_group(mesh)

    def eval_step(state: TrainState, batch):
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            outputs = model(tokens, lengths)
            return _global_metrics(outputs, targets, lengths, to_mm, group), outputs

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
                                device: DeviceLike = None, mesh=None):
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

    With a ``mesh`` the batch is the rank's rows, split into ``accum_steps``
    microbatches inside the rank, every one normalised by the group's valid
    frames, and the loss, P2CP sums and gradients all-reduced once.
    """
    dev = resolve_device(device)
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    group = data_group(mesh)

    def train_step(state: TrainState, batch,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.train()
        state.optimizer.zero_grad(set_to_none=True)

        def forward(rows):
            return model(tokens[rows], shift_targets_right(targets[rows]), lengths[rows],
                         lengths[rows], generator=generator)

        loss, p2cp_num, p2cp_den = _accumulate(forward, targets, lengths, accum_steps,
                                               with_p2cp, to_mm, group)
        loss, p2cp_num, p2cp_den = reduce_gradients(model.parameters(), group,
                                                    [loss, p2cp_num, p2cp_den])
        state.optimizer.step()
        state.step += 1
        metrics = {"loss": loss, "manual_spmd": spmd_marker(mesh, dev)}
        if with_p2cp:
            metrics["p2cp_mm"] = p2cp_num / torch.clamp(p2cp_den, min=1.0)
        return metrics

    return train_step


def make_transformer_eval_step(to_mm: float, device: DeviceLike = None, mesh=None):
    """``eval_step(state, batch) -> (metrics, outputs)``: the teacher-forced
    forward in eval mode under ``torch.no_grad()``; metrics ``loss`` and
    ``p2cp_mm`` (the whole batch's over a ``mesh``, as
    :func:`make_artspeech_eval_step`). Autoregressive evaluation is the test
    harness's, through ``make_auto_generate``."""
    dev = resolve_device(device)
    group = data_group(mesh)

    def eval_step(state: TrainState, batch):
        tokens, targets, lengths = _inputs(batch, dev)
        model = state.model
        model.eval()
        with torch.no_grad():
            outputs = model(tokens, shift_targets_right(targets), lengths, lengths)
            return _global_metrics(outputs, targets, lengths, to_mm, group), outputs

    return eval_step
