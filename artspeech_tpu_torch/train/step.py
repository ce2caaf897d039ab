"""Train and eval steps for ArtSpeech-family models (counterpart of
artspeech_tpu/train/step.py: ``make_artspeech_train_step`` with ``mesh=None``
and ``make_artspeech_eval_step``).

A batch is a dict with ``tokens`` (B, T), ``targets`` (B, T, Nart, 2, D) and
``lengths`` (B,), as tensors or numpy arrays. The train step runs the model in
training mode (dropout drawn from the caller's generator), the
masked-Euclidean loss, one backward (the GRU backward kernel on CUDA) and one
AdamW step. P2CP is a metric computed on detached outputs under
``torch.no_grad()`` (the P2CP kernel on CUDA): opt-in in the train step, as in
the JAX package, and always in the eval step. The recognizer loss term, the
shard_map variant and the transformer steps are not ported yet.
"""

from typing import Dict, Optional

import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.losses.articulation import masked_euclidean_loss, p2cp_distance_mm
from artspeech_tpu_torch.train.state import TrainState


def _inputs(batch, device):
    return tuple(torch.as_tensor(batch[k], device=device)
                 for k in ("tokens", "targets", "lengths"))


def make_artspeech_train_step(to_mm: float, with_p2cp: bool = False, device: DeviceLike = None):
    """``step(state, batch, generator=None) -> metrics``.

    ``generator`` is a ``torch.Generator`` on ``device`` for the dropout
    masks (needed when the model's dropout is > 0). The state's gradients
    stay in ``p.grad`` after the step. Metrics are 0-d tensors on the device:
    ``loss`` and, with ``with_p2cp``, ``p2cp_mm``.
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
