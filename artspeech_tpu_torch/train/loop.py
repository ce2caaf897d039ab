"""Training orchestration on one device (counterpart of
artspeech_tpu/train/loop.py).

The reference loop (train_phoneme_to_articulation.py:124-426): train and valid
epochs with sentence-weighted means, ReduceLROnPlateau on the valid loss,
early stopping on the valid P2CP in mm, ``best/``, ``last/`` and
``best_model`` checkpoints, and resume. Each epoch's dropout masks come from a
``torch.Generator`` on the device seeded from (``seed``, epoch), in place of
``jax.random.split``, so a resumed run draws the masks an uninterrupted one
would. Data parallelism is not ported yet.
"""

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.data.batching import to_device
from artspeech_tpu_torch.train.checkpoint import (
    has_checkpoint,
    restore_checkpoint,
    save_checkpoint,
    save_params,
)
from artspeech_tpu_torch.train.state import EarlyStopping, PlateauScheduler, get_learning_rate


def _batch_weight(meta) -> float:
    """Real sentences in a collated batch (dummy pad rows excluded), so a
    partly filled final bucket does not bias the epoch means."""
    if isinstance(meta, dict):
        n = meta.get("n_real", meta.get("n_valid"))
        if n is not None:
            return float(n)
        names = meta.get("sentence_names")
        if names is not None:
            return float(len(names))
    return 1.0


def _weighted_means(sums: Dict[str, torch.Tensor], total_w: float) -> Dict[str, float]:
    return {k: float(v) / max(total_w, 1.0) for k, v in sums.items()}


def epoch_generator(seed: int, epoch: int, device) -> torch.Generator:
    """The dropout generator of one epoch, on ``device``."""
    state = np.random.SeedSequence([seed, epoch]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def run_train_epoch(state, loader, train_step, generator: torch.Generator, device):
    """One training epoch; returns (state, sentence-weighted mean metrics)."""
    sums, total_w = {}, 0.0
    for batch, meta in to_device(loader, device):
        metrics = train_step(state, batch, generator)
        w = _batch_weight(meta)
        total_w += w
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + w * v
    return state, _weighted_means(sums, total_w)


def run_eval_epoch(state, loader, eval_step, device) -> Dict[str, float]:
    sums, total_w = {}, 0.0
    for batch, meta in to_device(loader, device):
        metrics, _ = eval_step(state, batch)
        w = _batch_weight(meta)
        total_w += w
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + w * v
    return _weighted_means(sums, total_w)


@dataclass
class FitResult:
    state: object
    best_metric: float
    best_params_dir: str
    last_epoch: int
    history: list = field(default_factory=list)


def fit(
    state,
    train_loader,
    valid_loader,
    train_step: Callable,
    eval_step: Callable,
    n_epochs: int,
    checkpoints_dir: str,
    monitor: str = "p2cp_mm",
    patience: int = 30,
    scheduler: Optional[PlateauScheduler] = None,
    tracker=None,
    seed: int = 0,
    resume: bool = False,
    resume_from: Optional[str] = None,
    epoch_callback: Optional[Callable] = None,
    device: DeviceLike = None,
) -> FitResult:
    """Full training run with plateau LR, early stopping and checkpoints.

    Layout under ``checkpoints_dir``: ``best/`` (state at the best valid
    metric), ``last/`` (the rolling resume checkpoint with the scheduler's
    and stopper's state in aux.json) and ``best_model`` (model only).
    ``resume_from`` restores that checkpoint directory; plain ``resume``
    restores ``last/`` if it exists. Each epoch's record (without ``best``)
    goes to ``tracker.log_metrics(..., step=epoch)``, and after the epoch's
    checkpoints to ``epoch_callback(epoch, state, record)`` when given.
    ``device``: ``cuda`` unless the caller passes ``device="cpu"``.
    """
    dev = resolve_device(device)
    os.makedirs(checkpoints_dir, exist_ok=True)
    best_dir = os.path.join(checkpoints_dir, "best")
    last_dir = os.path.join(checkpoints_dir, "last")
    best_model = os.path.join(checkpoints_dir, "best_model")
    scheduler = scheduler or PlateauScheduler()
    stopper = EarlyStopping(patience=patience)
    start_epoch = 0

    restore_dir = None
    if resume_from is not None:
        if not has_checkpoint(resume_from):
            raise FileNotFoundError(f"--checkpoint path has no train state: {resume_from}")
        restore_dir = resume_from
    elif resume and has_checkpoint(last_dir):
        restore_dir = last_dir
    if restore_dir is not None:
        state, aux = restore_checkpoint(restore_dir, state)
        if aux:
            start_epoch = int(aux.get("epoch", -1)) + 1
            stopper.best_metric = float(aux.get("best_metric", float("inf")))
            stopper.epochs_since_best = int(aux.get("epochs_since_best", 0))
            scheduler.best = float(aux.get("scheduler_best", float("inf")))
            scheduler.bad_epochs = int(aux.get("scheduler_bad_epochs", 0))

    history = []
    epoch = start_epoch - 1
    for epoch in range(start_epoch, n_epochs):
        generator = epoch_generator(seed, epoch, dev)
        state, train_metrics = run_train_epoch(state, train_loader, train_step, generator, dev)
        valid_metrics = run_eval_epoch(state, valid_loader, eval_step, dev)
        monitored = valid_metrics[monitor]

        state = scheduler.step(valid_metrics.get("loss", monitored), state)
        is_best = stopper.update(monitored)

        record = {
            "epoch": epoch,
            "lr": get_learning_rate(state),
            **{f"train_{k}": v for k, v in train_metrics.items()},
            **{f"valid_{k}": v for k, v in valid_metrics.items()},
            "best": is_best,
        }
        history.append(record)
        if tracker is not None:
            tracker.log_metrics({k: v for k, v in record.items() if k != "best"}, step=epoch)

        if is_best:
            save_checkpoint(best_dir, state, aux={"epoch": epoch, monitor: monitored})
            save_params(best_model, state.model)
        save_checkpoint(
            last_dir,
            state,
            aux={
                "epoch": epoch,
                "best_metric": stopper.best_metric,
                "epochs_since_best": stopper.epochs_since_best,
                "scheduler_best": scheduler.best,
                "scheduler_bad_epochs": scheduler.bad_epochs,
            },
        )
        if epoch_callback is not None:
            epoch_callback(epoch, state, record)
        if stopper.should_stop:
            break

    # A resumed run may complete zero epochs (or never improve): downstream
    # always needs a best checkpoint in this run's directory.
    if not has_checkpoint(best_dir):
        save_checkpoint(best_dir, state, aux={"epoch": epoch, monitor: stopper.best_metric})
        save_params(best_model, state.model)

    return FitResult(
        state=state,
        best_metric=stopper.best_metric,
        best_params_dir=best_dir,
        last_epoch=epoch,
        history=history,
    )
