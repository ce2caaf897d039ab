"""Training orchestration (counterpart of artspeech_tpu/train/loop.py).

The reference loop (train_phoneme_to_articulation.py:124-426): train and valid
epochs with sentence-weighted means, ReduceLROnPlateau on the valid loss,
early stopping on the valid P2CP in mm, ``best/``, ``last/`` and
``best_model`` checkpoints, and resume. Each epoch's dropout masks come from a
``torch.Generator`` on the device seeded from (``seed``, epoch), in place of
``jax.random.split``, so a resumed run draws the masks an uninterrupted one
would.

Over a process group ``fit`` trains data-parallel (JAX :128-162): it resolves
a mesh from the loader's collated batch, builds the steps against it, gives
every rank rank 0's state, and feeds each rank its rows of every batch. The
epoch means stay weighted by each batch's global count of real sentences.
An explicit mesh may have a model axis: ``distribute_state`` then splits the
stacked heads and channels over it, and the checkpoints gather them whole
(train/checkpoint.py), so they are a one-device run's. Every rank calls the
saves (the gather is collective) and rank 0 writes them; rank 0 alone writes
the tracker's records and calls the epoch callback; the others wait for it at
a barrier. Every rank takes rank 0's validation metrics, so the scheduler,
the stopper and the saves decide alike.
"""

import os
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import numpy as np
import torch

from artspeech_tpu_torch.core.device import DeviceLike, resolve_device
from artspeech_tpu_torch.data.batching import prefetch_to_device
from artspeech_tpu_torch.parallel.distributed import (
    barrier,
    broadcast_object,
    distribute_state,
    is_initialized,
    is_main_process,
)
from artspeech_tpu_torch.parallel.mesh import batch_sharding, data_parallel_mesh
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


def folded_seed(seed: int, *keys: int) -> int:
    """A seed derived from ``seed`` and ``keys`` (``jax.random.fold_in``'s role)."""
    return int(np.random.SeedSequence([seed, *keys]).generate_state(1, np.uint64)[0])


def epoch_generator(seed: int, epoch: int, device, rank: int = 0) -> torch.Generator:
    """The dropout generator of one epoch, on ``device``. A mesh's data rank
    ``rank`` > 0 folds its coordinate in, so the ranks draw different masks;
    rank 0 draws the one-device run's, and the model ranks of one data row
    the same."""
    keys = (epoch,) if rank == 0 else (epoch, rank)
    return torch.Generator(device=device).manual_seed(folded_seed(seed, *keys))


def run_train_epoch(state, loader, train_step, generator: torch.Generator, device,
                    sharding=None):
    """One training epoch; returns (state, sentence-weighted mean metrics).
    With ``sharding`` each step gets the rank's rows."""
    sums, total_w = {}, 0.0
    for batch, meta in prefetch_to_device(loader, device=device, sharding=sharding):
        metrics = train_step(state, batch, generator)
        w = _batch_weight(meta)
        total_w += w
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + w * v
    return state, _weighted_means(sums, total_w)


def run_eval_epoch(state, loader, eval_step, device, sharding=None) -> Dict[str, float]:
    sums, total_w = {}, 0.0
    for batch, meta in prefetch_to_device(loader, device=device, sharding=sharding):
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
    mesh="auto",
    train_step_factory: Optional[Callable] = None,
    eval_step_factory: Optional[Callable] = None,
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

    ``mesh="auto"`` trains over the process group's ranks when there is a
    group: the data axis takes the largest rank count that divides the
    loader's ``collate_batch_size`` (JAX's rule). Without a group, or with
    ``mesh=None``, this is the one-device loop. An explicit ``Mesh`` may
    have a model axis; the checkpoints are whole all the same, and restore
    loads whole before ``distribute_state`` slices, so a checkpoint resumes
    on one device or on any mesh. ``train_step_factory(mesh)``
    and ``eval_step_factory(mesh)`` build the steps against the resolved mesh
    (None when there is none) and replace ``train_step`` / ``eval_step``.
    Every rank must call ``fit`` alike; rank 0 writes, the others wait.
    """
    dev = resolve_device(device)
    if mesh == "auto":
        collate_bs = getattr(train_loader, "collate_batch_size",
                             getattr(train_loader, "batch_size", None))
        mesh = data_parallel_mesh(collate_bs, device=dev) if is_initialized() else None
    if train_step_factory is not None:
        train_step = train_step_factory(mesh)
    if eval_step_factory is not None:
        eval_step = eval_step_factory(mesh)
    sharding = batch_sharding(mesh) if mesh is not None else None
    rank = mesh.data_index if mesh is not None else 0  # raises on a rank left out
    main = is_main_process()
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
    if mesh is not None:
        state = distribute_state(state, mesh)

    history = []
    epoch = start_epoch - 1
    for epoch in range(start_epoch, n_epochs):
        generator = epoch_generator(seed, epoch, dev, rank)
        state, train_metrics = run_train_epoch(state, train_loader, train_step, generator, dev,
                                               sharding)
        valid_metrics = broadcast_object(
            run_eval_epoch(state, valid_loader, eval_step, dev, sharding), mesh)
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
        if main and tracker is not None:
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
        if main and epoch_callback is not None:
            epoch_callback(epoch, state, record)
        barrier(mesh)
        if stopper.should_stop:
            break

    # A resumed run may complete zero epochs (or never improve): downstream
    # always needs a best checkpoint in this run's directory.
    if broadcast_object(main and not has_checkpoint(best_dir), mesh):
        save_checkpoint(best_dir, state, aux={"epoch": epoch, monitor: stopper.best_metric})
        save_params(best_model, state.model)
    barrier(mesh)

    return FitResult(
        state=state,
        best_metric=stopper.best_metric,
        best_params_dir=best_dir,
        last_epoch=epoch,
        history=history,
    )
