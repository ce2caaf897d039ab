"""Train state, optimizer and plateau LR scheduling (counterpart of
artspeech_tpu/train/state.py).

The reference scaffold (train_phoneme_to_articulation.py): Adam with decoupled
weight decay, ReduceLROnPlateau(factor=0.1, patience=10) and early stopping on
the valid P2CP. The scheduler and the stopper are host-side copies of the JAX
package's; the learning rate lives in the optimizer's ``param_groups``.
"""

from dataclasses import dataclass, field

import torch
from torch import nn


@dataclass
class TrainState:
    """The model, its optimizer and the number of optimizer steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(params, learning_rate: float, weight_decay: float = 0.0):
    """``torch.optim.AdamW`` as ``optax.adamw`` (b1 0.9, b2 0.999, eps 1e-8).

    Both decay decoupled from the gradient and against the parameter before
    the step: ``p <- p - lr * (m_hat / (sqrt(v_hat) + eps) + wd * p)``. torch
    applies the bias corrections as ``lr / (1 - b1^t)`` and
    ``sqrt(v) / sqrt(1 - b2^t)``, optax to ``m`` and ``v`` themselves; the two
    are algebraically the same.
    """
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


def create_train_state(model: nn.Module, learning_rate: float,
                       weight_decay: float = 0.0) -> TrainState:
    return TrainState(model=model,
                      optimizer=make_optimizer(model.parameters(), learning_rate, weight_decay))


def set_learning_rate(state: TrainState, lr: float) -> TrainState:
    for group in state.optimizer.param_groups:
        group["lr"] = lr
    return state


def get_learning_rate(state: TrainState) -> float:
    return float(state.optimizer.param_groups[0]["lr"])


@dataclass
class PlateauScheduler:
    """ReduceLROnPlateau equivalent (torch defaults: factor 0.1, patience 10)."""

    factor: float = 0.1
    patience: int = 10
    min_lr: float = 0.0
    best: float = float("inf")
    bad_epochs: int = 0

    def step(self, metric: float, state: TrainState) -> TrainState:
        if metric < self.best:
            self.best = metric
            self.bad_epochs = 0
            return state
        self.bad_epochs += 1
        if self.bad_epochs > self.patience:
            self.bad_epochs = 0
            new_lr = max(get_learning_rate(state) * self.factor, self.min_lr)
            state = set_learning_rate(state, new_lr)
        return state


@dataclass
class EarlyStopping:
    """Best-metric tracking + patience (reference
    train_phoneme_to_articulation.py:292-321)."""

    patience: int = 30
    best_metric: float = field(default=float("inf"))
    epochs_since_best: int = 0

    def update(self, metric: float) -> bool:
        """Returns True if this epoch is a new best."""
        if metric < self.best_metric:
            self.best_metric = metric
            self.epochs_since_best = 0
            return True
        self.epochs_since_best += 1
        return False

    @property
    def should_stop(self) -> bool:
        return self.epochs_since_best > self.patience


def count_parameters(model: nn.Module) -> int:
    return sum(p.numel() for p in model.parameters())
