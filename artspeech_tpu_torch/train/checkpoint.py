"""Checkpoints in torch's format with the JAX package's directory layout
(counterpart of artspeech_tpu/train/checkpoint.py).

- ``<dir>/state.pt``: ``{"model": state_dict, "optimizer": state_dict,
  "step": int}`` (the JAX side keeps its orbax train state in ``<dir>/state``);
- ``<dir>/aux.json``: host-side scheduler and stopper state;
- a model-only artifact (``best_model``): a bare model ``state_dict``, like
  the reference ``best_model.pt``.

Files are written to a temporary name and renamed, so a run cut mid-write
leaves the previous checkpoint whole. They are loaded with
``weights_only=True``. ``load_params`` reads ``<dir>/state`` as the model
part of ``<dir>/state.pt``, so the configs' ``state_dict_filepath:
results/checkpoints/best/state`` works as it does for the JAX package.
Converting an orbax checkpoint is not ported yet.
"""

import json
import os
from typing import Any, Dict, Optional

import torch

STATE_FILE = "state.pt"
AUX_FILE = "aux.json"


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def save_checkpoint(directory: str, state, aux: Optional[Dict[str, Any]] = None) -> None:
    """Write the model and optimizer state (and ``aux`` as JSON) under ``directory``."""
    os.makedirs(directory, exist_ok=True)
    _save({"model": state.model.state_dict(), "optimizer": state.optimizer.state_dict(),
           "step": state.step}, os.path.join(directory, STATE_FILE))
    if aux is not None:
        tmp = os.path.join(directory, AUX_FILE + ".tmp")
        with open(tmp, "w") as f:
            json.dump(aux, f)
        os.replace(tmp, os.path.join(directory, AUX_FILE))


def has_checkpoint(directory: str) -> bool:
    return os.path.isfile(os.path.join(directory, STATE_FILE))


def restore_checkpoint(directory: str, state):
    """Load ``directory`` into ``state`` (its model and optimizer, in place).
    Returns (state, aux), aux None when the directory has no aux.json."""
    saved = torch.load(os.path.join(directory, STATE_FILE), map_location="cpu",
                       weights_only=True)
    state.model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    aux = None
    aux_path = os.path.join(directory, AUX_FILE)
    if os.path.isfile(aux_path):
        with open(aux_path) as f:
            aux = json.load(f)
    return state, aux


def save_params(path: str, model) -> None:
    """Write a model-only artifact: the bare ``state_dict``."""
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    _save(model.state_dict(), path)


def load_params(path: str) -> Dict[str, torch.Tensor]:
    """A model ``state_dict`` from any of the forms the JAX package's
    ``load_params`` accepts and the repository's configs name:

    - ``<dir>/state`` (``results/checkpoints/best/state``): the model part of
      ``<dir>/state.pt``;
    - ``<dir>``, a train-state checkpoint directory: the same;
    - a model-only artifact (``best_model``).
    """
    state_file = None
    if os.path.isdir(path):
        state_file = os.path.join(path, STATE_FILE)
    elif os.path.basename(path) == "state" and not os.path.exists(path):
        state_file = os.path.join(os.path.dirname(path), STATE_FILE)
    if state_file is not None:
        if not os.path.isfile(state_file):
            raise FileNotFoundError(f"no model parameters at {path}: {state_file} is missing")
        return torch.load(state_file, map_location="cpu", weights_only=True)["model"]
    return torch.load(path, map_location="cpu", weights_only=True)
