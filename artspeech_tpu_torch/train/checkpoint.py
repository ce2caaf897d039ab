"""Checkpoints in torch's format with the JAX package's directory layout
(counterpart of artspeech_tpu/train/checkpoint.py).

- ``<dir>/state.pt``: ``{"model": state_dict, "optimizer": state_dict,
  "step": int}`` (the JAX side keeps its orbax train state in ``<dir>/state``);
- ``<dir>/aux.json``: host-side scheduler and stopper state;
- a model-only artifact (``best_model``): a bare model ``state_dict``, like
  the reference ``best_model.pt``.

Files are written to a temporary name and renamed, so a run cut mid-write
leaves the previous checkpoint whole. On a mesh with a model axis, the
parameters that a module keeps one rank's slice of (``shard_model_axis``)
and their AdamW moments are gathered whole first, so a checkpoint has the
keys, shapes and dtypes of a one-device run's and loads into an unsharded
model; the gather is a collective, so every rank of the model group calls
``save_checkpoint`` / ``save_params``, and only rank 0 writes. They are loaded with
``weights_only=True``. ``load_params`` reads ``<dir>/state`` as the model
part of ``<dir>/state.pt``, so the configs' ``state_dict_filepath:
results/checkpoints/best/state`` works as it does for the JAX package.

A JAX checkpoint converts with :func:`state_from_flax_trees` /
:func:`save_flax_trees` from its trees as numpy (the top-level
``convert_orbax_checkpoint.py`` reads the orbax directory, which needs jax).
Its optimizer state is keyed by parameter name; :func:`restore_checkpoint`
orders it by the model's own parameters.
"""

import json
import os
from typing import Any, Callable, Dict, Mapping, Optional

import numpy as np
import torch

from artspeech_tpu_torch.parallel.collectives import gather_leading_slices
from artspeech_tpu_torch.parallel.distributed import is_main_process
from artspeech_tpu_torch.utils import convert

STATE_FILE = "state.pt"
AUX_FILE = "aux.json"


def _save(obj, path: str) -> None:
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


def whole_state_dicts(model, optimizer=None):
    """The model's (and the ``optimizer``'s, else None) state dict with
    every model-axis slice gathered whole (module docstring); the module's
    own when nothing is sharded. A collective over the model group when
    something is: every rank of it calls this."""
    model_sd = model.state_dict()
    optim_sd = None if optimizer is None else optimizer.state_dict()
    sliced = {}
    for module in model.modules():
        if getattr(module, "model_axis", None) is not None:
            for _, p in module.model_axis_parameters():
                sliced[id(p)] = module.model_axis
    if not sliced:
        return model_sd, optim_sd
    (group, index, size), = set(sliced.values())
    slots = [(model_sd, name, p) for name, p in model.named_parameters() if id(p) in sliced]
    if optimizer is not None:
        params = [p for g in optimizer.param_groups for p in g["params"]]
        for i, p in enumerate(params):
            if id(p) in sliced and i in optim_sd["state"]:
                # A copy: the packed state holds the optimizer's own dicts.
                moments = optim_sd["state"][i] = dict(optim_sd["state"][i])
                slots += [(moments, k, v) for k, v in moments.items()
                          if torch.is_tensor(v) and v.shape == p.shape]
    wholes = gather_leading_slices([t for _, _, t in slots], group, index, size)
    for (target, key, _), whole in zip(slots, wholes):
        target[key] = whole
    return model_sd, optim_sd


def save_checkpoint(directory: str, state, aux: Optional[Dict[str, Any]] = None) -> None:
    """Write the model and optimizer state (and ``aux`` as JSON) under
    ``directory``, whole: every rank calls this, rank 0 writes."""
    model_sd, optim_sd = whole_state_dicts(state.model, state.optimizer)
    if not is_main_process():
        return
    os.makedirs(directory, exist_ok=True)
    _save({"model": model_sd, "optimizer": optim_sd, "step": state.step},
          os.path.join(directory, STATE_FILE))
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
    optimizer = saved["optimizer"]
    if optimizer is not None:
        if _by_name(optimizer):
            optimizer = _indexed(optimizer, state)
        state.optimizer.load_state_dict(optimizer)
    state.step = int(saved["step"])
    aux = None
    aux_path = os.path.join(directory, AUX_FILE)
    if os.path.isfile(aux_path):
        with open(aux_path) as f:
            aux = json.load(f)
    return state, aux


def save_params(path: str, model) -> None:
    """Write a model-only artifact: the bare ``state_dict``, whole (every
    rank calls this, rank 0 writes)."""
    model_sd, _ = whole_state_dicts(model)
    if not is_main_process():
        return
    parent = os.path.dirname(os.path.abspath(path))
    os.makedirs(parent, exist_ok=True)
    _save(model_sd, path)


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


def _flax_artspeech(params: Mapping) -> Dict[str, torch.Tensor]:
    if "BiGRU_0" in params:
        return convert.artspeech_state_dict_from_flax(params)
    return convert.simple_artspeech_state_dict_from_flax(params)


#: Model family -> the converter of its flax param trees (utils/convert.py).
FLAX_CONVERTERS: Dict[str, Callable[[Mapping], Dict[str, torch.Tensor]]] = {
    "artspeech": _flax_artspeech,  # ArtSpeech or SimpleArtSpeech
    "transformer": convert.transformer_state_dict_from_flax,
    "latent_rnn": convert.latent_rnn_state_dict_from_flax,
    "autoencoder": convert.autoencoder_state_dict_from_flax,
    "deepspeech2": convert.deepspeech2_state_dict_from_flax,
}

#: optax hyperparameter -> torch AdamW param-group key.
_HYPERPARAMS = {"learning_rate": "lr", "weight_decay": "weight_decay", "eps": "eps"}


def _adam_state(tree) -> Optional[Mapping]:
    """The ``scale_by_adam`` state (``count``, ``mu``, ``nu``) anywhere in an
    optax state tree of dicts and lists."""
    if isinstance(tree, Mapping):
        if {"count", "mu", "nu"} <= set(tree):
            return tree
        children = tree.values()
    elif isinstance(tree, (list, tuple)):
        children = tree
    else:
        return None
    for child in children:
        found = _adam_state(child)
        if found is not None:
            return found
    return None


def state_from_flax_trees(params: Mapping, opt_state, step, family: str) -> Dict[str, Any]:
    """A JAX train state as the port's ``state.pt`` content.

    Args:
        params: the flax param tree, numpy leaves.
        opt_state: the optax state tree (dicts and lists, numpy leaves) of
            ``optax.inject_hyperparams(optax.adamw)`` or plain ``optax.adamw``,
            or None for parameters only.
        step: the train state's step.
        family: a key of FLAX_CONVERTERS.
    Returns:
        ``{"model", "optimizer", "step"}``: the model's ``state_dict``, and
        AdamW's state keyed by parameter name: ``mu`` / ``nu`` / ``count``
        as ``exp_avg`` / ``exp_avg_sq`` / ``step``, mapped by the parameters'
        own converter (so with the same transposes), and the injected
        learning rate, weight decay, eps and betas as the group's ``lr``,
        ``weight_decay``, ``eps`` and ``betas`` (absent for plain adamw: the
        optimizer restored into keeps its own).
    """
    to_torch = FLAX_CONVERTERS[family]
    model = to_torch(params)
    adam = _adam_state(opt_state) if opt_state is not None else None
    optimizer = None
    if adam is not None:
        exp_avg, exp_avg_sq = to_torch(adam["mu"]), to_torch(adam["nu"])
        count = float(np.asarray(adam["count"]))
        hyper = opt_state.get("hyperparams", {}) if isinstance(opt_state, Mapping) else {}
        group = {torch_key: float(np.asarray(hyper[key]))
                 for key, torch_key in _HYPERPARAMS.items() if key in hyper}
        if "b1" in hyper and "b2" in hyper:
            group["betas"] = (float(np.asarray(hyper["b1"])), float(np.asarray(hyper["b2"])))
        optimizer = {
            "state": {name: {"step": torch.tensor(count), "exp_avg": exp_avg[name],
                             "exp_avg_sq": exp_avg_sq[name]} for name in model},
            "param_groups": [{**group, "params": list(model)}],
        }
    return {"model": model, "optimizer": optimizer, "step": int(np.asarray(step))}


def save_flax_trees(directory: str, params: Mapping, opt_state, step, family: str,
                    aux: Optional[Dict[str, Any]] = None) -> None:
    """Write :func:`state_from_flax_trees` as ``<directory>/state.pt``, and
    ``aux`` (the JAX checkpoint's aux.json) beside it."""
    os.makedirs(directory, exist_ok=True)
    _save(state_from_flax_trees(params, opt_state, step, family),
          os.path.join(directory, STATE_FILE))
    if aux is not None:
        with open(os.path.join(directory, AUX_FILE), "w") as f:
            json.dump(aux, f)


def _by_name(optimizer: Mapping) -> bool:
    return any(isinstance(p, str) for g in optimizer["param_groups"] for p in g["params"])


def _indexed(optimizer: Mapping, state) -> Dict[str, Any]:
    """A converted optimizer state (keyed by parameter name) in the form
    ``state.optimizer.load_state_dict`` takes: each named state at its
    parameter's index, the converted hyperparameters over each group's own."""
    index = {id(p): i for i, p in enumerate(
        p for g in state.optimizer.param_groups for p in g["params"])}
    names = {name: index[id(p)] for name, p in state.model.named_parameters() if id(p) in index}
    own = state.optimizer.state_dict()
    hyper = {k: v for k, v in optimizer["param_groups"][0].items() if k != "params"}
    return {"state": {names[name]: v for name, v in optimizer["state"].items() if name in names},
            "param_groups": [{**group, **hyper} for group in own["param_groups"]]}
