"""JAX (orbax) checkpoints converted into the port's, on the CPU.

JAX trains two steps and saves with its own ``save_checkpoint``;
``convert_orbax_checkpoint.py`` writes ``state.pt`` (``state_from_flax_trees``:
parameters, AdamW's moments, step and learning rate) and carries
``aux.json`` across; the port restores it into a freshly initialised model
and takes the third step, which matches JAX's third step within 1e-5 (loss
relative, parameters within 1e-5 * max(|ref|, 1)):
- ArtSpeech at dropout 0, with ``optax.inject_hyperparams(adamw)`` (the
  articulation CLIs' optimizer);
- the frame autoencoder with plain ``optax.adamw`` (its CLI's optimizer),
  whose learning rate the restored optimizer keeps; and its model-only
  ``best_model`` through the script's command line.
"""

import importlib.util
import os
import sys

import jax
import numpy as np
import optax
import torch
from flax.training import train_state as flax_train_state

from artspeech_tpu.models import autoencoder as jax_ae
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.train import checkpoint as jax_checkpoint
from artspeech_tpu.train import pc_step as jax_pc_step
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.train import step as jax_step
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.autoencoder import MultiArticulatorAutoencoder
from artspeech_tpu_torch.models.autoencoder import normalize_indices_dict
from artspeech_tpu_torch.train import checkpoint, pc_step, state
from artspeech_tpu_torch.train.step import make_artspeech_train_step
from artspeech_tpu_torch.utils.convert import (
    artspeech_state_dict_from_flax,
    autoencoder_state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "convert_orbax_checkpoint", os.path.join(REPO, "convert_orbax_checkpoint.py"))
convert_orbax_checkpoint = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert_orbax_checkpoint)
VOCAB, N_ART, EMBED, HIDDEN = 12, 3, 8, 16
LR, WD = 1e-3, 1e-5
TO_MM = 136 * 1.6176470518112
TOL = 1e-5


def _tree(tree):
    return jax.tree_util.tree_map(np.array, tree)


def _assert_params_close(model, ref):
    got = model.state_dict()
    assert set(got) == set(ref)
    for name, r in ref.items():
        r = r.numpy()
        assert np.abs(got[name].numpy() - r).max() <= TOL * max(np.abs(r).max(), 1.0), name


def test_artspeech_checkpoint_converts_and_resumes(tmp_path):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, VOCAB, (4, 16)).astype(np.int32),
             "targets": rng.random((4, 16, N_ART, 2, 50)).astype(np.float32),
             "lengths": np.array([16, 11, 5, 9], np.int32)}
    model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                         hidden_size=HIDDEN, dropout=0.0)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), batch["tokens"],
                                 batch["lengths"])["params"]  # jitted: faster than eager
    st = flax_train_state.TrainState.create(apply_fn=model.apply, params=params,
                                            tx=jax_state.make_optimizer(LR, WD))
    st = jax_state.set_learning_rate(st, LR / 2)  # a plateau drop, carried across
    train_step = jax_step.make_artspeech_train_step(TO_MM, donate=False)
    for i in range(2):
        st, _ = train_step(st, batch, jax.random.PRNGKey(i))
    aux = {"epoch": 1, "best_metric": 3.5, "epochs_since_best": 0}
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax" / "last"), st, aux=aux)
    params2 = artspeech_state_dict_from_flax(_tree(st.params))
    st, ref = train_step(st, batch, jax.random.PRNGKey(2))

    written = convert_orbax_checkpoint.convert(str(tmp_path / "jax" / "last"),
                                               str(tmp_path / "port" / "last"), "artspeech")
    assert written == str(tmp_path / "port" / "last" / "state.pt")
    port = state.create_train_state(
        ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN,
                  generator=torch.Generator().manual_seed(5), device="cpu"), LR, WD)
    port, port_aux = checkpoint.restore_checkpoint(str(tmp_path / "port" / "last"), port)
    assert port_aux == aux and port.step == 2
    assert state.get_learning_rate(port) == np.float32(LR / 2)
    for name, p in port.model.state_dict().items():
        assert torch.equal(p, params2[name]), name
    adam = port.optimizer.state_dict()["state"]
    assert len(adam) == len(list(port.model.parameters()))
    assert all(float(s["step"]) == 2 for s in adam.values())

    metrics = make_artspeech_train_step(TO_MM, device="cpu")(port, batch)
    assert abs(metrics["loss"].item() - float(ref["loss"])) <= TOL * abs(float(ref["loss"]))
    assert port.step == 3
    _assert_params_close(port.model, artspeech_state_dict_from_flax(_tree(st.params)))


INDICES = {"lower-lip": 2, "tongue": 3, "upper-lip": 2}
IN_F, HIDDEN_F = 20, 8


def test_autoencoder_checkpoint_converts_and_resumes(tmp_path, monkeypatch, capsys):
    rng = np.random.default_rng(1)
    arts = len(INDICES)
    mean = rng.uniform(0.3, 0.7, (arts, 2, IN_F // 2)).astype(np.float32)
    std = rng.uniform(0.05, 0.2, (arts, 2, IN_F // 2)).astype(np.float32)
    batch = {"inputs": rng.standard_normal((6, arts, IN_F)).astype(np.float32),
             "weights": np.array([1, 3, 0.1, 1, 0, 0], np.float32)}
    indices = normalize_indices_dict(INDICES)
    model = jax_ae.MultiArticulatorAutoencoder(indices_dict=INDICES, in_features=IN_F,
                                               hidden_features=HIDDEN_F)
    params = jax.jit(model.init)(jax.random.PRNGKey(1), batch["inputs"][:1])["params"]
    st = flax_train_state.TrainState.create(apply_fn=model.apply, params=params,
                                            tx=optax.adamw(LR, weight_decay=WD))
    step = jax_pc_step.make_autoencoder_train_step(model, indices, 0.1, mean, std, TO_MM,
                                                   donate=False)
    for _ in range(2):
        st, _ = step(st, batch)
    jax_checkpoint.save_checkpoint(str(tmp_path / "jax" / "best"), st)
    jax_checkpoint.save_params(str(tmp_path / "jax" / "best_model"), st.params)
    st, ref = step(st, batch)

    convert_orbax_checkpoint.convert(str(tmp_path / "jax" / "best"),
                                     str(tmp_path / "port" / "best"), "autoencoder")
    assert not os.path.exists(tmp_path / "port" / "best" / "aux.json")
    port = state.create_train_state(MultiArticulatorAutoencoder(INDICES, IN_F, HIDDEN_F,
                                                                device="cpu"), LR, WD)
    port, aux = checkpoint.restore_checkpoint(str(tmp_path / "port" / "best"), port)
    assert aux is None and port.step == 2 and state.get_learning_rate(port) == LR
    got = pc_step.make_autoencoder_train_step(indices, 0.1, mean, std, TO_MM,
                                              device="cpu")(port, batch)
    assert abs(got["loss"].item() - float(ref["loss"])) <= TOL * abs(float(ref["loss"]))
    _assert_params_close(port.model, autoencoder_state_dict_from_flax(_tree(st.params)))

    # The model-only artifact through the command line.
    monkeypatch.setattr(sys, "argv", ["convert_orbax_checkpoint.py", "--family", "autoencoder",
                                      str(tmp_path / "jax" / "best_model"),
                                      str(tmp_path / "best_model")])
    convert_orbax_checkpoint.main()
    assert capsys.readouterr().out.strip() == f"wrote {tmp_path / 'best_model'}"
    loaded = checkpoint.load_params(str(tmp_path / "best_model"))
    ref_params = autoencoder_state_dict_from_flax(_tree(jax_checkpoint.load_params(
        str(tmp_path / "jax" / "best_model"), params)))
    assert set(loaded) == set(ref_params)
    for name, value in ref_params.items():
        assert torch.equal(loaded[name], value), name
