"""The port's thesis CLIs against the JAX package's, on the CPU.

Each CLI runs in-process through its ``run_experiment`` with ``sys.argv``
set (``--device cpu`` for the port), from a YAML config written with
``yaml.safe_dump`` and read by the port's own reader:
- the test CLI, with the same weights on both sides (the JAX params saved
  with the JAX ``save_params``; the converted ``state_dict`` saved with the
  port's ``save_params`` and in a port train-state checkpoint) and each form
  of ``state_dict_filepath`` that the repository's configs use
  (``<ckpts>/best/state``, ``<ckpts>/best``, ``<ckpts>/best_model``):
  ``test_results.json`` within 1e-5, the same ``test_outputs/`` tree with
  arrays and CSV numbers within 1e-5;
- the generate CLI: the same tree, arrays within 1e-5, the same target
  sequences; the xarticul numbers are pixels (x 136), so within 136e-5;
- the train CLI for 2 epochs with dropout 0: the same files as the JAX train
  CLI (checkpoint internals aside: orbax writes directories where the port
  writes ``state.pt`` and a ``best_model`` file), one ``metrics.jsonl``
  record per epoch with JAX's keys (but its data-parallel marker), and a
  ``test_results.json`` with JAX's keys and finite values.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.train.checkpoint import save_params as jax_save_params
from artspeech_tpu_torch.cli.common import model_kwargs_from_cfg
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.train import checkpoint, state
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax

ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL = {"embed_dim": 8, "hidden_size": 16}


def _run(package, module_name, cfg, output_dir, monkeypatch, tmp_path):
    cfg_path = tmp_path / f"{package}_{module_name}_{len(os.listdir(tmp_path))}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    module = importlib.import_module(f"{package}.cli.{module_name}")
    common = importlib.import_module(f"{package}.cli.common")
    argv = [module_name, "--config", str(cfg_path), "--output_dir", str(output_dir),
            "--run_name", "run"]
    if package == "artspeech_tpu_torch":
        argv += ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    return common.run_experiment(module_name, module.main)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def _numbers(path):
    """Every field or word of a text file that parses as a number."""
    values = []
    with open(path) as f:
        for token in f.read().replace(",", " ").split():
            try:
                values.append(float(token))
            except ValueError:
                pass
    return values


def _assert_same_tree(got_dir, ref_dir, atol, txt_atol=None):
    names = _files(ref_dir)
    assert _files(got_dir) == names and names
    for name in names:
        got, ref = os.path.join(got_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(got), np.load(ref), rtol=0, atol=atol,
                                       err_msg=name)
        elif name.endswith(".csv") or name.endswith(".txt"):
            with open(got) as f_got, open(ref) as f_ref:
                got_lines, ref_lines = f_got.read().splitlines(), f_ref.read().splitlines()
            assert len(got_lines) == len(ref_lines), name
            if name.endswith(".csv"):
                assert got_lines[0] == ref_lines[0], name  # the same columns, in order
            np.testing.assert_allclose(_numbers(got), _numbers(ref), rtol=0,
                                       atol=txt_atol if name.endswith(".txt") else atol,
                                       err_msg=name)
            if name.endswith("target_sequence.txt") or name.endswith("phonemes.csv"):
                assert got_lines == ref_lines, name


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """A corpus, its vocabulary and one set of weights in every form."""
    root = tmp_path_factory.mktemp("cli")
    corpus = str(root / "corpus")
    info = make_synthetic_corpus(corpus, subjects=("s1",), sequences=("S01", "S02", "S03"),
                                 n_sentences=3, frames_per_sentence=10)
    vocab_path = os.path.join(corpus, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    vocab_size = len(load_vocabulary(vocab_path))

    model = JaxArtSpeech(vocab_size=vocab_size, n_articulators=len(ARTS), **MODEL)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32),
                        jnp.full((1,), 8, jnp.int32))["params"]
    jax_save_params(str(root / "jax_ckpts" / "best_model"), params)
    port_model = ArtSpeech(vocab_size, len(ARTS), **MODEL, device="cpu")
    port_model.load_state_dict(artspeech_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params)))
    checkpoint.save_params(str(root / "ckpts" / "best_model"), port_model)
    checkpoint.save_checkpoint(str(root / "ckpts" / "best"),
                               state.create_train_state(port_model, 1e-3))
    base = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path,
            "articulators": ARTS, "clip_tails": True}
    return {"root": root, "base": base}


@pytest.fixture(scope="module")
def jax_test_run(workdir, tmp_path_factory):
    """The JAX test CLI on S03 from the JAX ``best_model``."""
    out = workdir["root"] / "jax_test"
    cfg = {**workdir["base"], "batch_size": 2, "model_kwargs": MODEL,
           "state_dict_filepath": str(workdir["root"] / "jax_ckpts" / "best_model"),
           "test_seq_dict": {"s1": ["S03"]}}
    with pytest.MonkeyPatch.context() as monkeypatch:
        info = _run("artspeech_tpu", "test_phoneme_to_articulation", cfg, out, monkeypatch,
                    tmp_path_factory.mktemp("jax_test_cfg"))
    return info, out


@pytest.mark.parametrize("form", ["best/state", "best", "best_model"])
def test_test_cli_matches_jax(workdir, jax_test_run, tmp_path, monkeypatch, form):
    ref_info, ref_out = jax_test_run
    out = tmp_path / "port_test"
    cfg = {**workdir["base"], "batch_size": 2, "model_kwargs": MODEL,
           "state_dict_filepath": str(workdir["root"] / "ckpts" / form),
           "test_seq_dict": {"s1": ["S03"]}}
    info = _run("artspeech_tpu_torch", "test_phoneme_to_articulation", cfg, out, monkeypatch,
                tmp_path)
    with open(out / "test_results.json") as f:
        written = json.load(f)
    with open(ref_out / "test_results.json") as f:
        ref = _flat(json.load(f))
    assert written == info and set(_flat(written)) == set(ref) == set(_flat(ref_info))
    for key, value in _flat(written).items():
        np.testing.assert_allclose(value, ref[key], rtol=0, atol=1e-5, err_msg=key)
    _assert_same_tree(str(out / "test_outputs"), str(ref_out / "test_outputs"), atol=1e-5)
    assert os.path.isfile(out / "run" / "params.json")


def test_generate_cli_matches_jax(workdir, tmp_path, monkeypatch):
    trees = {}
    for package, ckpts in (("artspeech_tpu", "jax_ckpts"), ("artspeech_tpu_torch", "ckpts")):
        trees[package] = tmp_path / package / "synthesis"
        cfg = {**workdir["base"], "method": "encoder_decoder", "model_params": MODEL,
               "state_dict_filepath": str(workdir["root"] / ckpts / "best_model"),
               "seq_dict": {"s1": ["S03"]}, "save_to": str(trees[package]), "batch_size": 2}
        _run(package, "generate_vocal_tract_shape", cfg, tmp_path / package, monkeypatch,
             tmp_path)
    _assert_same_tree(str(trees["artspeech_tpu_torch"]), str(trees["artspeech_tpu"]),
                      atol=1e-5, txt_atol=136e-5)


def _normalized(root):
    """Relative paths, with each checkpoint counted once: ``best/state``,
    ``last/state``, their ``aux.json`` and ``best_model``."""
    out = set()
    for name in _files(root):
        parts = name.split(os.sep)
        if parts[0] == "checkpoints" and parts[1] == "best_model":
            name = "checkpoints/best_model"
        elif parts[0] == "checkpoints" and parts[2].startswith("state"):
            name = f"checkpoints/{parts[1]}/state"
        out.add(name.replace(os.sep, "/"))
    return out


def test_train_cli_writes_what_jax_writes(workdir, tmp_path, monkeypatch):
    cfg = {**workdir["base"], "num_epochs": 2, "batch_size": 4, "patience": 5,
           "learning_rate": 1e-3, "weight_decay": 1e-5, "model_kwargs": {**MODEL, "dropout": 0.0},
           "train_seq_dict": {"s1": ["S01"]}, "valid_seq_dict": {"s1": ["S02"]},
           "test_seq_dict": {"s1": ["S03"]}}
    outs, infos, records = {}, {}, {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        outs[package] = tmp_path / package
        infos[package] = _run(package, "train_phoneme_to_articulation", cfg, outs[package],
                              monkeypatch, tmp_path)
        with open(outs[package] / "run" / "metrics.jsonl") as f:
            records[package] = [json.loads(line) for line in f]
    port, ref = outs["artspeech_tpu_torch"], outs["artspeech_tpu"]
    assert _normalized(port) == _normalized(ref)
    for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json", "best_model"):
        assert os.path.isfile(port / "checkpoints" / sub), sub
    assert [r["epoch"] for r in records["artspeech_tpu_torch"]] == [0, 1]
    # Both train steps report ``manual_spmd``, 0.0 on one device.
    assert [set(r) for r in records["artspeech_tpu_torch"]] == \
        [set(r) for r in records["artspeech_tpu"]]
    assert all(r["train_manual_spmd"] == 0.0 for r in records["artspeech_tpu_torch"])
    with open(port / "test_results.json") as f:
        written = json.load(f)
    assert written == infos["artspeech_tpu_torch"]
    assert set(_flat(written)) == set(_flat(infos["artspeech_tpu"]))
    assert all(np.isfinite(v) for v in _flat(written).values())


def test_cli_refuses_what_is_not_ported(workdir, tmp_path, monkeypatch):
    # bf16 and fp16 compute are ported: both spellings of each, and the top
    # level never overrides a per-model dtype (JAX cli/common.py:51-52).
    assert model_kwargs_from_cfg({"compute_dtype": "bfloat16"}) == {"dtype": torch.bfloat16}
    assert model_kwargs_from_cfg({"model_params": {"dtype": "bf16"}}, "model_params") \
        == {"dtype": torch.bfloat16}
    assert model_kwargs_from_cfg({"compute_dtype": "bf16",
                                  "model_kwargs": {"dtype": "float32", "dropout": 0.1}}) \
        == {"dropout": 0.1}
    assert model_kwargs_from_cfg({"compute_dtype": "float32", "model_kwargs": {"dropout": 0.1}}) \
        == {"dropout": 0.1}
    assert model_kwargs_from_cfg({"compute_dtype": "float16"}) == {"dtype": torch.float16}
    assert model_kwargs_from_cfg({"compute_dtype": "fp16"}) == {"dtype": torch.float16}
    assert model_kwargs_from_cfg({"compute_dtype": "fp16", "model_kwargs": {"dtype": "bf16"}}) \
        == {"dtype": torch.bfloat16}
    with pytest.raises(ValueError, match="unknown compute dtype float64"):
        model_kwargs_from_cfg({"compute_dtype": "float64"})
    # The recognizer's CLIs are ported, scoring a synthesized corpus among
    # them (tests/test_torch_port_recognition_train.py,
    # tests/test_torch_port_synthetic.py).
    # method: mean_contour is ported (tests/test_torch_port_mean_contour.py):
    # it now fails only for want of its table.
    cfg = {**workdir["base"], "method": "mean_contour", "seq_dict": {"s1": ["S03"]},
           "state_dict_filepath": str(tmp_path / "missing.npz"),
           "save_to": str(tmp_path / "synthesis")}
    with pytest.raises(FileNotFoundError, match="missing.npz"):
        _run("artspeech_tpu_torch", "generate_vocal_tract_shape", cfg, tmp_path, monkeypatch,
             tmp_path)
    # save_plots is ported (synth/viz.py): one jpg a frame, named as JAX
    # names them; without matplotlib the port raises where JAX writes nothing.
    plots = {}
    for package, ckpts in (("artspeech_tpu", "jax_ckpts"), ("artspeech_tpu_torch", "ckpts")):
        save_to = tmp_path / package / "plotted"
        _run(package, "generate_vocal_tract_shape",
             {**cfg, "method": "encoder_decoder", "model_params": MODEL, "save_plots": True,
              "state_dict_filepath": str(workdir["root"] / ckpts / "best_model"),
              "save_to": str(save_to), "batch_size": 4}, tmp_path / package, monkeypatch,
             tmp_path)
        plots[package] = [name for name in _files(save_to) if name.endswith(".jpg")]
    assert plots["artspeech_tpu_torch"] == plots["artspeech_tpu"]
    frames = sum(len(open(os.path.join(d, "target_sequence.txt")).read().split())
                 for d, _, names in os.walk(tmp_path / "artspeech_tpu_torch" / "plotted")
                 if "target_sequence.txt" in names)
    assert len(plots["artspeech_tpu_torch"]) == frames > 0
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # ``import matplotlib`` raises
    with pytest.raises(RuntimeError, match="save_plots needs matplotlib"):
        _run("artspeech_tpu_torch", "generate_vocal_tract_shape",
             {**cfg, "method": "encoder_decoder", "model_params": MODEL, "save_plots": True,
              "state_dict_filepath": str(workdir["root"] / "ckpts" / "best_model")},
             tmp_path, monkeypatch, tmp_path)


def test_explicit_mlflow_tracker_raises_when_it_cannot_start(tmp_path, monkeypatch):
    from artspeech_tpu_torch.utils import tracking

    monkeypatch.setitem(sys.modules, "mlflow", None)  # ``import mlflow`` raises
    with pytest.raises(ImportError):
        tracking.make_tracker(str(tmp_path / "run"), mlflow_uri="http://localhost:5000")
    assert isinstance(tracking.make_tracker(str(tmp_path / "run")), tracking.LocalTracker)
