"""The port's autoencoder-based CLIs on the CPU, against the JAX package's.

Each CLI runs in-process through its ``run_experiment`` with ``sys.argv``
set (``--device cpu`` for the port), from a YAML config written with
``yaml.safe_dump`` and read by the port's own reader, over a tiny
``make_synthetic_corpus`` (3 sentences of 10 frames per sequence, as
tests/test_method_comparison.py drives the JAX chain):
- ``calculate_normalization_statistics`` and ``train_articulatory_pca``: the
  same statistics (1e-6) and PCA parameters (1e-5; eigenvectors up to a sign,
  the SVD's choice) as the JAX CLIs write;
- ``test_phoneme_to_principal_components`` with the same weights on both
  sides (a JAX LSTM latent RNN and AE decoder, saved with the JAX
  ``save_params``; converted and saved with the port's): the same
  ``test_results.json`` and test-output tree within 1e-5;
- the whole chain on the port: train and test the autoencoder, train the
  latent RNN (AE with GRU, AE with LSTM, PCA-based), test it and synthesize
  from it with ``generate_vocal_tract_shape`` (``method: autoencoder``): the
  files each writes, finite values, and the launch counters untouched;
- the latent RNN's train CLI with a ``recognizer:`` block and ``beta4`` for
  one epoch: finite results, checkpoints, the term in the loss, and the
  recognizer's parameters neither counted nor trained.
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
from artspeech_tpu.models import autoencoder as jax_ae
from artspeech_tpu.models.latent_rnn import PrincipalComponentsArtSpeech as JaxLatentRNN
from artspeech_tpu.train.checkpoint import load_params as jax_load_params
from artspeech_tpu.train.checkpoint import save_params as jax_save_params
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.pc_datasets import compute_normalization_statistics
from artspeech_tpu_torch.models.autoencoder import MultiDecoder, MultiEncoder
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
from artspeech_tpu_torch.models.latent_rnn import PrincipalComponentsArtSpeech
from artspeech_tpu_torch.ops import hopper_gru, hopper_lstm, hopper_min_dist, hopper_p2cp
from artspeech_tpu_torch.train import checkpoint
from artspeech_tpu_torch.utils.convert import (
    autoencoder_state_dict_from_flax,
    latent_rnn_state_dict_from_flax,
)

ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)
INDICES = {a: 2 for a in ARTS}
AE = {"in_features": 100, "hidden_features": 8}
MODEL = {"embed_dim": 8, "hidden_size": 16}
SEQS = {"train_seq_dict": {"s1": ["S01"]}, "valid_seq_dict": {"s1": ["S02"]},
        "test_seq_dict": {"s1": ["S03"]}}
TV_MAP = {"LA": ["p", "b", "m"], "TTCD": ["l", "d", "n", "t"], "TBCD": ["k", "g"]}


def _run(package, module_name, cfg, output_dir, tmp_path, monkeypatch):
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


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pc_corpus"))
    info = make_synthetic_corpus(root, subjects=("s1",), sequences=("S01", "S02", "S03"),
                                 n_sentences=3, frames_per_sentence=10)
    vocab_path = os.path.join(root, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    # The corpus's normalization_statistics/, which every CLI of the family
    # but the statistics' own reads.
    compute_normalization_statistics(root, "gottingen", [("s1", "S01")], ARTS, clip_tails=False,
                                     save_to=os.path.join(root, "normalization_statistics"))
    return {"database_name": "gottingen", "datadir": root, "vocab_filepath": vocab_path,
            "clip_tails": False}


def test_normalization_statistics_and_pca_match_jax(corpus, tmp_path, monkeypatch):
    stats = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        save_to = str(tmp_path / f"stats_{package}")
        cfg = {**corpus, "seq_dict": {"s1": ["S01", "S02"]}, "articulators": ARTS,
               "save_to": save_to}
        _run(package, "calculate_normalization_statistics", cfg, tmp_path / package, tmp_path,
             monkeypatch)
        stats[package] = save_to
    names = sorted(os.listdir(stats["artspeech_tpu"]))
    assert sorted(os.listdir(stats["artspeech_tpu_torch"])) == names
    assert len(names) == 2 * len(ARTS)
    for name in names:
        np.testing.assert_allclose(np.load(os.path.join(stats["artspeech_tpu_torch"], name)),
                                   np.load(os.path.join(stats["artspeech_tpu"], name)),
                                   rtol=0, atol=1e-6, err_msg=name)

    reports = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        cfg = {**corpus, "indices_dict": INDICES, "train_seq_dict": {"s1": ["S01", "S02"]}}
        reports[package] = _run(package, "train_articulatory_pca", cfg, tmp_path / package,
                                tmp_path, monkeypatch)
    assert reports["artspeech_tpu_torch"].keys() == reports["artspeech_tpu"].keys()
    for art, ref in reports["artspeech_tpu"].items():
        got = reports["artspeech_tpu_torch"][art]
        assert got["num_components"] == ref["num_components"]
        np.testing.assert_allclose(got["explained_variance_ratio"],
                                   ref["explained_variance_ratio"], rtol=1e-5, atol=1e-7)
    for part, cls in (("encoder", jax_ae.MultiEncoder), ("decoder", jax_ae.MultiDecoder)):
        module = cls(indices_dict=INDICES, in_features=100, **{f"{part}_cls": "PCA"})
        sample = jnp.zeros((1, len(ARTS), 100)) if part == "encoder" else jnp.zeros((1, 20))
        template = module.init(jax.random.PRNGKey(0), sample)["params"]
        ref = autoencoder_state_dict_from_flax(jax.tree_util.tree_map(
            np.asarray, jax_load_params(str(tmp_path / "artspeech_tpu" / "pca" / part),
                                        template)))
        got = checkpoint.load_params(str(tmp_path / "artspeech_tpu_torch" / "pca" / part))
        assert got.keys() == ref.keys()
        for name, value in ref.items():
            value = value.numpy()
            if name.endswith("eigenvectors"):
                value = value * np.sign(np.sum(got[name].numpy() * value, axis=1))[:, None]
            np.testing.assert_allclose(got[name].numpy(), value, rtol=1e-5, atol=1e-5,
                                       err_msg=name)


def test_latent_rnn_test_cli_matches_jax(corpus, tmp_path, monkeypatch):
    """One set of weights (a JAX LSTM latent RNN and AE decoder) through both
    packages' test CLIs."""
    vocab_size = len(load_vocabulary(corpus["vocab_filepath"]))
    rnn = JaxLatentRNN(vocab_size=vocab_size, indices_dict=INDICES, rnn="LSTM", **MODEL)
    rnn_params = rnn.init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32),
                          jnp.full((1,), 8, jnp.int32))["params"]
    dec = jax_ae.MultiDecoder(indices_dict=INDICES, **AE)
    dec_params = dec.init(jax.random.PRNGKey(4), jnp.zeros((1, 2 * len(ARTS))))["params"]
    weights = tmp_path / "weights"
    jax_save_params(str(weights / "jax_rnn"), rnn_params)
    jax_save_params(str(weights / "jax_decoder"), dec_params)
    port_rnn = PrincipalComponentsArtSpeech(vocab_size, INDICES, rnn="LSTM", **MODEL,
                                            device="cpu")
    port_rnn.load_state_dict(latent_rnn_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, rnn_params)))
    port_dec = MultiDecoder(INDICES, **AE, device="cpu")
    port_dec.load_state_dict(autoencoder_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, dec_params)))
    checkpoint.save_params(str(weights / "port_rnn"), port_rnn)
    checkpoint.save_params(str(weights / "port_decoder"), port_dec)

    infos = {}
    for package, prefix in (("artspeech_tpu", "jax"), ("artspeech_tpu_torch", "port")):
        cfg = {**corpus, **AE, "indices_dict": INDICES, "TV_to_phoneme_map": TV_MAP,
               "test_seq_dict": SEQS["test_seq_dict"], "batch_size": 2,
               "model_kwargs": {**MODEL, "rnn": "LSTM"},
               "state_dict_filepath": str(weights / f"{prefix}_rnn"),
               "decoder_state_dict_filepath": str(weights / f"{prefix}_decoder")}
        infos[package] = _run(package, "test_phoneme_to_principal_components", cfg,
                              tmp_path / package, tmp_path, monkeypatch)
    got, ref = _flat(infos["artspeech_tpu_torch"]), _flat(infos["artspeech_tpu"])
    assert got.keys() == ref.keys()
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-5, atol=1e-5, err_msg=key)
    got_dir = tmp_path / "artspeech_tpu_torch" / "test_outputs" / "0"
    ref_dir = tmp_path / "artspeech_tpu" / "test_outputs" / "0"
    names = _files(ref_dir)
    assert _files(got_dir) == names and any(n.endswith("tract_variables.csv") for n in names)
    for name in names:
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(got_dir / name), np.load(ref_dir / name),
                                       rtol=0, atol=1e-5, err_msg=name)


def test_cli_chain_on_cpu(corpus, tmp_path, monkeypatch):
    """The autoencoder (train, test) and PCA over the corpus's statistics ->
    the latent RNN (GRU, LSTM, PCA-based) -> its test CLI -> synthesis."""
    before = (hopper_gru.launches, hopper_gru.bwd_launches, hopper_lstm.launches,
              hopper_lstm.bwd_launches, hopper_p2cp.launches, hopper_min_dist.launches)
    base = {**corpus, **SEQS, "indices_dict": INDICES, **AE}

    ae_dir = tmp_path / "ae"
    info = _run("artspeech_tpu_torch", "train_principal_components_autoencoder",
                {**base, "batch_size": 16, "num_epochs": 2, "patience": 5,
                 "learning_rate": 1e-3, "weight_decay": 1e-5, "alpha": 0.1},
                ae_dir, tmp_path, monkeypatch)
    assert np.isfinite(info["p2cp_mm"]) and set(info) == {"loss", "p2cp_mm", *ARTS}
    for name in ("checkpoints/best/state.pt", "checkpoints/last/aux.json",
                 "checkpoints/best_encoder", "checkpoints/best_decoder",
                 "test_outputs/latents.npy", "test_outputs/latent_covariance.npy",
                 "test_outputs/nomograms.npz", "test_outputs/test_results.json"):
        assert (ae_dir / name).is_file(), name
    with open(ae_dir / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert len(records) == 2 and all(np.isfinite(v) for r in records for k, v in r.items()
                                     if k != "ts")
    test_info = _run("artspeech_tpu_torch", "test_principal_components_autoencoder",
                     {**base, "checkpoint_dir": str(ae_dir / "checkpoints" / "best"),
                      "batch_size": 16}, tmp_path / "ae_test", tmp_path, monkeypatch)
    for key, value in _flat(info).items():  # the same weights, the same test set
        np.testing.assert_allclose(_flat(test_info)[key], value, rtol=1e-6, err_msg=key)
    assert (tmp_path / "ae_test" / "test_outputs" / "latent_histograms.npz").is_file()

    pca_dir = tmp_path / "pca"
    _run("artspeech_tpu_torch", "train_articulatory_pca", base, pca_dir, tmp_path, monkeypatch)
    rnn_cfg = {**base, "batch_size": 2, "num_epochs": 2, "patience": 5, "learning_rate": 1e-3,
               "weight_decay": 1e-5, "beta1": 0.5, "beta2": 3.0, "beta3": 1.0,
               "TV_to_phoneme_map": TV_MAP,
               "encoder_state_dict_filepath": str(ae_dir / "checkpoints" / "best_encoder"),
               "decoder_state_dict_filepath": str(ae_dir / "checkpoints" / "best_decoder")}
    variants = {
        "ae_gru": {"model_kwargs": {**MODEL, "rnn": "GRU"}},
        "ae_lstm": {"model_kwargs": {**MODEL, "rnn": "LSTM", "rnn_dropout": 0.1}},
        "pca_gru": {"model_kwargs": {**MODEL, "rnn": "GRU"}, "encoder_cls": "PCA",
                    "decoder_cls": "PCA", "rescale_factor": 12.0,
                    "encoder_state_dict_filepath": str(pca_dir / "pca" / "encoder"),
                    "decoder_state_dict_filepath": str(pca_dir / "pca" / "decoder")},
    }
    results = {}
    for name, changes in variants.items():
        results[name] = _run("artspeech_tpu_torch", "train_phoneme_to_principal_components",
                             {**rnn_cfg, **changes}, tmp_path / name, tmp_path, monkeypatch)
        assert np.isfinite(results[name]["p2cp_mm"])
        assert set(results[name]) == {"p2cp_mm", *ARTS}
        assert (tmp_path / name / "checkpoints" / "best_model").is_file()
        outputs = tmp_path / name / "test_outputs" / "0"
        assert any(n.endswith("tract_variables.csv") for n in _files(outputs))
        assert all(np.isfinite(np.load(outputs / n)).all() for n in _files(outputs)
                   if n.endswith(".npy"))

    lstm = tmp_path / "ae_lstm"
    lstm_cfg = {**rnn_cfg, **variants["ae_lstm"],
                "state_dict_filepath": str(lstm / "checkpoints" / "best" / "state")}
    tested = _run("artspeech_tpu_torch", "test_phoneme_to_principal_components", lstm_cfg,
                  tmp_path / "lstm_test", tmp_path, monkeypatch)
    for key, value in _flat(results["ae_lstm"]).items():
        np.testing.assert_allclose(_flat(tested)[key], value, rtol=1e-6, err_msg=key)

    save_to = tmp_path / "synthesis"
    written = _run("artspeech_tpu_torch", "generate_vocal_tract_shape",
                   {**corpus, "method": "autoencoder", "articulators": ARTS,
                    "seq_dict": {"s1": ["S03"]}, "indices_dict": INDICES,
                    "state_dict_filepath": str(lstm / "checkpoints" / "best_model"),
                    "decoder_state_dict_filepath": str(ae_dir / "checkpoints" / "best_decoder"),
                    "norm_stats_dir": corpus["datadir"], "model_params": {**MODEL, "rnn": "LSTM"},
                    "aux_model_params": AE, "save_to": str(save_to)},
                   tmp_path / "generate", tmp_path, monkeypatch)
    assert len(written) == 3
    for sentence in written:
        with open(os.path.join(sentence, "target_sequence.txt")) as f:
            frames = len(f.read().split())
        contours = os.path.join(sentence, "inference_contours")
        assert frames > 0 and len(os.listdir(contours)) == frames * (len(ARTS) + 1)
        assert all(np.isfinite(np.load(os.path.join(contours, n))).all()
                   for n in os.listdir(contours))
    assert (hopper_gru.launches, hopper_gru.bwd_launches, hopper_lstm.launches,
            hopper_lstm.bwd_launches, hopper_p2cp.launches, hopper_min_dist.launches) == before


def test_latent_rnn_train_cli_with_a_recognizer(corpus, tmp_path, monkeypatch):
    """One epoch of train_phoneme_to_principal_components with a frozen
    DeepSpeech2 (``recognizer:``, ``beta4: 0.5``) over seeded AE halves,
    against the same run without the block."""
    weights = tmp_path / "weights"
    n_classes = len(load_vocabulary(corpus["vocab_filepath"]))
    rec_params = {"num_residual_layers": 1, "num_rnn_layers": 1, "rnn_hidden_size": 8,
                  "conv_channels": 4, "num_features": 50 * len(ARTS),
                  "adapter_out_features": 8, "dropout": 0.1}
    for name, module in (("encoder", MultiEncoder(INDICES, **AE, device="cpu")),
                         ("decoder", MultiDecoder(INDICES, **AE, device="cpu")),
                         ("recognizer", DeepSpeech2(num_classes=n_classes, **rec_params,
                                                    device="cpu"))):
        checkpoint.save_params(str(weights / name), module)
    cfg = {**corpus, **SEQS, **AE, "indices_dict": INDICES, "batch_size": 2, "num_epochs": 1,
           "patience": 5, "learning_rate": 1e-3, "weight_decay": 1e-5, "beta1": 0.5,
           "beta2": 3.0, "beta3": 1.0, "beta4": 0.5, "TV_to_phoneme_map": TV_MAP,
           "model_kwargs": {**MODEL, "rnn": "GRU"},
           "encoder_state_dict_filepath": str(weights / "encoder"),
           "decoder_state_dict_filepath": str(weights / "decoder")}
    before = (hopper_gru.launches, hopper_gru.bwd_launches)
    runs = {}
    for name, extra in (("with", {"recognizer": {"state_dict_filepath": str(weights / "recognizer"),
                                                 "model_params": rec_params}}),
                        ("without", {})):
        out = tmp_path / name
        info = _run("artspeech_tpu_torch", "train_phoneme_to_principal_components",
                    {**cfg, **extra}, out, tmp_path, monkeypatch)
        assert set(info) == {"p2cp_mm", *ARTS} and np.isfinite(info["p2cp_mm"])
        for sub in ("checkpoints/best/state.pt", "checkpoints/last/state.pt",
                    "checkpoints/best_model", "test_results.json"):
            assert (out / sub).is_file(), sub
        with open(out / "run" / "metrics.jsonl") as f:
            (record,) = [json.loads(line) for line in f]
        with open(out / "run" / "params.json") as f:
            params = json.load(f)
        runs[name] = (record, params["num_network_params"],
                      torch.load(out / "checkpoints" / "last" / "state.pt", weights_only=True))
    assert all(np.isfinite(v) for k, v in runs["with"][0].items() if k != "ts")
    # Same seed, same data: the term adds to the loss, and only the latent
    # RNN is counted, trained and saved.
    assert runs["with"][0]["train_loss"] > runs["without"][0]["train_loss"]
    assert runs["with"][1] == runs["without"][1]
    assert runs["with"][2]["model"].keys() == runs["without"][2]["model"].keys()
    assert (hopper_gru.launches, hopper_gru.bwd_launches) == before
