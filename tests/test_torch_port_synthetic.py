"""Scoring a synthesized corpus and training through a frozen recognizer:
the port against the JAX package, on the CPU.

A small synthesized corpus is written by the port's ``synthesize_corpus``
(a narrow seeded ``ArtSpeech`` over the ten recognition articulators, two
subjects, sentences of 5-21 frames, and one sentence written without air
columns). Weights are carried across by ``utils/convert.py`` from one flax
init of each model:
- ``SyntheticPhonemeRecognitionDataset`` in both packages:
  ``sequences_from_corpus`` equal, every item equal exactly for
  ``vocal_tract`` and ``air_column``, with and without voiced tokens; the
  files read raw (no 1/RES scaling, no re-centring); ``melspec`` dropped;
  the sentence without air columns skipped;
- the test CLI with ``synthetic: true`` in both packages, without and with
  voicing: loss within 1e-5 relative, the same edit distance, WIL and
  artifacts;
- ``recognition_feature_loss``: value and gradient within 1e-5;
- the ArtSpeech train step with a frozen recognizer (dropout 0, voicing
  with -1 on padded frames) against JAX's jitted step: loss within 1e-5
  relative, gradients within 1e-4 * max(|ref|, 1), the recognizer's
  parameters untouched and outside the optimizer.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from artspeech_tpu.data import recognition as jax_recognition
from artspeech_tpu.eval import recognition as jax_eval_recognition
from artspeech_tpu.losses import articulation as jax_losses
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.models.deepspeech2 import DeepSpeech2 as JaxDeepSpeech2
from artspeech_tpu.train import step as jax_step
from artspeech_tpu.train.checkpoint import save_params as jax_save_params
from artspeech_tpu.train.state import TrainState as JaxTrainState
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data import recognition
from artspeech_tpu_torch.eval import recognition as eval_recognition
from artspeech_tpu_torch.losses.articulation import recognition_feature_loss
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2, frozen_recognizer_fn
from artspeech_tpu_torch.ops import hopper_gru
from artspeech_tpu_torch.synth.pipeline import synthesize_corpus
from artspeech_tpu_torch.train import checkpoint, state
from artspeech_tpu_torch.train.step import make_artspeech_train_step
from artspeech_tpu_torch.utils.convert import (
    artspeech_state_dict_from_flax,
    deepspeech2_state_dict_from_flax,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOICING = os.path.join(REPO, "configs", "phoneme_recognition", "voicing.json")
PHONEMES = ["a", "i", "m", "l", "z", "p", "t", "k", "s", "f"]  # the first five voiced
N_ART = len(RECOGNITION_ARTICULATORS)
SENTENCES = {("s1", "S01"): 9, ("s1", "S02"): 21, ("s2", "S01"): 5, ("s2", "S03"): 14}
NO_AIR = ("s2", "S09")
DS2 = dict(num_residual_layers=1, num_rnn_layers=1, rnn_hidden_size=16, conv_channels=8,
           num_features=N_ART * 50, adapter_out_features=8, dropout=0.0)
TOL = 1e-5
GRAD_TOL = 1e-4


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel_err(got, ref):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max(initial=0.0) / max(np.abs(ref).max(initial=0.0), 1.0)


class _Sentences:
    """In-memory dataset with the ``SynthesisDataset`` interface."""

    def __init__(self, sentences, vocabulary, seed):
        rng = np.random.default_rng(seed)
        self.articulators = sorted(RECOGNITION_ARTICULATORS)
        self.data = []
        for (subject, name), n in sentences.items():
            phonemes = [PHONEMES[i] for i in rng.integers(0, len(PHONEMES), n)]
            self.data.append({"sentence_name": name, "subject": subject, "phonemes": phonemes,
                              "tokens": np.array([vocabulary[p] for p in phonemes], np.int32)})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        item = self.data[index]
        return {**item, "length": len(item["tokens"])}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """(synthesized corpus root, vocabulary path)."""
    root = tmp_path_factory.mktemp("synthetic_corpus")
    vocab_path = str(root / "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(PHONEMES, f)
    vocabulary = load_vocabulary(vocab_path)
    model = ArtSpeech(len(vocabulary), N_ART, embed_dim=8, hidden_size=8,
                      generator=torch.Generator().manual_seed(5), device="cpu")
    save_to = str(root / "synthesis")
    config = DATASET_CONFIG["artspeech2"]
    synthesize_corpus(model, _Sentences(SENTENCES, vocabulary, seed=6), save_to, config,
                      batch_size=2, buckets=(16, 32), device="cpu")
    synthesize_corpus(model, _Sentences({NO_AIR: 4}, vocabulary, seed=7), save_to, config,
                      batch_size=2, buckets=(16,), save_air_column=False, device="cpu")
    return save_to, vocab_path


def _voiced(voicing):
    if not voicing:
        return None
    with open(VOICING) as f:
        return json.load(f)


def _synthetic_dataset(pkg, save_to, vocab_path, features, voicing):
    cls = pkg.SyntheticPhonemeRecognitionDataset
    return cls(save_to, cls.sequences_from_corpus(save_to), load_vocabulary(vocab_path),
               features, database_name="artspeech2", voiced_tokens=_voiced(voicing))


@pytest.mark.parametrize("voicing", [False, True], ids=["no_voicing", "voicing"])
@pytest.mark.parametrize("feature", ["vocal_tract", "air_column"])
def test_synthetic_dataset_matches_jax(corpus, feature, voicing):
    save_to, vocab_path = corpus
    pairs = recognition.SyntheticPhonemeRecognitionDataset.sequences_from_corpus(save_to)
    assert pairs == jax_recognition.SyntheticPhonemeRecognitionDataset.sequences_from_corpus(
        save_to) == sorted([*SENTENCES, NO_AIR])
    ours = _synthetic_dataset(recognition, save_to, vocab_path, ["melspec", feature], voicing)
    ref = _synthetic_dataset(jax_recognition, save_to, vocab_path, ["melspec", feature], voicing)
    assert ours.features == ref.features == [feature]
    assert ours.data == ref.data
    assert [d["sentence_name"] for d in ours.data] == [f"{s}-{n}" for s, n in sorted(SENTENCES)]
    for i in range(len(ref)):
        item, ref_item = ours[i], ref[i]
        assert set(item) == set(ref_item)
        for key, value in ref_item.items():
            if isinstance(value, np.ndarray):
                assert item[key].dtype == value.dtype and np.array_equal(item[key], value), key
            else:
                assert item[key] == value, key
        assert item["voicing"].any() == voicing
    # Raw values: frame 0 of the first sentence as written, no scaling.
    subject, name = sorted(SENTENCES)[0]
    base = os.path.join(save_to, subject, name)
    frame = sorted(os.listdir(os.path.join(base, "air_column")))[0].split(".")[0]
    if feature == "vocal_tract":
        art = RECOGNITION_ARTICULATORS[0]
        written = np.load(os.path.join(base, "inference_contours", f"{frame}_{art}.npy"))
        np.testing.assert_array_equal(ours[0]["vocal_tract"][:, :50, 0], written)
        assert ours[0]["vocal_tract"].shape == (2, N_ART * 50, SENTENCES[(subject, name)])
    else:
        written = np.load(os.path.join(base, "air_column", f"{frame}.npy"))
        np.testing.assert_array_equal(ours[0]["air_column"][:, :, 0],
                                      written.transpose(1, 0, 2).reshape(2, -1))


# ---------- the test CLI ----------


@pytest.fixture
def no_tsne(monkeypatch):
    """Both packages' t-SNE plot replaced by a recorder of its calls."""
    calls = []
    for module in (eval_recognition, jax_eval_recognition):
        monkeypatch.setattr(module, "_maybe_tsne_plot",
                            lambda features, labels, *a, **k: calls.append(len(features)))
    return calls


@pytest.fixture(scope="module")
def recognizer(corpus, tmp_path_factory):
    """One flax DeepSpeech2 init, saved for both packages: (model_params,
    the flax model and params, the JAX weights' path, the port's)."""
    _, vocab_path = corpus
    n_classes = len(load_vocabulary(vocab_path))
    model = JaxDeepSpeech2(num_classes=n_classes, **DS2)
    params = _tree(jax.jit(model.init)(jax.random.PRNGKey(8),
                                       jnp.zeros((1, 2, N_ART * 50, 8)))["params"])
    weights = tmp_path_factory.mktemp("recognizer_weights")
    jax_save_params(str(weights / "jax_model"), params)
    port = DeepSpeech2(num_classes=n_classes, **DS2, device="cpu")
    port.load_state_dict(deepspeech2_state_dict_from_flax(params))
    checkpoint.save_params(str(weights / "port_model"), port)
    return model, params, str(weights / "jax_model"), str(weights / "port_model")


def _run(package, cfg, output_dir, monkeypatch, tmp_path):
    cfg_path = tmp_path / f"{package}_{len(os.listdir(tmp_path))}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    module = importlib.import_module(f"{package}.cli.test_phoneme_recognition")
    common = importlib.import_module(f"{package}.cli.common")
    argv = ["test_phoneme_recognition", "--config", str(cfg_path), "--output_dir",
            str(output_dir), "--run_name", "run"]
    if package == "artspeech_tpu_torch":
        argv += ["--device", "cpu"]
    monkeypatch.setattr(sys, "argv", argv)
    return common.run_experiment("test_phoneme_recognition", module.main)


@pytest.mark.parametrize("config", ["test_synthetic_encoder_decoder_vocal_tract",
                                    "test_synthetic_encoder_decoder_vocal_tract_voicing"])
def test_synthetic_test_cli_matches_jax(corpus, recognizer, config, tmp_path, monkeypatch,
                                        no_tsne):
    save_to, vocab_path = corpus
    _, _, jax_weights, port_weights = recognizer
    with open(os.path.join(REPO, "configs", "phoneme_recognition", f"{config}.yaml")) as f:
        cfg = yaml.safe_load(f)
    assert cfg["synthetic"] is True
    cfg.update(datadir=save_to, vocab_filepath=vocab_path, model_params=DS2)
    if "voicing_filepath" in cfg:
        cfg["voicing_filepath"] = VOICING
    launches = hopper_gru.launches
    infos = {}
    for package, weights in (("artspeech_tpu", jax_weights), ("artspeech_tpu_torch", port_weights)):
        infos[package] = _run(package, {**cfg, "state_dict_filepath": weights},
                              tmp_path / package, monkeypatch, tmp_path)
    assert hopper_gru.launches == launches  # the CPU: no kernel
    got, ref = infos["artspeech_tpu_torch"], infos["artspeech_tpu"]
    assert set(got) == set(ref) == {"loss", "edit_distance", "word_info_lost"}
    assert abs(got["loss"] - ref["loss"]) <= TOL * max(abs(ref["loss"]), 1.0)
    assert got["edit_distance"] == ref["edit_distance"]
    assert got["word_info_lost"] == ref["word_info_lost"]
    port, jax_dir = (tmp_path / p / "test_outputs" for p in ("artspeech_tpu_torch", "artspeech_tpu"))
    assert sorted(os.listdir(port)) == sorted(os.listdir(jax_dir))
    for name in ("substitution_matrix.npy", "grouped_confusion_matrix.npy"):
        assert np.array_equal(np.load(port / name), np.load(jax_dir / name)), name
    predictions = json.loads((port / "predictions.json").read_text())
    assert predictions == json.loads((jax_dir / "predictions.json").read_text())
    assert len(predictions) == len(SENTENCES)
    feats, ref_feats = np.load(port / "features.npz"), np.load(jax_dir / "features.npz")
    assert np.array_equal(feats["labels"], ref_feats["labels"])
    assert _rel_err(feats["features"], ref_feats["features"]) <= TOL
    assert len(no_tsne) == 2


# ---------- the recognizer-feature loss and the ArtSpeech step ----------


def test_recognition_feature_loss_matches_jax():
    rng = np.random.default_rng(9)
    out, tgt = (rng.normal(size=(3, 7, 5)).astype(np.float32) for _ in range(2))
    lengths = np.array([7, 0, 4], np.int32)
    ref, ref_grad = jax.value_and_grad(jax_losses.recognition_feature_loss)(
        jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(lengths))
    x = torch.from_numpy(out).requires_grad_()
    loss = recognition_feature_loss(x, torch.from_numpy(tgt), torch.from_numpy(lengths))
    loss.backward()
    assert abs(loss.item() - float(ref)) <= TOL * abs(float(ref))
    assert _rel_err(x.grad, ref_grad) <= TOL
    assert not x.grad[1].any() and not x.grad[2, 4:].any()  # padded frames take none


VOCAB, EMBED, HIDDEN, LR, WD = 12, 8, 16, 1e-3, 1e-5
TO_MM = 136 * 1.6176470518112


def _step_batch(seed, b=3, t=16):
    """A collated ArtSpeech batch: zeros past each row's length in the
    targets, voicing 0/1 and -1 past it, as the loader pads them."""
    rng = np.random.default_rng(seed)
    lengths = np.array([t, 11, 6], np.int32)[:b]
    pad = np.arange(t)[None, :] >= lengths[:, None]
    targets = rng.random((b, t, N_ART, 2, 50)).astype(np.float32)
    targets[pad] = 0.0
    voicing = np.where(pad, np.float32(-1.0), rng.integers(0, 2, (b, t)).astype(np.float32))
    return {"tokens": rng.integers(0, VOCAB, (b, t)).astype(np.int32), "targets": targets,
            "lengths": lengths, "voicing": voicing}


def test_artspeech_step_with_a_frozen_recognizer_matches_jax(recognizer):
    ds2, ds2_params, _, _ = recognizer
    batch = _step_batch(10)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                         hidden_size=HIDDEN)
    params = _tree(jax.jit(model.init)(jax.random.PRNGKey(1), jb["tokens"], jb["lengths"])["params"])

    def jax_recognizer(shapes, voicing):
        return ds2.apply({"params": ds2_params}, shapes, voicing=voicing,
                         return_features=True)[1]

    # JAX's jitted step under SGD at lr 1: its gradients are the parameters'
    # moves (|params| < 1 here, so the subtraction costs ~1e-7).
    jax_state = JaxTrainState.create(apply_fn=model.apply, params=params, tx=optax.sgd(1.0))
    moved, ref_metrics = jax_step.make_artspeech_train_step(
        TO_MM, donate=False, recognizer_fn=jax_recognizer, recognition_weight=0.5)(
        jax_state, jb, jax.random.PRNGKey(0))
    ref_loss = float(ref_metrics["loss"])
    ref_grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b),
                                       params, _tree(moved.params))

    port = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    port.load_state_dict(artspeech_state_dict_from_flax(params))
    st = state.create_train_state(port, LR, WD)
    frozen = DeepSpeech2(num_classes=ds2.num_classes, **DS2, device="cpu")
    frozen.load_state_dict(deepspeech2_state_dict_from_flax(ds2_params))
    frozen.train()  # frozen_recognizer_fn puts it in eval mode
    before = {n: p.detach().clone() for n, p in frozen.named_parameters()}
    step = make_artspeech_train_step(TO_MM, device="cpu", recognizer_fn=frozen_recognizer_fn(frozen),
                                     recognition_weight=0.5)
    metrics = step(st, batch)
    assert abs(metrics["loss"].item() - ref_loss) <= TOL * abs(ref_loss)
    ref_grads = artspeech_state_dict_from_flax(ref_grads)
    errs = {n: _rel_err(p.grad, ref_grads[n]) for n, p in st.model.named_parameters()}
    assert max(errs.values()) <= GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    # The term moves the gradients: without it they differ.
    plain = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    plain.load_state_dict(artspeech_state_dict_from_flax(params))
    plain_st = state.create_train_state(plain, LR, WD)
    make_artspeech_train_step(TO_MM, device="cpu")(plain_st, batch)
    assert max(_rel_err(p.grad, ref_grads[n]) for n, p in plain.named_parameters()) > 10 * GRAD_TOL
    # The recognizer: frozen, untouched, outside the optimizer.
    assert not frozen.training
    for n, p in frozen.named_parameters():
        assert not p.requires_grad and p.grad is None and torch.equal(p, before[n]), n
    optimized = {id(p) for group in st.optimizer.param_groups for p in group["params"]}
    assert optimized == {id(p) for p in st.model.parameters()}
    assert st.step == 1
