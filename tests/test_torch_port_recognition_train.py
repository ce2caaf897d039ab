"""The port's recognizer data, train and eval steps, test harness and CLIs
against the JAX package's, on the CPU.

Over a tiny gottingen corpus from ``make_synthetic_corpus`` (3 sequences of 3
sentences of 10 frames, with seeded ``air_column`` arrays beside the
contours) and seeded narrow inputs (1 residual layer of 8 channels, 1-2 GRU
layers of H = 16, D = 20, T = 24, B = 3 with a ragged row and a row of
length 0), weights carried across by ``utils/convert.py``:
- the dataset's items and the loader's batches for all three features, with
  ``configs/phoneme_recognition/voicing.json``, equal to JAX's; the
  voiced-token option of the articulation datasets;
- one train step at dropout 0 and margins 0, CTC and weighted CE: losses
  within 1e-5, gradients within 1e-4 * max(|ref|, 1) (the conv stem's bias
  aside, tests/test_torch_port_recognition.py), updated parameters within
  1e-4 * max(|ref|, 1) where JAX's gradient is at least 100 * Adam's eps;
- ``accum_steps`` 2 against 1 within 1e-6;
- ``run_recognition_test``: the same info and artifacts as JAX's, greedy
  and beam (the t-SNE plot, sklearn's, left out of both packages' runs
  here but for one small case: it costs seconds a call, and minutes under
  the parallel test run);
- the train CLI on every ``train_*.yaml`` (its feature and flags, narrow
  ``model_params``, one epoch) at ``--device cpu``, then the test CLI on its
  checkpoint; the test CLI with ``synthetic: true`` over a corpus from the
  port's synthesis, for every ``test_synthetic_*`` config.
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

from artspeech_tpu.data import datasets as jax_datasets
from artspeech_tpu.data import pc_datasets as jax_pc_datasets
from artspeech_tpu.data import recognition as jax_recognition
from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.eval import recognition as jax_eval_recognition
from artspeech_tpu.eval.recognition import run_recognition_test as jax_run_recognition_test
from artspeech_tpu.models.deepspeech2 import DeepSpeech2 as JaxDeepSpeech2
from artspeech_tpu.train import recognition_step as jax_step
from artspeech_tpu.train.state import TrainState as JaxTrainState
from artspeech_tpu_torch.cli import config_file
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS, TUBE_ARTICULATORS
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data import datasets, pc_datasets, recognition
from artspeech_tpu_torch.eval import recognition as eval_recognition
from artspeech_tpu_torch.eval.recognition import run_recognition_test
from artspeech_tpu_torch.losses.recognition import load_class_weights
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2
from artspeech_tpu_torch.ops import hopper_gru
from artspeech_tpu_torch.synth.pipeline import SynthesisDataset, synthesize_corpus
from artspeech_tpu_torch.train import checkpoint
from artspeech_tpu_torch.train import recognition_step as step
from artspeech_tpu_torch.train.state import TrainState, create_train_state
from artspeech_tpu_torch.utils.convert import deepspeech2_state_dict_from_flax
from artspeech_tpu_torch.utils.io import sequences_from_dict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs", "phoneme_recognition")
VOICING = os.path.join(CONFIGS, "voicing.json")
SEQUENCES = ("S01", "S02", "S03")
B, T, D, C, H, K = 3, 24, 20, 8, 16, 9
LENGTHS = np.array([T, 13, 0], np.int32)
MODEL = dict(num_residual_layers=1, num_rnn_layers=2, rnn_hidden_size=H, num_classes=K,
             num_features=D, conv_channels=C, dropout=0.0)
LR, WD = 1e-2, 5e-5
TOL = 1e-5
GRAD_TOL = 1e-4
ADAM_EPS = 1e-8


@pytest.fixture
def no_tsne(monkeypatch):
    """Both packages' t-SNE plot replaced by a recorder of its calls."""
    calls = []
    for module in (eval_recognition, jax_eval_recognition):
        monkeypatch.setattr(module, "_maybe_tsne_plot",
                            lambda features, labels, *a, **k: calls.append(len(features)))
    return calls


def _rel_err(got, ref):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max(initial=0.0) / max(np.abs(ref).max(initial=0.0), 1.0)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("recognition_corpus"))
    info = make_synthetic_corpus(root, subjects=("s1",), sequences=SEQUENCES, n_sentences=3,
                                 frames_per_sentence=10,
                                 framerate=DATASET_CONFIG["gottingen"].FRAMERATE,
                                 articulators=sorted(TUBE_ARTICULATORS))
    rng = np.random.default_rng(30)
    for seq in SEQUENCES:
        air_dir = os.path.join(root, "s1", seq, "air_column")
        os.makedirs(air_dir)
        for frame in range(30):
            np.save(os.path.join(air_dir, f"{frame:04d}.npy"),
                    rng.uniform(0.2, 0.8, (2, 2, 100)).astype(np.float32))
    vocab_path = os.path.join(root, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    return root, vocab_path


def _datasets(pkg_recognition, root, vocab_path, feature, tmp_dir):
    with open(VOICING) as f:
        voiced = json.load(f)
    return pkg_recognition.PhonemeRecognitionDataset(
        datadir=root, database_name="gottingen",
        sequences=sequences_from_dict(root, {"s1": list(SEQUENCES)}),
        vocabulary=load_vocabulary(vocab_path), features=[feature], voiced_tokens=voiced,
        tmp_dir=tmp_dir)


def _equal_items(a, b):
    assert set(a) == set(b)
    for key in a:
        if isinstance(a[key], np.ndarray):
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("feature", ["melspec", "vocal_tract", "air_column"])
def test_dataset_and_loader_match_jax(corpus, feature, tmp_path):
    root, vocab_path = corpus
    tmp = {p: str(tmp_path / p) if feature == "melspec" else None for p in ("jax", "port")}
    ours = _datasets(recognition, root, vocab_path, feature, tmp["port"])
    ref = _datasets(jax_recognition, root, vocab_path, feature, tmp["jax"])
    assert len(ours) == len(ref) == 9
    for i in range(len(ref)):
        _equal_items(ours[i], ref[i])
    assert any(ours[i]["voicing"].any() for i in range(len(ours)))
    loader = recognition.RecognitionLoader(ours, feature, batch_size=4, seed=3)
    ref_loader = jax_recognition.RecognitionLoader(ref, feature, batch_size=4, seed=3)
    for _ in range(2):  # two epochs: the shuffle follows the epoch
        batches, ref_batches = list(loader), list(ref_loader)
        assert len(batches) == len(ref_batches) == 3
        for (batch, meta), (ref_batch, ref_meta) in zip(batches, ref_batches):
            assert meta == ref_meta
            _equal_items(batch, ref_batch)
    # The short last batch: padded rows of length 0, features and voicing at -1.
    last = batches[-1][0]
    assert list(last["input_lengths"][1:]) == [0, 0, 0]
    assert (last["voicing"][1:] == -1.0).all() and (last["ctc_target"][1:] == -1).all()
    if feature == "melspec":
        with pytest.raises(ValueError, match="requires tmp_dir"):
            _datasets(recognition, root, vocab_path, feature, None)
    else:
        assert (last["features"][1:] == -1.0).all()


def test_articulation_datasets_voicing_matches_jax(corpus):
    root, vocab_path = corpus
    with open(VOICING) as f:
        voiced = json.load(f)
    kwargs = dict(datadir=root, database_name="gottingen",
                  sequences=sequences_from_dict(root, {"s1": ["S01"]}),
                  vocabulary=load_vocabulary(vocab_path), articulators=["tongue", "lower-lip"],
                  voiced_tokens=voiced)
    for ours, ref in ((datasets.ArtSpeechDataset(**kwargs),
                       jax_datasets.ArtSpeechDataset(**kwargs)),
                      (pc_datasets.PrincipalComponentsDataset(**kwargs),
                       jax_pc_datasets.PrincipalComponentsDataset(**kwargs))):
        for i in range(len(ref)):
            assert np.array_equal(ours[i]["voicing"], ref[i]["voicing"])
        assert any(ours[i]["voicing"].any() for i in range(len(ours)))


# ---------- train and eval steps ----------


def _batch(seed, criterion):
    """A features batch of the collate's layout with a ragged row and a row
    of length 0: CTC targets (5, 3, 0 labels) or frame targets."""
    rng = np.random.default_rng(seed)
    features = rng.normal(size=(B, 2, D, T)).astype(np.float32)
    features = np.where(LENGTHS[:, None, None, None] <= np.arange(T), np.float32(-1.0), features)
    voicing = np.where(LENGTHS[:, None] <= np.arange(T), np.float32(-1.0),
                       rng.integers(0, 2, (B, T)).astype(np.float32))
    batch = {"features": features, "input_lengths": LENGTHS.copy(), "voicing": voicing}
    if criterion == "ctc":
        target_lengths = np.array([5, 3, 0], np.int32)
        targets = rng.integers(2, K, (B, T)).astype(np.int32)
        targets[target_lengths[:, None] <= np.arange(T)] = -1
        batch.update(ctc_target=targets, ctc_target_lengths=target_lengths)
    else:
        targets = rng.integers(0, K, (B, T)).astype(np.int32)
        targets[LENGTHS[:, None] <= np.arange(T)] = -1
        batch.update(acoustic_target=targets, acoustic_target_lengths=LENGTHS.copy())
    return batch


@pytest.fixture(scope="module")
def flax_params():
    model = JaxDeepSpeech2(**MODEL)
    batch = _batch(0, "ctc")
    return model, _tree(model.init(jax.random.PRNGKey(2), jnp.asarray(batch["features"]),
                                   lengths=jnp.asarray(batch["input_lengths"]))["params"])


def _port_state(params, lr=LR):
    model = DeepSpeech2(**MODEL, device="cpu")
    model.load_state_dict(deepspeech2_state_dict_from_flax(params))
    return create_train_state(model, lr, WD)


@pytest.fixture(scope="module")
def class_weights(tmp_path_factory):
    path = tmp_path_factory.mktemp("weights") / "class_weights.json"
    path.write_text(json.dumps({f"t{i}": 0.5 + 0.25 * i for i in range(K)}))
    vocab = {f"t{i}": i for i in range(K)}
    return load_class_weights(str(path), vocab), str(path), vocab


@pytest.mark.parametrize("criterion", ["ctc", "ce"])
def test_train_step_matches_jax(flax_params, class_weights, criterion):
    """Two steps with voicing, AdamW under the cyclic schedule."""
    jax_model, params = flax_params
    target_key = "ctc_target" if criterion == "ctc" else "acoustic_target"
    weights = class_weights[0] if criterion == "ce" else None
    jax_weights = jnp.asarray(weights.numpy()) if weights is not None else None
    schedule = jax_step.cyclic_triangular_schedule(LR / 25, LR, step_size=3)
    tx = optax.adamw(schedule, weight_decay=WD)
    jax_state = JaxTrainState.create(apply_fn=jax_model.apply, params=params, tx=tx)
    jax_train = jax_step.make_recognition_train_step(
        jax_model, criterion, target_key, feature="vocal_tract", use_voicing=True,
        class_weights=jax_weights, donate=False)
    state = _port_state(params)
    train = step.make_recognition_train_step(
        criterion, target_key, feature="vocal_tract", use_voicing=True, class_weights=weights,
        schedule=step.cyclic_triangular_schedule(LR / 25, LR, step_size=3), device="cpu")
    def jax_loss(p, jb):
        logits = jax_model.apply({"params": p}, jb["features"], voicing=jb["voicing"],
                                 lengths=jb["input_lengths"])
        if criterion == "ctc":
            return jax_step.ctc_loss(jax.nn.log_softmax(logits, -1), jb[target_key],
                                     jb["input_lengths"], jb[f"{target_key}_lengths"])
        return jax_step.cross_entropy_loss(logits, jb[target_key], jb["input_lengths"],
                                           class_weights=jax_weights)

    jax_grad = jax.jit(jax.grad(jax_loss))
    for i in range(2):
        batch = _batch(10 + i, criterion)
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        ref_grads = deepspeech2_state_dict_from_flax(_tree(jax_grad(jax_state.params, jb)))
        jax_state, ref_metrics = jax_train(jax_state, jb, jax.random.PRNGKey(i))
        metrics = train(state, batch, torch.Generator().manual_seed(i))
        assert abs(metrics["loss"].item() - float(ref_metrics["loss"])) <= \
            TOL * max(abs(float(ref_metrics["loss"])), 1.0)
        grads = {n: p.grad for n, p in state.model.named_parameters()}
        errs = {n: _rel_err(g, ref_grads[n]) for n, g in grads.items() if n != "conv.bias"}
        assert max(errs.values()) <= GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
        ref_params = deepspeech2_state_dict_from_flax(_tree(jax_state.params))
        for n, p in state.model.named_parameters():
            sure = np.abs(ref_grads[n].numpy()) >= 100 * ADAM_EPS
            got, ref = p.detach().numpy(), ref_params[n].numpy()
            assert np.abs(got - ref)[sure].max(initial=0.0) <= GRAD_TOL * max(np.abs(ref).max(), 1), n
            assert np.abs(got - ref).max() <= 2 * LR * (i + 1), n
    assert state.step == 2


@pytest.mark.parametrize("criterion", ["ctc", "ce"])
def test_accum_steps_two_equals_one(flax_params, class_weights, criterion):
    """Two microbatches of 2 against the whole batch of 4 (one row of length
    0), dropout and margins off: loss, gradients and the updated parameters
    (where the gradient is at least 100 * Adam's eps) within 1e-6."""
    _, params = flax_params
    target_key = "ctc_target" if criterion == "ctc" else "acoustic_target"
    weights = class_weights[0] if criterion == "ce" else None
    b3 = _batch(20, criterion)
    b_extra = _batch(21, criterion)
    batch = {k: np.concatenate([b3[k], b_extra[k][:1]]) for k in b3}
    out = {}
    for accum in (1, 2):
        state = _port_state(params)
        train = step.make_recognition_train_step(criterion, target_key, feature="vocal_tract",
                                                 use_voicing=True, class_weights=weights,
                                                 accum_steps=accum, device="cpu")
        out[accum] = (train(state, batch)["loss"].item(),
                      {n: (p.detach().clone(), p.grad) for n, p in state.model.named_parameters()})
    assert abs(out[1][0] - out[2][0]) <= 1e-6 * max(abs(out[1][0]), 1.0)
    for n, (ref, ref_grad) in out[1][1].items():
        got, grad = out[2][1][n]
        assert _rel_err(grad, ref_grad) <= 1e-6, n
        sure = ref_grad.abs() >= 100 * ADAM_EPS
        assert _rel_err(got[sure], ref[sure]) <= 1e-6, n
    with pytest.raises(ValueError, match="not divisible"):
        step.make_recognition_train_step(criterion, target_key, feature="vocal_tract",
                                         accum_steps=3, device="cpu")(_port_state(params), batch)


@pytest.mark.parametrize("use_beam", [False, True])
def test_run_recognition_test_matches_jax(corpus, flax_params, use_beam, tmp_path, no_tsne):
    """The eval step and the harness over the corpus's vocal-tract batches:
    the same info (loss within 1e-5) and artifacts as JAX's."""
    root, vocab_path = corpus
    jax_model, params = flax_params
    vocab = load_vocabulary(vocab_path)
    kwargs = {**MODEL, "num_classes": len(vocab), "num_features": 500,
              "adapter_out_features": D}
    jax_model = JaxDeepSpeech2(**kwargs)
    jax_params = _tree(jax_model.init(jax.random.PRNGKey(4), jnp.zeros((1, 2, 500, 8)))["params"])
    model = DeepSpeech2(**kwargs, device="cpu")
    model.load_state_dict(deepspeech2_state_dict_from_flax(jax_params))
    infos = {}
    for pkg, harness in (("jax", jax_run_recognition_test), ("port", run_recognition_test)):
        rec = jax_recognition if pkg == "jax" else recognition
        loader = rec.RecognitionLoader(_datasets(rec, root, vocab_path, "vocal_tract", None),
                                       "vocal_tract", batch_size=4, shuffle=False)
        if pkg == "jax":
            st = JaxTrainState.create(apply_fn=jax_model.apply, params=jax_params,
                                      tx=optax.identity())
            ev = jax_step.make_recognition_eval_step(jax_model, "ctc", "ctc_target",
                                                     feature="vocal_tract", use_voicing=True,
                                                     return_features=True)
        else:
            st = TrainState(model=model, optimizer=None)
            ev = step.make_recognition_eval_step("ctc", "ctc_target", feature="vocal_tract",
                                                 use_voicing=True, return_features=True,
                                                 device="cpu")
        infos[pkg] = harness(st, ev, loader, "ctc_target", vocab,
                             outputs_dir=str(tmp_path / pkg), use_beam=use_beam,
                             beam_width=4, collect_features=True)
    assert abs(infos["port"]["loss"] - infos["jax"]["loss"]) <= TOL * max(infos["jax"]["loss"], 1)
    assert {k: v for k, v in infos["port"].items() if k != "loss"} == \
        {k: v for k, v in infos["jax"].items() if k != "loss"}
    port, ref = tmp_path / "port", tmp_path / "jax"
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for name in ("substitution_matrix.npy", "grouped_confusion_matrix.npy"):
        assert np.array_equal(np.load(port / name), np.load(ref / name))
    assert json.loads((port / "predictions.json").read_text()) == \
        json.loads((ref / "predictions.json").read_text())
    feats, ref_feats = np.load(port / "features.npz"), np.load(ref / "features.npz")
    assert np.array_equal(feats["labels"], ref_feats["labels"])
    assert _rel_err(feats["features"], ref_feats["features"]) <= TOL
    assert len(no_tsne) == 2 and no_tsne[0] == no_tsne[1] > 0


def test_tsne_plot_is_written_or_skipped(tmp_path, monkeypatch):
    """The plot of the features by phonetic class where sklearn and
    matplotlib import, as in JAX; nothing, and no error, where one does not."""
    rng = np.random.default_rng(40)
    features = [rng.normal(size=(6, 4)).astype(np.float32) for _ in range(3)]
    labels = [rng.integers(0, K, 6) for _ in range(3)]
    vocab = {f"t{i}": i for i in range(K)}
    monkeypatch.setitem(sys.modules, "sklearn.manifold", None)
    eval_recognition._maybe_tsne_plot(features, labels, vocab, str(tmp_path))
    assert os.listdir(tmp_path) == []
    monkeypatch.delitem(sys.modules, "sklearn.manifold")
    try:
        import matplotlib  # noqa: F401
        import sklearn.manifold  # noqa: F401
    except ImportError:
        return
    eval_recognition._maybe_tsne_plot(features, labels, vocab, str(tmp_path))
    assert os.listdir(tmp_path) == ["tsne_features.png"]


# ---------- the CLIs ----------


def _run(module_name, cfg, output_dir, monkeypatch, tmp_path):
    cfg_path = tmp_path / f"{module_name}_{len(os.listdir(tmp_path))}.yaml"
    cfg_path.write_text(yaml.safe_dump(cfg))
    module = importlib.import_module(f"artspeech_tpu_torch.cli.{module_name}")
    common = importlib.import_module("artspeech_tpu_torch.cli.common")
    monkeypatch.setattr(sys, "argv", [module_name, "--config", str(cfg_path), "--output_dir",
                                      str(output_dir), "--run_name", "run", "--device", "cpu"])
    return common.run_experiment(module_name, module.main)


def _config(name, root, vocab_path, **changes):
    """A repository config with the corpus's paths and database, narrow
    model widths (the feature's D kept) and ``changes``."""
    cfg = config_file.load(os.path.join(CONFIGS, f"{name}.yaml"))
    cfg.update(datadir=root, database_name="gottingen", vocab_filepath=vocab_path,
               **changes)
    if "voicing_filepath" in cfg:
        cfg["voicing_filepath"] = VOICING
    for key in ("train_seq_dict", "valid_seq_dict", "test_seq_dict"):
        if key in cfg:
            cfg[key] = {"s1": [SEQUENCES[("train_seq_dict", "valid_seq_dict",
                                          "test_seq_dict").index(key)]]}
    cfg["model_params"] = {**cfg["model_params"], "num_residual_layers": 1,
                           "num_rnn_layers": 1, "rnn_hidden_size": H, "conv_channels": C}
    return cfg


TRAIN_TEST = {"train_acoustic": "test_acoustic", "train_air_column": "test_air_column",
              "train_air_column_voicing": "test_air_column_voicing",
              "train_vocal_tract": "test_vocal_tract",
              "train_vocal_tract_bf16": "test_vocal_tract",
              "train_vocal_tract_voicing": "test_vocal_tract_voicing"}


@pytest.mark.parametrize("train_name", sorted(TRAIN_TEST))
def test_train_then_test_cli(corpus, train_name, tmp_path, monkeypatch, no_tsne):
    """One epoch of the train CLI: checkpoints, a record of the epoch and the
    final test's artifacts; then the test CLI on its best checkpoint gives the
    final test's numbers again. The JAX package's test CLI reads the corpus
    without sentence wavs, so ``feature: melspec`` fails there as in JAX."""
    root, vocab_path = corpus
    out = tmp_path / "out"
    cfg = _config(train_name, root, vocab_path, num_epochs=1)
    launches = (hopper_gru.launches, hopper_gru.bwd_launches)
    info = _run("train_phoneme_recognition", cfg, out, monkeypatch, tmp_path)
    assert (hopper_gru.launches, hopper_gru.bwd_launches) == launches  # the CPU: no kernel
    assert set(info) == {"loss", "edit_distance", "word_info_lost"}
    assert all(np.isfinite(v) for v in info.values())
    for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json"):
        assert os.path.isfile(out / "checkpoints" / sub), sub
    outputs = out / "test_outputs"
    assert {"substitution_matrix.npy", "grouped_confusion_matrix.npy", "test_results.json",
            "predictions.json"} <= set(os.listdir(outputs))
    assert json.loads((outputs / "test_results.json").read_text()) == info
    with open(out / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records] == [0]
    assert {"train_loss", "valid_loss", "valid_edit_distance"} <= set(records[0])
    saved = torch.load(out / "checkpoints" / "best" / "state.pt", weights_only=True)["model"]
    assert all(v.dtype == torch.float32 for v in saved.values())

    test_cfg = _config(TRAIN_TEST[train_name], root, vocab_path,
                       state_dict_filepath=str(out / "checkpoints" / "best" / "state"))
    if cfg["feature"] == "melspec":
        with pytest.raises(ValueError, match="requires tmp_dir"):
            _run("test_phoneme_recognition", test_cfg, tmp_path / "test", monkeypatch, tmp_path)
        return
    tested = _run("test_phoneme_recognition", test_cfg, tmp_path / "test", monkeypatch, tmp_path)
    if "compute_dtype" in cfg:
        # The test config computes in float32 the weights trained in bf16.
        assert tested["edit_distance"] >= 0 and np.isfinite(tested["loss"])
    else:
        assert tested["edit_distance"] == info["edit_distance"]
        assert tested["loss"] == pytest.approx(info["loss"], rel=1e-6)
    assert os.path.isfile(tmp_path / "test" / "test_outputs" / "features.npz")
    assert len(no_tsne) == 2


SYNTHETIC_CONFIGS = sorted(name[:-5] for name in os.listdir(CONFIGS)
                           if name.startswith("test_synthetic_"))


def test_test_cli_refuses_a_synthetic_corpus(corpus, tmp_path, monkeypatch, no_tsne):
    """The test CLI once refused ``synthetic: true``; it now scores a
    synthesized corpus. The corpus's test sentences go through the port's
    synthesis (a seeded ArtSpeech over the ten recognition articulators,
    ``synthesize_corpus`` as the generate CLI calls it), and every
    ``test_synthetic_*`` config (seven: the encoder-decoder, autoencoder
    and mean-contour corpora, with and without voicing, and the plain one)
    scores it with one seeded narrow recognizer: finite results, the
    artifacts, one prediction a sentence, the voicing configs' voicing
    moving the loss, and no kernel launched on the CPU."""
    root, vocab_path = corpus
    vocab = load_vocabulary(vocab_path)
    assert len(SYNTHETIC_CONFIGS) == 7
    sentences = SynthesisDataset(root, "gottingen", sequences_from_dict(root, {"s1": ["S03"]}),
                                 vocab, RECOGNITION_ARTICULATORS)
    save_to = str(tmp_path / "synthesis")
    synthesize_corpus(ArtSpeech(len(vocab), len(RECOGNITION_ARTICULATORS), embed_dim=8,
                                hidden_size=8, generator=torch.Generator().manual_seed(7),
                                device="cpu"),
                      sentences, save_to, DATASET_CONFIG["gottingen"], device="cpu")
    weights = str(tmp_path / "recognizer")
    results, launches = {}, (hopper_gru.launches, hopper_gru.bwd_launches)
    for name in SYNTHETIC_CONFIGS:
        cfg = {**_config(name, root, vocab_path, state_dict_filepath=weights), "datadir": save_to}
        assert cfg["synthetic"] is True and cfg["model_params"]["adapter_out_features"] == 80
        if not os.path.exists(weights):
            checkpoint.save_params(weights, DeepSpeech2(num_classes=len(vocab),
                                                        **cfg["model_params"], device="cpu"))
        out = tmp_path / name
        results[name] = _run("test_phoneme_recognition", cfg, out, monkeypatch, tmp_path)
        assert set(results[name]) == {"loss", "edit_distance", "word_info_lost"}
        assert all(np.isfinite(v) for v in results[name].values()), name
        outputs = out / "test_outputs"
        assert {"substitution_matrix.npy", "grouped_confusion_matrix.npy", "test_results.json",
                "predictions.json", "features.npz"} <= set(os.listdir(outputs))
        assert len(json.loads((outputs / "predictions.json").read_text())) == len(sentences)
    assert (hopper_gru.launches, hopper_gru.bwd_launches) == launches
    plain = results["test_synthetic_encoder_decoder_vocal_tract"]
    voiced = results["test_synthetic_encoder_decoder_vocal_tract_voicing"]
    assert plain == results["test_synthetic_vocal_tract"]
    assert voiced["loss"] != plain["loss"]
    assert len(no_tsne) == 7
