"""The port's mean-contour baseline (method A) against the JAX package's, on
the CPU.

- The table: ``fit_mean_contour`` plain, positional (3 bins) and with a
  frame subsample, and ``fit_mean_contour_reference_sampling`` at several
  fractions and seeds, over one seeded in-memory dataset: tables and counts
  equal (both sides run the same numpy; the reference sampling draws its rows
  with ``RandomState.permutation`` where JAX asks pandas, which picks the same
  rows).
- The ``.npz``: a table written by either package loads in the other.
- The forward, plain and positional, against JAX's within 1e-6.
- ``run_test(loss_agg=...)`` over a corpus, "sentence" and "batch", against
  JAX's within 1e-6.
- The CLIs end to end (``--device cpu``) on a ``make_synthetic_corpus``
  corpus against JAX's, from the keys of configs/mean_contour/: the train
  CLI (plain and ``reference_sampling``) writes the same files, the same
  table and ``test_results.json`` within 1e-6 (the ``*_mm`` numbers within
  1e-6 mm_per_unit); the test CLI on the other
  package's table reproduces the train CLI's results; the generate CLI with
  ``method: mean_contour`` writes the same tree (arrays within 1e-5, pixel
  text within 136e-5, as tests/test_torch_port_cli.py holds the thesis
  generate CLI).
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.data.batching import BucketedLoader as JaxLoader
from artspeech_tpu.data.datasets import ArtSpeechDataset as JaxDataset
from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.eval.articulation import run_test as jax_run_test
from artspeech_tpu.models import mean_contour as jax_mc
from artspeech_tpu_torch.core.config import DATASET_CONFIG, mm_per_unit
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval.articulation import run_test
from artspeech_tpu_torch.models import mean_contour
from artspeech_tpu_torch.utils.io import sequences_from_dict
from test_torch_port_cli import _assert_same_tree, _files, _flat, _run

ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)
TOL = 1e-6
TO_MM = mm_per_unit(DATASET_CONFIG["gottingen"])
V, NART, D = 9, 3, 5


def _dataset(seed=0):
    """Seeded sentences with runs of repeated tokens (so positions matter)
    and one token (V - 1) that never occurs."""
    rng = np.random.default_rng(seed)
    data = []
    for _ in range(6):
        t = int(rng.integers(5, 30))
        tokens = np.repeat(rng.integers(0, V - 1, t), rng.integers(1, 4, t))[:t]
        data.append({"tokens": tokens,
                     "targets": rng.random((t, NART, 2, D)).astype(np.float32)})
    return data


FITS = {"plain": {}, "positional": {"n_bins": 3}, "subsampled": {"sample_frac": 0.5, "seed": 3}}


@pytest.mark.parametrize("fit", sorted(FITS))
def test_table_matches_jax(fit):
    data = _dataset()
    got = mean_contour.fit_mean_contour(data, V, **FITS[fit])
    ref = jax_mc.fit_mean_contour(data, V, **FITS[fit])
    assert got.positional == ref.positional
    np.testing.assert_array_equal(got.table, ref.table)
    np.testing.assert_array_equal(got.counts, ref.counts)


def test_reference_sampling_matches_jax():
    data = _dataset(seed=1)
    for frac in (0.1, 0.25, 1.0):
        for random_state in (0, 1, 7):
            got = mean_contour.fit_mean_contour_reference_sampling(data, V, frac, random_state)
            ref = jax_mc.fit_mean_contour_reference_sampling(data, V, frac, random_state)
            np.testing.assert_array_equal(got.table, ref.table, err_msg=f"{frac} {random_state}")
            np.testing.assert_array_equal(got.counts, ref.counts)
    with pytest.raises(ValueError, match="empty"):
        mean_contour.fit_mean_contour_reference_sampling([], V)


def test_npz_loads_in_either_package(tmp_path):
    data = _dataset()
    for fit in ("plain", "positional"):
        port = mean_contour.fit_mean_contour(data, V, **FITS[fit])
        ref = jax_mc.fit_mean_contour(data, V, **FITS[fit])
        port.save(str(tmp_path / f"port_{fit}.npz"))
        ref.save(str(tmp_path / f"jax_{fit}.npz"))
        for loaded, source in ((jax_mc.MeanContourTable.load(str(tmp_path / f"port_{fit}.npz")), port),
                               (mean_contour.MeanContourTable.load(str(tmp_path / f"jax_{fit}.npz")), ref)):
            np.testing.assert_array_equal(loaded.table, source.table)
            np.testing.assert_array_equal(loaded.counts, source.counts)
            assert loaded.positional == source.positional and loaded.n_bins == source.n_bins


def test_forward_matches_jax():
    data = _dataset()
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, V, (3, 7)).astype(np.int32)
    rel = rng.random((3, 7)).astype(np.float32)
    for fit in ("plain", "positional"):
        table = mean_contour.fit_mean_contour(data, V, **FITS[fit])
        port = mean_contour.make_mean_contour_forward(table, device="cpu")
        ref = jax_mc.make_mean_contour_forward(jax_mc.fit_mean_contour(data, V, **FITS[fit]))
        for args in ((), (None, rel)):
            got = port(torch.from_numpy(tokens), *(None if a is None else torch.from_numpy(a)
                                                   for a in args))
            assert got.shape == (3, 7, NART, 2, D) and got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), np.asarray(ref(jnp.asarray(tokens), *args)),
                                       rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("mean_contour")
    datadir = str(root / "corpus")
    info = make_synthetic_corpus(datadir, subjects=("s1",), sequences=("S01", "S02", "S03"),
                                 n_sentences=3, frames_per_sentence=10)
    vocab_path = os.path.join(datadir, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    base = {"database_name": "gottingen", "datadir": datadir, "vocab_filepath": vocab_path,
            "articulators": ARTS, "clip_tails": True, "batch_size": 2,
            "train_seq_dict": {"s1": ["S01", "S02"]}, "test_seq_dict": {"s1": ["S03"]}}
    return {"root": root, "base": base}


@pytest.mark.parametrize("loss_agg", ["sentence", "batch"])
def test_run_test_loss_agg_matches_jax(corpus, loss_agg):
    base = corpus["base"]
    vocabulary = load_vocabulary(base["vocab_filepath"])
    seqs = sequences_from_dict(base["datadir"], base["test_seq_dict"])
    train = ArtSpeechDataset(base["datadir"], "gottingen",
                             sequences_from_dict(base["datadir"], base["train_seq_dict"]),
                             vocabulary, ARTS)
    table = mean_contour.fit_mean_contour(train, len(vocabulary))
    got = run_test(mean_contour.make_mean_contour_forward(table, device="cpu"),
                   BucketedLoader(ArtSpeechDataset(base["datadir"], "gottingen", seqs, vocabulary,
                                                   ARTS), batch_size=2, shuffle=False),
                   ARTS, to_mm=1.0, outputs_dir=None, loss_agg=loss_agg, device="cpu")
    forward = jax_mc.make_mean_contour_forward(table)
    ref = jax_run_test(None, lambda params, tokens, lengths: forward(tokens, lengths),
                       JaxLoader(JaxDataset(base["datadir"], "gottingen", seqs, vocabulary, ARTS),
                                 batch_size=2, shuffle=False),
                       ARTS, to_mm=1.0, outputs_dir=None, loss_agg=loss_agg)
    assert set(_flat(got)) == set(_flat(ref))
    for key, value in _flat(got).items():
        np.testing.assert_allclose(value, _flat(ref)[key], rtol=0, atol=TOL, err_msg=key)
    with pytest.raises(ValueError, match="loss_agg"):
        run_test(None, [], ARTS, to_mm=1.0, loss_agg="frame", device="cpu")


def _assert_results_match(got_path, ref_path):
    """Every number of two test_results.json within 1e-6; the ``*_mm`` ones
    are the unitless ones times mm_per_unit, so within 1e-6 times it."""
    with open(got_path) as f_got, open(ref_path) as f_ref:
        got, ref = _flat(json.load(f_got)), _flat(json.load(f_ref))
    assert set(got) == set(ref)
    for key, value in got.items():
        atol = TOL * (TO_MM if key.endswith("_mm") else 1.0)
        np.testing.assert_allclose(value, ref[key], rtol=0, atol=atol, err_msg=key)


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "reference_sampling"])
def trained(corpus, request, tmp_path_factory):
    """The train CLI of both packages on one config: {package: output dir}."""
    cfg = {**corpus["base"], "reference_sampling": request.param}
    outs = {}
    with pytest.MonkeyPatch.context() as monkeypatch:
        for package in ("artspeech_tpu", "artspeech_tpu_torch"):
            outs[package] = tmp_path_factory.mktemp(f"train_{package}")
            _run(package, "train_phoneme_wise_mean_contour", cfg, outs[package], monkeypatch,
                 tmp_path_factory.mktemp("cfg"))
    return outs


def test_train_cli_matches_jax(trained):
    port, ref = trained["artspeech_tpu_torch"], trained["artspeech_tpu"]
    assert {f for f in _files(port) if not f.startswith("run")} == \
        {f for f in _files(ref) if not f.startswith("run")}
    got = mean_contour.MeanContourTable.load(str(port / "mean_contour_table.npz"))
    exp = jax_mc.MeanContourTable.load(str(ref / "mean_contour_table.npz"))
    np.testing.assert_allclose(got.table, exp.table, rtol=0, atol=TOL)
    np.testing.assert_array_equal(got.counts, exp.counts)
    _assert_results_match(port / "test_results.json", ref / "test_results.json")
    _assert_same_tree(str(port / "test_outputs"), str(ref / "test_outputs"), atol=1e-5)


def test_test_cli_on_the_other_packages_table(corpus, trained, tmp_path, monkeypatch):
    """Each package's test CLI on the other package's table gives the train
    CLI's final test."""
    for package, table_from in (("artspeech_tpu_torch", "artspeech_tpu"),
                                ("artspeech_tpu", "artspeech_tpu_torch")):
        out = tmp_path / package
        cfg = {**corpus["base"],
               "table_filepath": str(trained[table_from] / "mean_contour_table.npz")}
        _run(package, "test_phoneme_wise_mean_contour", cfg, out, monkeypatch, tmp_path)
        _assert_results_match(out / "test_results.json",
                              trained["artspeech_tpu_torch"] / "test_results.json")


def test_generate_cli_matches_jax(corpus, trained, tmp_path, monkeypatch):
    trees = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        trees[package] = tmp_path / package / "synthesis"
        cfg = {**corpus["base"], "method": "mean_contour", "seq_dict": {"s1": ["S03"]},
               "state_dict_filepath": str(trained[package] / "mean_contour_table.npz"),
               "save_to": str(trees[package])}
        _run(package, "generate_vocal_tract_shape", cfg, tmp_path / package, monkeypatch,
             tmp_path)
    _assert_same_tree(str(trees["artspeech_tpu_torch"]), str(trees["artspeech_tpu"]),
                      atol=1e-5, txt_atol=136e-5)


def test_train_cli_refuses_reference_sampling_with_bins(corpus, tmp_path, monkeypatch):
    cfg = {**corpus["base"], "reference_sampling": True, "n_position_bins": 3}
    with pytest.raises(ValueError, match="n_position_bins"):
        _run("artspeech_tpu_torch", "train_phoneme_wise_mean_contour", cfg, tmp_path, monkeypatch,
             tmp_path)
