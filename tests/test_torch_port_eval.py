"""The port's test harness against the JAX package's.

Same numpy-seeded inputs through both packages, at narrow widths (hidden 16,
embed 8, sentences of 8-30 frames); on the CPU the port runs the plain
version of every kernel:
- ``min_distance``: the port's plain version against the JAX XLA formula and
  against ``min_distance_pallas`` in interpret mode (as tests/test_ops.py
  runs it), on random sets, the four tract-variable shapes and tie cases
  (a duplicated point, an all-identical contour, ``v`` a permutation of
  ``u``, parallel lines): indices exact, dist within 1e-6 (one rounding of
  a sqrt apart at most);
- ``tract_variables_from_stack`` and ``compute_tract_variables``: values
  within 1e-6, places of constriction exact;
- ``per_sentence_metrics``: within 1e-5 (sums over time in another order);
- ``make_test_step`` against JAX's ``test_step`` with weights carried by
  ``utils/convert.py``: every output within 1e-5. The places of
  constriction are coordinates of contour points that lie far more than
  1e-5 apart, so agreement within 1e-5 means the same argmin indices;
- ``run_test`` against JAX's on a synthetic corpus: the info dict within
  1e-5, the same files, arrays and CSV numbers within 1e-5, the same CSV
  columns in the same order.
"""

import csv
import json
import os
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.core.constants import TUBE_ARTICULATORS as JAX_TUBE_ARTICULATORS
from artspeech_tpu.data.batching import BucketedLoader as JaxBucketedLoader
from artspeech_tpu.data.datasets import ArtSpeechDataset as JaxArtSpeechDataset
from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.eval import articulation as jax_eval
from artspeech_tpu.geometry import tract_variables as jax_tv
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.ops import distances as jax_distances
from artspeech_tpu.ops.pallas_kernels import min_distance_pallas
from artspeech_tpu_torch.core.constants import TUBE_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.data.datasets import ArtSpeechDataset
from artspeech_tpu_torch.eval import articulation
from artspeech_tpu_torch.geometry import tract_variables
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.ops import distances, hopper_min_dist
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax

EMBED, HIDDEN = 8, 16
TO_MM = 136 * 1.4117647409439  # gottingen
ARTS = sorted(a for a in TUBE_ARTICULATORS if a != UPPER_INCISOR)
TV_SHAPES = {"LA": (50, 50), "TTCD": (15, 25), "TBCD": (20, 40), "VEL": (15, 50)}


# (a) min_distance --------------------------------------------------------------

def _min_dist_case(name):
    """Point-major (..., N, 2) u and v for one case."""
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    if name == "random":
        return (rng.normal(size=(3, 4, 50, 2)).astype(np.float32),
                rng.normal(size=(3, 4, 50, 2)).astype(np.float32))
    if name in TV_SHAPES:
        n, m = TV_SHAPES[name]
        return (rng.random((2, 8, n, 2)).astype(np.float32),
                rng.random((2, 8, m, 2)).astype(np.float32))
    u = rng.random((4, 6, 20, 2)).astype(np.float32)
    if name == "duplicated_point":
        v = rng.random((4, 6, 30, 2)).astype(np.float32)
        v[..., 7, :] = u[..., 12, :]
        v[..., 21, :] = u[..., 12, :]  # the same zero distance twice: (12, 7) wins
        u[..., 15, :] = u[..., 12, :]  # and from a later u point: (12, 7) still wins
        return u, v
    if name == "all_identical":
        return np.full_like(u, 0.25), np.full((4, 6, 30, 2), 0.75, np.float32)
    if name == "permutation":
        return u, u[..., rng.permutation(20), :]
    if name == "parallel_lines":
        x = np.linspace(0.0, 1.0, 50, dtype=np.float32)
        line = np.stack([x, np.zeros_like(x)], -1)
        return np.broadcast_to(line, (3, 50, 2)).copy(), np.broadcast_to(
            line + np.float32([0.0, 0.5]), (3, 50, 2)).copy()
    raise KeyError(name)


MIN_DIST_CASES = ["random", *TV_SHAPES, "duplicated_point", "all_identical", "permutation",
                  "parallel_lines"]


@pytest.mark.parametrize("case", MIN_DIST_CASES)
def test_min_distance_matches_jax_formula_and_kernel(case):
    u, v = _min_dist_case(case)
    got = [t.numpy() for t in distances.min_distance(torch.from_numpy(u), torch.from_numpy(v))]
    xla = [np.asarray(a) for a in jax_distances.min_distance(jnp.asarray(u), jnp.asarray(v))]
    pallas = [np.asarray(a) for a in min_distance_pallas(u, v)]
    assert got[0].shape == u.shape[:-2] and got[1].dtype == np.int64
    for ref in (xla, pallas):
        np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])
    # The channel-major entry point is the same function.
    cm = hopper_min_dist.min_distance_channel_major(
        torch.from_numpy(u).transpose(-1, -2), torch.from_numpy(v).transpose(-1, -2))
    for a, b in zip(cm, got):
        np.testing.assert_array_equal(a.numpy(), b)


def test_min_distance_ties_take_the_first_flat_index():
    u, v = _min_dist_case("duplicated_point")
    d, i, j = distances.min_distance(torch.from_numpy(u), torch.from_numpy(v))
    assert (d == 0).all() and (i == 12).all() and (j == 7).all()
    d, i, j = distances.min_distance(*map(torch.from_numpy, _min_dist_case("all_identical")))
    assert (i == 0).all() and (j == 0).all()
    np.testing.assert_allclose(d.numpy(), np.sqrt(2 * 0.5**2), rtol=1e-6)


# (b) tract variables ------------------------------------------------------------

def _stack(seed, shape=(2, 8)):
    rng = np.random.default_rng(seed)
    return rng.random((*shape, len(TUBE_ARTICULATORS), 2, 50)).astype(np.float32)


def _assert_tvs_match(got, ref):
    """Values within 1e-6; the places of constriction, points of the same
    contours on both sides, exactly."""
    assert set(got) == set(ref)
    for name, d in ref.items():
        if d is None:
            assert got[name] is None, name
            continue
        np.testing.assert_allclose(got[name]["value"].numpy(), np.asarray(d["value"]),
                                   rtol=0, atol=1e-6, err_msg=name)
        for poc in ("poc_1", "poc_2"):
            np.testing.assert_array_equal(got[name][poc].numpy(), np.asarray(d[poc]),
                                          err_msg=f"{name} {poc}")


def test_tract_variables_from_stack_match_jax():
    stack = _stack(0)
    names = sorted(TUBE_ARTICULATORS)
    assert names == sorted(JAX_TUBE_ARTICULATORS)
    got = tract_variables.tract_variables_from_stack(torch.from_numpy(stack), names)
    ref = jax_tv.tract_variables_from_stack(jnp.asarray(stack), names)
    assert got["LA"]["value"].shape == (2, 8) and got["LA"]["poc_1"].shape == (2, 8, 2)
    _assert_tvs_match(got, ref)


def test_compute_tract_variables_matches_jax_point_major():
    stack = _stack(1, shape=(5,))
    names = sorted(TUBE_ARTICULATORS)
    contours = {n: np.swapaxes(stack[:, i], -1, -2) for i, n in enumerate(names)}
    got = tract_variables.compute_tract_variables(
        {n: torch.from_numpy(c) for n, c in contours.items()})
    ref = jax_tv.compute_tract_variables({n: jnp.asarray(c) for n, c in contours.items()})
    _assert_tvs_match(got, ref)


# (c) per-sentence metrics -------------------------------------------------------

def test_per_sentence_metrics_match_jax():
    rng = np.random.default_rng(2)
    out = rng.random((3, 12, 4, 2, 50)).astype(np.float32)
    tgt = rng.random((3, 12, 4, 2, 50)).astype(np.float32)
    lengths = np.array([12, 0, 7], np.int32)  # a zero-length bucket-padding row
    got = articulation.per_sentence_metrics(*map(torch.from_numpy, (out, tgt, lengths)))
    ref = jax_eval.per_sentence_metrics(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(lengths))
    assert set(got) == set(ref) == {"p2cp", "med", "x_corr", "y_corr"}
    for key in ref:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-5,
                                   err_msg=key)


# (d) the test step --------------------------------------------------------------

def _jax_model_and_params(vocab_size, n_art, seed=0):
    model = JaxArtSpeech(vocab_size=vocab_size, n_articulators=n_art, embed_dim=EMBED,
                         hidden_size=HIDDEN)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32),
                        jnp.full((1,), 8, jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(params, vocab_size, n_art):
    model = ArtSpeech(vocab_size, n_art, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    model.load_state_dict(artspeech_state_dict_from_flax(params))
    return model


def _test_batch(seed, vocab_size, b=3, t=16):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, vocab_size, (b, t)).astype(np.int32),
            "targets": rng.random((b, t, len(ARTS), 2, 50)).astype(np.float32),
            "references": rng.random((b, t, 1, 2, 50)).astype(np.float32),
            "lengths": np.array([t, 9, 0], np.int32)[:b]}


def _flat(tree, prefix=""):
    """Nested dicts -> {"a/b": leaf}, None leaves dropped."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {} if tree is None else {prefix[:-1]: np.asarray(tree)}


def test_make_test_step_matches_jax():
    vocab_size = 12
    jax_model, params = _jax_model_and_params(vocab_size, len(ARTS))
    batch = _test_batch(3, vocab_size)

    def apply_fn(p, tokens, lengths):
        return jax_model.apply({"params": p}, tokens, lengths)

    jax_step, jax_arts = jax_eval.make_test_step(apply_fn, ARTS, regularize_out=True)
    ref = _flat(jax.device_get(jax_step(params, batch)))
    step, arts = articulation.make_test_step(_port_model(params, vocab_size, len(ARTS)), ARTS,
                                             regularize_out=True, device="cpu")
    got = _flat(step(batch))
    assert arts == jax_arts and set(got) == set(ref) and "tvs_pred/TBCD/poc_1" in got
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=0, atol=1e-5, err_msg=key)


# (e) run_test on a synthetic corpus --------------------------------------------

@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_corpus"))
    info = make_synthetic_corpus(root, subjects=("s1",), sequences=("S01",), n_sentences=3,
                                 frames_per_sentence=10)
    return root, {p: i for i, p in enumerate(["<blank>", "<unk>", *info["phonemes"]])}


def _read_csv(path):
    with open(path, newline="") as f:
        rows = list(csv.reader(f))
    return rows[0], rows[1:]


def _assert_same_tree(got_dir, ref_dir, atol):
    """The same relative paths; npy arrays and CSV numbers within ``atol``;
    the same CSV columns in the same order and the same CSV text fields."""
    def files(root):
        return sorted(os.path.relpath(os.path.join(d, n), root)
                      for d, _, names in os.walk(root) for n in names)

    names = files(ref_dir)
    assert files(got_dir) == names and names
    for name in names:
        got_path, ref_path = os.path.join(got_dir, name), os.path.join(ref_dir, name)
        if name.endswith(".npy"):
            np.testing.assert_allclose(np.load(got_path), np.load(ref_path), rtol=0, atol=atol,
                                       err_msg=name)
        elif name.endswith(".csv"):
            (got_head, got_rows), (ref_head, ref_rows) = _read_csv(got_path), _read_csv(ref_path)
            assert got_head == ref_head and len(got_rows) == len(ref_rows), name
            for got_row, ref_row in zip(got_rows, ref_rows):
                for col, a, b in zip(ref_head, got_row, ref_row):
                    try:
                        np.testing.assert_allclose(float(a), float(b), rtol=0, atol=atol,
                                                   err_msg=f"{name} {col}")
                    except ValueError:
                        assert a == b, (name, col)


def test_run_test_matches_jax(corpus, tmp_path):
    root, vocabulary = corpus
    jax_model, params = _jax_model_and_params(len(vocabulary), len(ARTS), seed=1)
    jax_loader = JaxBucketedLoader(
        JaxArtSpeechDataset(root, "gottingen", [("s1", "S01")], vocabulary, ARTS,
                            clip_tails=True), batch_size=2, shuffle=False)
    loader = BucketedLoader(
        ArtSpeechDataset(root, "gottingen", [("s1", "S01")], vocabulary, ARTS, clip_tails=True),
        batch_size=2, shuffle=False)

    def apply_fn(p, tokens, lengths):
        return jax_model.apply({"params": p}, tokens, lengths)

    ref = jax_eval.run_test(params, apply_fn, jax_loader, ARTS, TO_MM,
                            outputs_dir=str(tmp_path / "jax"))
    got = articulation.run_test(_port_model(params, len(vocabulary), len(ARTS)), loader, ARTS,
                                TO_MM, outputs_dir=str(tmp_path / "port"), device="cpu")
    json.dumps(got)  # plain floats, as the CLIs write them
    ref_flat, got_flat = _flat(ref), _flat(got)
    assert set(got_flat) == set(ref_flat) and "tongue/p2cp_mm" in got_flat
    for key, value in ref_flat.items():
        np.testing.assert_allclose(got_flat[key], value, rtol=0, atol=1e-5, err_msg=key)
    _assert_same_tree(str(tmp_path / "port"), str(tmp_path / "jax"), atol=1e-5)
    sentence = sorted(os.listdir(tmp_path / "port"))[0]
    head, rows = _read_csv(tmp_path / "port" / sentence / "tract_variables.csv")
    frames = _read_csv(tmp_path / "port" / sentence / "phonemes.csv")[1]
    assert head[:4] == ["sentence", "frame", "phoneme", "LA_target"]
    assert len(rows) == len(frames) > 0
