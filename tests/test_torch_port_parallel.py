"""The port's data parallelism against the JAX package's 8-device CPU mesh
(tests/conftest.py), on 4 ranks of a gloo group spawned by
``parallel.dryrun.spawn`` (rendezvous on a free loopback port, every
collective bounded by the group's 60 s timeout, the ranks killed and the test
failed past twice that).

Same numpy-seeded inputs through both packages, the weights carried across by
the flax -> state_dict converters; JAX's side uses ``jax.devices()[:4]``:
- ``make_mesh`` (data 2 x model 2; ``model_parallel=3`` raises),
  ``params_shardings`` (JAX's three-leaf example and ArtSpeech's parameter
  tree) and ``shard_batch`` (each rank's rows are JAX's shard on the device
  at its grid position);
- ``round_up_to_multiple``, ``BucketedLoader(pad_to_multiple, drop_last)``
  against JAX's on one corpus, ``CachedLoader`` replay, and epoch means
  weighted by ``n_real``;
- the 4-rank ArtSpeech step against JAX's shard_map step and the port's
  one-rank step, ragged (rows 20-63 dummies, so ranks 2 and 3 hold none) and
  not: loss and ``p2cp_mm`` within 1e-4 relative, the first step's summed
  gradients within 1e-5 of max(|JAX's shard_map gradient|, 1) per tensor,
  parameters after two updates within 1e-5 of the one-rank step's and of
  JAX's (within 3 lr, the one-device port-vs-JAX bound, where JAX's first
  gradient is under 1e-5),
  ``manual_spmd`` 1.0 / 0.0;
- the (data 2, model 2) step with the heads sharded over ``model`` against
  JAX's single-device step of ``tests/test_parallel.py``: loss rtol 1e-5,
  p2cp rtol 1e-4, each rank's head gradient its slice of the one-rank
  gradient (not ``model`` times it);
- the transformer, latent-RNN, frame-autoencoder and recognizer (CTC and CE)
  steps at 2 ranks against 1: loss rtol 1e-5, the summed gradients within
  1e-5 of max(|one rank's|, 1) per tensor, parameters after one update within
  1e-5 (within one AdamW step, lr, where the one-rank gradient is under
  1e-6: there AdamW's eps of 1e-8 makes the step follow the gradient's
  rounding noise, as for DeepSpeech2's conv biases before a LayerNorm, whose
  gradient is zero but for rounding).
All multi-rank scenarios run in one spawn of 4 ranks; one more spawn shows
that a rank that never arrives fails the call within its deadline.
"""

import time

import jax
import numpy as np
import optax
import pytest
import torch

import torch_parallel_ranks as ranks_mod
from artspeech_tpu.data import batching as jax_batching
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.parallel import distributed as jax_distributed
from artspeech_tpu.parallel import mesh as jax_mesh
from artspeech_tpu.train import loop as jax_loop
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.train import step as jax_step
from artspeech_tpu_torch.data import batching
from artspeech_tpu_torch.parallel import dryrun
from artspeech_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    make_mesh,
    params_shardings,
)
from artspeech_tpu_torch.train import loop
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax

TO_MM = ranks_mod.TO_MM
DP = {"B": 64, "NART": 4, "T": 16, "HIDDEN": 32, "LR": 1e-4}
TP = {"B": 8, "NART": 8, "T": 12, "HIDDEN": 8, "LR": 1e-3}
CASE_LR = 1e-4  # the learning rate of parallel/dryrun.py's family cases


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _artspeech_batches():
    rng = np.random.default_rng(0)
    b, t = DP["B"], DP["T"]
    tokens = rng.integers(0, 32, (b, t)).astype(np.int32)
    lengths = rng.integers(2, t + 1, (b,)).astype(np.int32)
    targets = rng.uniform(size=(b, t, DP["NART"], 2, 50)).astype(np.float32)
    ragged = lengths.copy()
    ragged[20:] = 0
    return {False: {"tokens": tokens, "targets": targets, "lengths": lengths},
            True: {"tokens": tokens, "targets": targets, "lengths": ragged}}


def _shard_map_gradients(st0, step, sharded, mesh):
    """The first step's summed gradients of JAX's shard_map step, read off one
    SGD update at lr 1 from the same parameters (and dropout key 0)."""
    sgd = optax.sgd(1.0)
    st = jax_distributed.distribute_state(
        st0.replace(tx=sgd, opt_state=sgd.init(st0.params)), mesh)
    st1, _ = step(st, sharded, jax.random.PRNGKey(0))
    grads = jax.tree_util.tree_map(lambda a, b: np.asarray(a, np.float64) - np.asarray(b),
                                   st0.params, st1.params)
    return {k: np.asarray(v) for k, v in artspeech_state_dict_from_flax(grads).items()}


@pytest.fixture(scope="module")
def jax_side():
    """JAX's shard_map ArtSpeech step on 4 devices (two updates, ragged and
    not) and its single-device step at the dp x tp setup."""
    devices = jax.devices()[:4]
    batches = _artspeech_batches()
    model = JaxArtSpeech(vocab_size=32, n_articulators=DP["NART"], hidden_size=DP["HIDDEN"],
                         dropout=0.0)
    b0 = batches[False]
    st0 = jax_state.create_train_state(model, jax.random.PRNGKey(0),
                                       (b0["tokens"], b0["lengths"]), DP["LR"])
    mesh = jax_mesh.data_parallel_mesh(DP["B"], devices)
    step = jax_step.make_artspeech_train_step(TO_MM, donate=False, with_p2cp=True, mesh=mesh)
    shard_map = {}
    for ragged, batch in batches.items():
        st = jax_distributed.distribute_state(st0, mesh)
        sharded = jax.device_put(batch, jax_mesh.batch_sharding(mesh))
        metrics = []
        for i in range(2):
            st, m = step(st, sharded, jax.random.PRNGKey(i))
            metrics.append({k: float(v) for k, v in m.items()})
        shard_map[ragged] = {"metrics": metrics,
                             "params": artspeech_state_dict_from_flax(_np_tree(st.params)),
                             "grads": _shard_map_gradients(st0, step, sharded, mesh)}

    rng = np.random.default_rng(0)
    tp_batch = {"tokens": rng.integers(0, 16, (TP["B"], TP["T"])).astype(np.int32),
                "lengths": np.full((TP["B"],), TP["T"], np.int32),
                "targets": rng.uniform(size=(TP["B"], TP["T"], TP["NART"], 2, 50))
                .astype(np.float32)}
    tp_model = JaxArtSpeech(vocab_size=16, n_articulators=TP["NART"], hidden_size=TP["HIDDEN"])
    tp_st = jax_state.create_train_state(tp_model, jax.random.PRNGKey(0),
                                         (tp_batch["tokens"], tp_batch["lengths"]), TP["LR"])
    _, tp_metrics = jax_step.make_artspeech_train_step(TO_MM, donate=False, with_p2cp=True)(
        tp_st, tp_batch, jax.random.PRNGKey(1))
    return {"batches": batches, "params0": _np_tree(st0.params), "shard_map": shard_map,
            "tp_batch": tp_batch, "tp_params0": _np_tree(tp_st.params),
            "tp_metrics": {k: float(v) for k, v in tp_metrics.items()}}


@pytest.fixture(scope="module")
def rank_results(jax_side):
    """Every multi-rank scenario, one spawn of 4 gloo ranks."""
    inputs = {
        "rows": np.arange(8 * 4, dtype=np.float32).reshape(8, 4),
        "artspeech": {"state_dict": artspeech_state_dict_from_flax(jax_side["params0"]),
                      "model": {"vocab_size": 32, "n_articulators": DP["NART"],
                                "hidden_size": DP["HIDDEN"]},
                      "lr": DP["LR"], "batches": jax_side["batches"]},
        "tp": {"state_dict": artspeech_state_dict_from_flax(jax_side["tp_params0"]),
               "model": {"vocab_size": 16, "n_articulators": TP["NART"],
                         "hidden_size": TP["HIDDEN"]},
               "lr": TP["LR"], "batch": jax_side["tp_batch"]},
    }
    return dryrun.spawn(4, ranks_mod.parallel_scenarios, inputs, timeout_s=60.0)


def test_mesh_shapes_match_jax(rank_results):
    ref = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)
    with pytest.raises(ValueError):
        jax_mesh.make_mesh(jax.devices()[:4], model_parallel=3)
    # Without a process group: the same grid, no groups.
    local = make_mesh(range(4), model_parallel=2, device="cpu")
    assert local.shape == dict(ref.shape) == {DATA_AXIS: 2, MODEL_AXIS: 2}
    assert local.group is None and local.data_group is None
    with pytest.raises(ValueError):
        make_mesh(range(4), model_parallel=3, device="cpu")
    ref_ids = [[d.id for d in row] for row in ref.devices]
    for rank, result in enumerate(rank_results):
        shape, coords, grid = result["mesh"]
        assert shape == dict(ref.shape) and result["mp3_raises"]
        # Row-major as JAX reshapes its devices: rank r sits where device r does.
        assert [[ref_ids[0][0] + r for r in row] for row in grid] == ref_ids
        assert coords == divmod(rank, 2)


def test_params_shardings_match_jax():
    port_mesh = make_mesh(range(4), model_parallel=2, device="cpu")
    ref_mesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)
    three = {"heads": np.zeros((8, 16, 16)), "dense": np.zeros((7, 16)), "bias": np.zeros((16,))}
    model = JaxArtSpeech(vocab_size=16, n_articulators=8, hidden_size=8)
    tokens = np.zeros((2, 4), np.int32)
    flax_tree = _np_tree(jax.jit(model.init)(jax.random.PRNGKey(0), tokens,
                                             np.full((2,), 4, np.int32))["params"])
    for tree in (three, flax_tree):
        ref = jax_mesh.params_shardings(tree, ref_mesh)
        flat_ref = {"/".join(str(k.key) for k in path): MODEL_AXIS in str(s.spec)
                    for path, s in jax.tree_util.tree_flatten_with_path(ref)[0]}
        got = {name: s.axis == MODEL_AXIS for name, s in params_shardings(tree, port_mesh).items()}
        assert got == flat_ref
    assert any(flat_ref.values()) and not all(flat_ref.values())
    # On the port's module: the stacked heads shard, with JAX's heuristic.
    from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech

    port_model = ArtSpeech(16, 8, hidden_size=8, device="cpu")
    placed = params_shardings(port_model, port_mesh)
    assert all(placed[n].axis == MODEL_AXIS for n, _ in port_model.decoder.named_parameters(
        prefix="decoder"))


def test_shard_batch_rows_match_jax_shards(rank_results):
    ref_mesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)
    x = np.arange(8 * 4, dtype=np.float32).reshape(8, 4)
    sharded = jax_mesh.shard_batch({"x": x}, ref_mesh)["x"]
    by_device = {s.device.id: np.asarray(s.data) for s in sharded.addressable_shards}
    first = ref_mesh.devices[0][0].id
    for rank, result in enumerate(rank_results):
        np.testing.assert_array_equal(result["rows"], by_device[first + rank])


class _Corpus:
    """Seeded in-memory sentences with the ArtSpeechDataset item interface."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.items = []
        for i, length in enumerate(rng.integers(3, 40, n)):
            self.items.append({
                "sentence_name": f"S{i:02d}", "length": int(length),
                "tokens": rng.integers(0, 9, length).astype(np.int32),
                "targets": rng.random((length, 2, 2, 5)).astype(np.float32),
                "references": rng.random((length, 1, 2, 5)).astype(np.float32),
                "critical_masks": rng.integers(0, 2, (1, length)).astype(np.int32),
                "voicing": rng.random(length).astype(np.float32),
                "phonemes": ["p"] * length, "frame_ids": list(range(length))})

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i):
        return self.items[i]


@pytest.mark.parametrize("pad_to_multiple,drop_last", [(1, False), (4, False), (3, True)])
def test_bucketed_loader_matches_jax(pad_to_multiple, drop_last):
    assert [batching.round_up_to_multiple(n, m) for n, m in ((5, 4), (8, 4), (5, 1), (5, 0))] \
        == [jax_batching.round_up_to_multiple(n, m) for n, m in ((5, 4), (8, 4), (5, 1), (5, 0))] \
        == [8, 8, 5, 5]
    corpus = _Corpus(13, seed=1)
    kwargs = dict(batch_size=5, buckets=(16, 32), seed=3, drop_last=drop_last,
                  pad_to_multiple=pad_to_multiple)
    port = batching.BucketedLoader(corpus, **kwargs)
    ref = jax_batching.BucketedLoader(corpus, **kwargs)
    assert port.collate_batch_size == ref.collate_batch_size
    for _ in range(2):  # two epochs: the shuffles follow JAX's
        got, want = list(port), list(ref)
        assert len(got) == len(want) > 0
        for (gb, gm), (wb, wm) in zip(got, want):
            assert gm == wm and gb.keys() == wb.keys()
            for key in wb:
                np.testing.assert_array_equal(gb[key], wb[key])
    cached = batching.CachedLoader(batching.BucketedLoader(corpus, **kwargs))
    first, second = list(cached), list(cached)
    assert cached.collate_batch_size == port.collate_batch_size
    assert all(a is b for a, b in zip(first, second)) and len(cached) == len(first)


def test_epoch_metrics_weighted_by_sentence_count():
    """The counterpart of JAX's test: 4 real sentences with loss 2, then 1
    with loss 7, average (4 * 2 + 7) / 5, in both packages."""
    losses = {0: 2.0, 1: 7.0}

    def eval_step(state, batch):
        return {"loss": losses[int(batch["idx"])]}, None

    loader = [({"idx": np.int32(0)}, {"n_real": 4}), ({"idx": np.int32(1)}, {"n_real": 1})]
    got = loop.run_eval_epoch(None, loader, eval_step, "cpu")
    ref = jax_loop.run_eval_epoch(None, loader, eval_step)
    assert got["loss"] == pytest.approx(ref["loss"]) == pytest.approx((4 * 2.0 + 7.0) / 5.0)


def _max_abs(a, b):
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()) for k in b)


@pytest.mark.parametrize("ragged", [False, True])
def test_data_parallel_step_matches_shard_map_and_one_rank(jax_side, rank_results, ragged):
    batch = jax_side["batches"][ragged]
    st = ranks_mod.artspeech_state(artspeech_state_dict_from_flax(jax_side["params0"]),
                                   {"vocab_size": 32, "n_articulators": DP["NART"],
                                    "hidden_size": DP["HIDDEN"]}, DP["LR"])
    one_metrics, one_eval, one_grads = ranks_mod.artspeech_steps(st, batch, None, 2)
    one_params = ranks_mod.numpy_params(st.model)
    ref = jax_side["shard_map"][ragged]
    assert rank_results[0]["dp_shape"] == {DATA_AXIS: 4, MODEL_AXIS: 1}
    for result in rank_results:
        got = result[("artspeech", ragged)]
        for i in range(2):
            assert got["metrics"][i]["manual_spmd"] == 1.0 == ref["metrics"][i]["manual_spmd"]
            assert one_metrics[i]["manual_spmd"] == 0.0
            for key in ("loss", "p2cp_mm"):
                for other in (ref["metrics"][i][key], one_metrics[i][key]):
                    assert abs(got["metrics"][i][key] - other) <= 1e-4 * max(1.0, abs(other)), \
                        (i, key)
        for key in ("loss", "p2cp_mm"):
            assert got["eval"][key] == pytest.approx(one_eval[key], rel=1e-5)
    params = rank_results[0][("artspeech", ragged)]["params"]
    assert _max_abs(params, one_params) < 1e-5
    # The first step's gradients, summed over the ranks (not averaged), are
    # JAX's shard_map gradients and the port's one-rank ones.
    grads = rank_results[0][("artspeech", ragged)]["grads"]
    assert grads.keys() == ref["grads"].keys() == one_grads.keys()
    for name, want in ref["grads"].items():
        for other in (want, one_grads[name]):
            assert np.abs(grads[name] - other).max() <= 1e-5 * max(np.abs(other).max(), 1.0), name
    # Parameters after two AdamW updates: within 1e-5 of JAX's where JAX's
    # first gradient is at least 1e-5. Below it, AdamW's update (about lr
    # whatever the gradient's size) follows the second gradient's rounding,
    # which may flip its sign in either package: there the bound
    # tests/test_torch_port_train.py holds the one-device step to, 3 lr.
    for name, want in ref["params"].items():
        diff = np.abs(params[name] - np.asarray(want))
        small = np.abs(ref["grads"][name]) < 1e-5
        assert diff[small].max(initial=0.0) <= 3 * DP["LR"], name
        assert diff[~small].max(initial=0.0) < 1e-5, name
    if ragged:  # ranks 2 and 3 hold dummies only: a mean of rank means would differ
        assert ref["metrics"][0]["p2cp_mm"] > 0.0


def test_model_axis_step_matches_single_device(jax_side, rank_results):
    st = ranks_mod.artspeech_state(artspeech_state_dict_from_flax(jax_side["tp_params0"]),
                                   {"vocab_size": 16, "n_articulators": TP["NART"],
                                    "hidden_size": TP["HIDDEN"]}, TP["LR"])
    ranks_mod.artspeech_steps(st, jax_side["tp_batch"], None, 1)
    one = {n: (p.detach().numpy(), p.grad.numpy()) for n, p in st.model.named_parameters()}
    ref = jax_side["tp_metrics"]
    per = TP["NART"] // 2
    for result in rank_results:
        got = result["tp"]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["metrics"]["p2cp_mm"], ref["p2cp_mm"], rtol=1e-4)
        assert got["metrics"]["manual_spmd"] == 1.0
        _, model_index = got["coords"]
        rows = slice(model_index * per, (model_index + 1) * per)
        for name, (param, grad) in got["heads"].items():
            full_param, full_grad = one[f"decoder.{name}"]
            assert param.shape[0] == per  # only this rank's articulators
            # The slice's gradient once, not model_parallel times it.
            np.testing.assert_allclose(grad, full_grad[rows], rtol=1e-4, atol=1e-7, err_msg=name)
            np.testing.assert_allclose(param, full_param[rows], rtol=0, atol=1e-6, err_msg=name)
        for name, grad in got["trunk_grads"].items():
            np.testing.assert_allclose(grad, one[name][1], rtol=1e-4, atol=1e-7, err_msg=name)


@pytest.mark.parametrize("family", sorted(ranks_mod.PAIR_FAMILIES))
def test_family_step_two_ranks_matches_one(rank_results, family):
    make_case, kwargs, batch = ranks_mod.PAIR_FAMILIES[family]
    case = make_case(batch, "cpu", **kwargs)
    one = {k: float(v) for k, v in dryrun.run_case(case).items()}
    one_params = ranks_mod.numpy_params(case.state.model)
    assert one["manual_spmd"] == 0.0
    for result in rank_results[:2]:
        got = result[family]["metrics"]
        assert got["manual_spmd"] == 1.0 and got.keys() == one.keys()
        for key in one:
            if key != "manual_spmd":
                assert got[key] == pytest.approx(one[key], rel=1e-5), key
    one_grads = ranks_mod.numpy_grads(case.state.model)
    grads, params = rank_results[0][family]["grads"], rank_results[0][family]["params"]
    assert grads.keys() == one_grads.keys()
    for name, ref in one_grads.items():
        assert np.abs(grads[name] - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0), name
    for name, ref in one_params.items():
        diff = np.abs(params[name] - ref)
        if name in one_grads:
            noise = np.abs(one_grads[name]) < 1e-6
            assert diff[noise].max(initial=0.0) <= CASE_LR, name
            diff = diff[~noise]
        assert diff.max(initial=0.0) < 1e-5, name
    assert torch.isfinite(torch.tensor(one["loss"]))


def test_spawn_fails_within_its_deadline_when_a_rank_does_not_arrive():
    t0 = time.monotonic()
    # Rank 0's barrier gives up after the group's timeout, or the spawn's
    # deadline kills both ranks first.
    with pytest.raises((RuntimeError, TimeoutError), match="Timed out|did not finish"):
        dryrun.spawn(2, ranks_mod.one_rank_missing, timeout_s=5.0)
    assert time.monotonic() - t0 < 2 * 5.0 + 5.0
