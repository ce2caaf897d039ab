"""The port's model axis against the JAX package's (data, model) mesh on the
8-device CPU mesh (tests/conftest.py), on 4 ranks of one gloo group spawned
by ``parallel.dryrun.spawn`` (60 s group timeout; the ranks are killed and
the test fails past twice that), and the reference ArtSpeech importer.

The transformer at ``parallel/dryrun.transformer_case``'s shapes (C = 4,
E = 16, 2 heads, 1 layer, L = 8, B = 8), its flax init with seeded noise on
every leaf, carried across by ``transformer_state_dict_from_flax``:
- on (data 2, model 2) at dropout 0 against JAX's jitted step on
  ``jax.devices()[:4]`` with ``make_mesh(model_parallel=2)`` and
  ``distribute_state``: loss rtol 1e-5, ``p2cp_mm`` rtol 1e-4; against the
  port's one-rank step: every sharded parameter holds C / 2 channels on its
  leading axis, its gradient is its slice of the one-rank gradient once
  (not ``model`` times it) and the replicated parameters' gradients the
  one-rank ones, each within 1e-5 max(|ref|, 1); the updated parameters the
  slice of the one-rank update within 1e-5 (one AdamW step, lr, where the
  one-rank gradient is under 1e-6);
- each rank's pair attention runs on its (C/2)(C-1) = 6 pairs;
- on (data 1, model 2) at dropout 0.1 against the one-rank port step: the
  same losses and, after two updates, the same parameters (bounds as above):
  the masks over channels are drawn whole and sliced;
- C = 3 on a model axis of 2: the stacks stay whole (JAX's heuristic), the
  step is the one-rank one;
- ``fit`` for 2 epochs on (data 2, model 2) against (data 2, model 1):
  ``last/state.pt`` and ``best_model`` hold whole tensors with a one-device
  model's keys and shapes, equal within 1e-5; a resume from ``last/`` runs
  on the mesh and on one device, to the same metrics.
``convert_artspeech_state_dict`` against JAX's on a numpy-seeded reference
state dict: the models' outputs within 1e-5, and ``KeyError`` for a missing
key in both.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state as flax_train_state

import torch_parallel_ranks as ranks_mod
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.models.transformer import ArtSpeechTransformer as JaxTransformer
from artspeech_tpu.parallel import distributed as jax_distributed
from artspeech_tpu.parallel import mesh as jax_mesh
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.train import step as jax_step
from artspeech_tpu.utils import torch_import as jax_torch_import
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
from artspeech_tpu_torch.parallel import dryrun
from artspeech_tpu_torch.parallel.mesh import MODEL_AXIS, make_mesh, params_shardings
from artspeech_tpu_torch.train.checkpoint import load_params
from artspeech_tpu_torch.utils import convert_artspeech_state_dict
from artspeech_tpu_torch.utils.convert import transformer_state_dict_from_flax

TO_MM = ranks_mod.TO_MM
B, C, D, VOCAB, LR = 8, 4, 10, 16, 1e-3
MODEL = dict(vocab_size=VOCAB, num_articulators=C, embed_dim=16, num_heads=2, num_layers=1,
             num_feat=2 * D, encoder_ff_dim=32)
FIT = dict(n_art=C, d=D, vocab=VOCAB, batch_size=4, n_train=8, n_valid=4, lr=1e-3)
STACKS = ("decoder_layers.0.self_attn.", "decoder_layers.0.inter.", "decoder_layers.0.mem_attn.",
          "predictors.")


def _noisy_init(model, args, seed):
    params = jax.jit(model.init)(jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])


def _jax_transformer(batch, model_kwargs, seed):
    model = JaxTransformer(**{k: v for k, v in model_kwargs.items()})
    tgt_in = np.asarray(jax_step.shift_targets_right(jnp.asarray(batch["targets"])))
    params = _noisy_init(model, (batch["tokens"], tgt_in, batch["lengths"], batch["lengths"]),
                         seed)
    return model, params


@pytest.fixture(scope="module")
def jax_side():
    """JAX's transformer step on a (data 2, model 2) mesh of 4 devices."""
    batch = dryrun.transformer_case(B, "cpu").batch
    model, params = _jax_transformer(batch, MODEL, seed=0)
    mesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)
    st = jax_distributed.distribute_state(flax_train_state.TrainState.create(
        apply_fn=model.apply, params=params, tx=jax_state.make_optimizer(LR)), mesh)
    step = jax_step.make_transformer_train_step(TO_MM, donate=False, with_p2cp=True)
    _, metrics = step(st, jax.device_put(batch, jax_mesh.batch_sharding(mesh)),
                      jax.random.PRNGKey(0))
    odd_batch = {"tokens": batch["tokens"], "lengths": batch["lengths"],
                 "targets": batch["targets"][:, :, :3]}
    _, odd_params = _jax_transformer(odd_batch, {**MODEL, "num_articulators": 3}, seed=1)
    return {"batch": batch, "state_dict": transformer_state_dict_from_flax(params),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "odd": {"batch": odd_batch, "state_dict": transformer_state_dict_from_flax(odd_params),
                    "model": {**MODEL, "num_articulators": 3}}}


@pytest.fixture(scope="module")
def one_rank(jax_side):
    """The port's one-rank steps: dropout 0 (one update) and 0.1 (two)."""
    out = {}
    for dropout, n_steps in ((0.0, 1), (0.1, 2)):
        st = ranks_mod.transformer_state(jax_side["state_dict"], MODEL, LR, dropout=dropout)
        with ranks_mod.counted_attends() as calls:
            metrics, first = ranks_mod.transformer_steps(st, jax_side["batch"], None, n_steps)
        out[dropout] = {"metrics": metrics, "grads": [first, ranks_mod.numpy_grads(st.model)],
                        "params": ranks_mod.numpy_params(st.model), "attends": calls}
    st = ranks_mod.transformer_state(jax_side["odd"]["state_dict"], jax_side["odd"]["model"], LR)
    metrics, grads = ranks_mod.transformer_steps(st, jax_side["odd"]["batch"], None, 1)
    out["odd"] = {"metrics": metrics[0], "grads": grads}
    return out


@pytest.fixture(scope="module")
def rank_results(jax_side, tmp_path_factory):
    """Every multi-rank scenario, one spawn of 4 gloo ranks."""
    tmp = str(tmp_path_factory.mktemp("model_axis"))
    inputs = {"transformer": {"state_dict": jax_side["state_dict"], "model": MODEL, "lr": LR,
                              "batch": jax_side["batch"]},
              "odd": jax_side["odd"], "fit": FIT, "tmp": tmp}
    return dryrun.spawn(4, ranks_mod.model_axis_scenarios, inputs, timeout_s=60.0), tmp


def _sharded(name):
    return name.startswith(STACKS)


def _close(got, ref, name, lr=None, grads=()):
    """|got - ref| <= 1e-5; within lr where any of ``grads`` is under 1e-6."""
    diff = np.abs(got - ref)
    if lr is not None:
        noise = np.zeros(diff.shape, bool)
        for g in grads:
            noise |= np.abs(g) < 1e-6
        assert diff[noise].max(initial=0.0) <= lr, name
        diff = diff[~noise]
    assert diff.max(initial=0.0) < 1e-5, name


def test_model_axis_step_matches_jax_mesh(jax_side, one_rank, rank_results):
    ref = jax_side["metrics"]
    for result in rank_results[0]:
        got = result["mesh22"]["metrics"]
        np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
        np.testing.assert_allclose(got["p2cp_mm"], ref["p2cp_mm"], rtol=1e-4)
        np.testing.assert_allclose(got["loss"], one_rank[0.0]["metrics"][0]["loss"], rtol=1e-5)
        assert got["manual_spmd"] == 1.0


def test_sharded_stacks_hold_the_rank_channels(one_rank, rank_results):
    """Each rank keeps C / 2 channels of every channel stack and head; the
    gradient is its slice's, once; the update its slice's."""
    one = one_rank[0.0]
    placed = params_shardings(ArtSpeechTransformer(**MODEL, device="cpu"),
                              make_mesh(range(4), model_parallel=2, device="cpu"))
    for result in rank_results[0]:
        r = result["mesh22"]
        rows = slice(r["coords"][1] * C // 2, (r["coords"][1] + 1) * C // 2)
        sharded = [n for n in r["grads"] if _sharded(n)]
        assert len(sharded) > 20 and all(placed[n].axis == MODEL_AXIS for n in sharded)
        for name in sharded:
            grad, ref = r["grads"][name], one["grads"][0][name][rows]
            assert grad.shape[0] == C // 2 and grad.shape == ref.shape, name
            assert np.abs(grad - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0), name
            _close(r["params"][name], one["params"][name][rows], name, LR, [ref])


def test_replicated_parameters_get_the_whole_gradient(one_rank, rank_results):
    one = one_rank[0.0]
    for result in rank_results[0]:
        r = result["mesh22"]
        replicated = [n for n in r["grads"] if not _sharded(n)]
        assert "src_embedding.weight" in replicated and "decoder_layers.0.dense_kernel" in replicated
        for name in replicated:
            grad, ref = r["grads"][name], one["grads"][0][name]
            assert grad.shape == ref.shape, name
            assert np.abs(grad - ref).max() <= 1e-5 * max(np.abs(ref).max(), 1.0), name
            _close(r["params"][name], one["params"][name], name, LR, [ref])


def test_pair_attention_runs_on_the_rank_pairs(one_rank, rank_results):
    """(G, n_pairs) of every ``fused_causal_attend`` call; H = 2. Without
    dropout the keep mask is one (1, L, L) mask; with it, one a pair."""
    h, pairs = MODEL["num_heads"], (C // 2) * (C - 1)
    assert one_rank[0.1]["attends"] == [(C * (C - 1) * B * h, C * (C - 1))] * 2
    for rank, result in enumerate(rank_results[0]):
        assert result["mesh22"]["attends"] == [(pairs * (B // 2) * h, 1)]
        if rank < 2:
            assert result["pair"]["attends"] == [(pairs * B * h, pairs)] * 2


def test_dropout_on_a_model_axis_reproduces_the_one_device_step(one_rank, rank_results):
    one = one_rank[0.1]
    for result in rank_results[0][:2]:
        for got, ref in zip(result["pair"]["metrics"], one["metrics"]):
            np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
            np.testing.assert_allclose(got["p2cp_mm"], ref["p2cp_mm"], rtol=1e-4)
    params = rank_results[0][0]["pair"]["params"]
    assert params.keys() == one["params"].keys()
    for name, ref in one["params"].items():
        assert params[name].shape == ref.shape, name
        _close(params[name], ref, name, LR, [g[name] for g in one["grads"]])


def test_indivisible_channels_stay_whole(one_rank, rank_results):
    ref = one_rank["odd"]
    for result in rank_results[0]:
        got = result["odd"]
        np.testing.assert_allclose(got["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-5)
        for name, g in ref["grads"].items():
            if name.startswith(STACKS[:3]):  # the channel stacks: C = 3, not split
                assert got["grads"][name].shape == g.shape, name
            assert np.abs(got["grads"][name] - g).max() <= 1e-5 * max(np.abs(g).max(), 1.0), name


def _state(path):
    return torch.load(path, map_location="cpu", weights_only=True)


def test_fit_on_a_model_axis_writes_whole_checkpoints(rank_results):
    results, tmp = rank_results
    whole = ArtSpeechTransformer(**MODEL, device="cpu").state_dict()
    for rank, result in enumerate(results):
        assert [r["epoch"] for r in result["fit_model_axis"]] == [0, 1]
        assert result["sharded_shapes"]["predictors.dense0_kernel"][0] == C // 2
        if rank < 2:
            for got, ref in zip(result["fit_model_axis"], result["fit_data_only"]):
                for key in ("train_loss", "valid_loss", "valid_p2cp_mm"):
                    assert got[key] == pytest.approx(ref[key], rel=1e-5), key
    got = _state(os.path.join(tmp, "model_axis", "last", "state.pt"))
    ref = _state(os.path.join(tmp, "data_only", "last", "state.pt"))
    assert got["step"] == ref["step"] == 4
    for state in (got["model"], load_params(os.path.join(tmp, "model_axis", "best_model"))):
        assert {k: v.shape for k, v in state.items()} == {k: v.shape for k, v in whole.items()}
        assert all(v.dtype == torch.float32 for v in state.values())
    # The moments (running sums of the gradients) hold the gradients'
    # agreement, within 1e-4 max(|ref|, 1e-5) a tensor, the bound
    # tests/test_torch_port_transformer_train.py holds one-device gradients
    # to against JAX (float32 LayerNorm and ReLU noise). AdamW moves a component by up to lr a step whatever its
    # gradient's size, and where a step's gradient is near rounding noise
    # (attention key biases get none but rounding; ReLUs at zero) the two
    # runs' rounding moves it differently: parameters are held within 1e-5
    # where the gradients' RMS (from the second moment) is at least 1e-3,
    # within lr a step elsewhere.
    steps = ref["step"]
    assert got["optimizer"]["state"].keys() == ref["optimizer"]["state"].keys()
    rms = {}
    for index, name in enumerate(whole):
        moments = ref["optimizer"]["state"][index]
        for key, value in moments.items():
            mine = got["optimizer"]["state"][index][key]
            assert mine.shape == value.shape, (name, key)
            bound = 1e-4 * max(value.abs().max().item(), 1e-5)
            assert (mine - value).abs().max().item() <= bound, (name, key)
        rms[name] = np.sqrt(moments["exp_avg_sq"].numpy() / (1.0 - 0.999 ** steps))
    best = load_params(os.path.join(tmp, "data_only", "best_model"))
    for state, other in ((got["model"], ref["model"]),
                         (load_params(os.path.join(tmp, "model_axis", "best_model")), best)):
        for name, value in other.items():
            diff = (state[name] - value).abs().numpy()
            assert diff.max() <= steps * FIT["lr"], name
            assert diff[rms[name] >= 1e-3].max(initial=0.0) < 1e-5, name


def test_checkpoint_resumes_on_the_mesh_and_on_one_device(jax_side, rank_results):
    results, tmp = rank_results
    st = ranks_mod.transformer_state(jax_side["state_dict"], MODEL, FIT["lr"])
    one = ranks_mod.transformer_fit(st, None, FIT, os.path.join(tmp, "resume_one"), 3,
                                    resume_from=os.path.join(tmp, "model_axis", "last"))
    assert [r["epoch"] for r in one] == [2] and st.step == 6
    for result in results:
        mesh = result["resume_mesh"]
        assert [r["epoch"] for r in mesh] == [2]
        for key in ("train_loss", "valid_loss", "valid_p2cp_mm"):
            assert mesh[0][key] == pytest.approx(one[0][key], rel=1e-5), key


# -- the reference ArtSpeech checkpoint -----------------------------------------

def _reference_artspeech(n_art=3, vocab=11, embed=6, hidden=5, n_samples=50, seed=0):
    """A numpy-seeded state dict in the reference ArtSpeech's key layout
    (encoder_decoder/models.py:99-145)."""
    rng = np.random.default_rng(seed)

    def w(*shape):
        return (0.3 * rng.standard_normal(shape)).astype(np.float32)

    sd = {"embedding.weight": w(vocab, embed)}
    for layer, width in enumerate((embed, 2 * hidden)):
        for direction in ("", "_reverse"):
            sd[f"rnn.weight_ih_l{layer}{direction}"] = w(3 * hidden, width)
            sd[f"rnn.weight_hh_l{layer}{direction}"] = w(3 * hidden, hidden)
            sd[f"rnn.bias_ih_l{layer}{direction}"] = w(3 * hidden)
            sd[f"rnn.bias_hh_l{layer}{direction}"] = w(3 * hidden)
    sd["linear.0.weight"], sd["linear.0.bias"] = w(hidden, 2 * hidden), w(hidden)
    for i in range(n_art):
        for k, width in ((0, hidden), (3, 256), (6, 256)):
            sd[f"predictors.{i}.linear.{k}.weight"] = 1.0 + w(width)
            sd[f"predictors.{i}.linear.{k}.bias"] = w(width)
        for name, (fan_in, fan_out) in (("linear.1", (hidden, 256)), ("linear.4", (256, 256)),
                                        ("x_coords", (256, n_samples)),
                                        ("y_coords", (256, n_samples))):
            sd[f"predictors.{i}.{name}.weight"] = w(fan_out, fan_in) / np.sqrt(fan_in)
            sd[f"predictors.{i}.{name}.bias"] = w(fan_out)
    return sd, dict(vocab_size=vocab, n_articulators=n_art, embed_dim=embed, hidden_size=hidden)


def test_convert_artspeech_state_dict_matches_jax():
    sd, kwargs = _reference_artspeech()
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, kwargs["vocab_size"], (3, 9)).astype(np.int32)
    lengths = np.array([9, 6, 2], np.int32)
    ref = JaxArtSpeech(**kwargs).apply({"params": jax_torch_import.convert_artspeech_state_dict(sd)},
                                       tokens, lengths)
    model = ArtSpeech(**kwargs, device="cpu")
    model.load_state_dict(convert_artspeech_state_dict(sd))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert got.shape == (3, 9, kwargs["n_articulators"], 2, 50)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_convert_artspeech_state_dict_raises_on_a_missing_key():
    sd, _ = _reference_artspeech()
    del sd["rnn.bias_hh_l1_reverse"]
    with pytest.raises(KeyError):
        jax_torch_import.convert_artspeech_state_dict(sd)
    with pytest.raises(KeyError):
        convert_artspeech_state_dict(sd)
