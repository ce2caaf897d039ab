"""The port's training slice against the JAX package's.

Same numpy-seeded inputs through both packages, at narrow widths:
- the GRU backward's plain version against ``jax.vjp`` of the Pallas
  ``gru_sequence`` (interpret mode, as tests/test_pallas_gru.py runs it) and
  against torch autograd through the plain forward: f32 within
  ``1e-5 * max(|ref|, 1)`` (summation order only); bf16 within
  ``2^-6 * max(|ref|, 1)``: dx_proj is stored in bf16 (one rounding,
  2^-8 relative) and the two sides' bf16 forwards may already differ by one
  ulp of the carry, which moves the recomputed gates;
- P2CP (the plain formula and the loss wrapper) against JAX's formula and the
  Pallas kernel, and the Euclidean loss and metric, within 1e-6;
- one ArtSpeech train step (weights and gradients carried across by
  ``artspeech_state_dict_from_flax``) and the eval step, within 1e-5;
- dropout, ``fit`` with checkpoints and resume, and the host-side scheduler
  and stopper against JAX's on a scripted metric sequence.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state as flax_train_state

from artspeech_tpu.losses import articulation as jax_losses
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.ops import distances as jax_distances
from artspeech_tpu.ops import pallas_gru
from artspeech_tpu.ops.pallas_kernels import mean_p2cp_pallas
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.train import step as jax_step
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.losses import articulation as losses
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech, SimpleArtSpeech
from artspeech_tpu_torch.ops import distances, hopper_gru
from artspeech_tpu_torch.ops.gru import apply_dropout
from artspeech_tpu_torch.train import checkpoint, loop, state
from artspeech_tpu_torch.train.step import make_artspeech_eval_step, make_artspeech_train_step
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax

VOCAB, N_ART, EMBED, HIDDEN = 12, 3, 8, 16
LR, WD = 1e-3, 1e-5
TO_MM = 136 * 1.6176470518112


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


# (a) GRU backward ----------------------------------------------------------

def _gru_inputs(seed, t=8, b=8, h=16):
    rng = np.random.default_rng(seed)
    xp = (rng.standard_normal((t, b, 3 * h)) * 0.5).astype(np.float32)
    wh = (rng.standard_normal((h, 3 * h)) * 0.3).astype(np.float32)
    bh = (rng.standard_normal(3 * h) * 0.1).astype(np.float32)
    g = rng.standard_normal((t, b, h)).astype(np.float32)
    lengths = rng.integers(1, t + 1, b)
    lengths[0] = t
    mask = np.arange(t)[:, None] < lengths[None, :]
    return xp, wh, bh, mask, g


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2.0**-6)])
@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_reference_matches_jax_kernel(reverse, dtype, tol):
    xp, wh, bh, mask, g = _gru_inputs(seed=3 + reverse)
    jdt = jnp.dtype(dtype)
    jx, jw, jb, jg = (jnp.asarray(a).astype(jdt) for a in (xp, wh, bh, g))
    _, vjp = jax.vjp(lambda x, w, b: pallas_gru.gru_sequence(
        x, w, b, jnp.asarray(mask, jdt), reverse=reverse), jx, jw, jb)
    ref = [np.asarray(r.astype(jnp.float32)) for r in vjp(jg)]

    tdt = getattr(torch, dtype)
    tx, tw, tb, tg = (torch.from_numpy(a).to(tdt) for a in (xp, wh, bh, g))
    tm = torch.from_numpy(mask)
    ys = hopper_gru.gru_sequence_reference(tx, tw, tb, tm, reverse)
    got = hopper_gru.gru_sequence_backward_reference(tx, tw, tb, tm, ys, tg, reverse)
    assert got[0].dtype == tdt and got[1].dtype == got[2].dtype == torch.float32
    for name, a, r in zip(("dx_proj", "dW_h", "db_h"), got, ref):
        assert _rel_err(a.float().numpy(), r) <= tol, name


@pytest.mark.parametrize("reverse", [False, True])
def test_gru_backward_reference_matches_autograd(reverse):
    xp, wh, bh, mask, g = _gru_inputs(seed=5 + reverse, t=7, b=5)
    params = [torch.from_numpy(a).requires_grad_() for a in (xp, wh, bh)]
    tm, tg = torch.from_numpy(mask), torch.from_numpy(g)
    ys = hopper_gru.gru_sequence_reference(*params, tm, reverse)
    ref = torch.autograd.grad(ys, params, tg)
    got = hopper_gru.gru_sequence_backward_reference(*(p.detach() for p in params), tm,
                                                     ys.detach(), tg, reverse)
    for a, r in zip(got, ref):
        assert _rel_err(a.numpy(), r.numpy()) <= 1e-5


def test_bigru_gradient_is_both_directions():
    xp_f, wh_f, bh_f, mask, g_f = _gru_inputs(seed=7)
    xp_b, wh_b, bh_b, _, g_b = _gru_inputs(seed=8)
    t = torch.from_numpy
    both = [t(np.concatenate([xp_f, xp_b], -1)).requires_grad_(),
            t(np.stack([wh_f, wh_b])).requires_grad_(), t(np.stack([bh_f, bh_b])).requires_grad_()]
    ys = hopper_gru.bigru_sequence(*both, t(mask))
    got = torch.autograd.grad(ys, both, t(np.concatenate([g_f, g_b], -1)))
    for d, (xp, wh, bh, g) in enumerate(((xp_f, wh_f, bh_f, g_f), (xp_b, wh_b, bh_b, g_b))):
        one = [t(a).requires_grad_() for a in (xp, wh, bh)]
        ref = torch.autograd.grad(hopper_gru.gru_sequence(*one, t(mask), bool(d)), one, t(g))
        np.testing.assert_array_equal(got[0][..., d * 48:(d + 1) * 48].numpy(), ref[0].numpy())
        np.testing.assert_array_equal(got[1][d].numpy(), ref[1].numpy())
        np.testing.assert_array_equal(got[2][d].numpy(), ref[2].numpy())


# (b), (c) distances, losses, metrics ----------------------------------------

def _contours(seed, shape=(3, 7, N_ART)):
    rng = np.random.default_rng(seed)
    out = rng.random((*shape, 2, 50)).astype(np.float32)
    tgt = rng.random((*shape, 2, 50)).astype(np.float32)
    lengths = np.array([7, 0, 4], np.int32)  # a zero-length bucket-padding row
    return out, tgt, lengths


def test_mean_p2cp_matches_jax_formula_and_kernel():
    out, tgt, _ = _contours(0)  # R = 3 * 7 * 3 = 63 rows, odd
    got = distances.mean_p2cp_channel_major(torch.from_numpy(out), torch.from_numpy(tgt)).numpy()
    ref = np.asarray(jax_distances.mean_p2cp_channel_major(jnp.asarray(out), jnp.asarray(tgt)))
    kernel = np.asarray(mean_p2cp_pallas(jnp.swapaxes(jnp.asarray(out), -1, -2),
                                         jnp.swapaxes(jnp.asarray(tgt), -1, -2)))
    assert got.shape == (3, 7, N_ART)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(got, kernel, rtol=0, atol=1e-6)
    point_major = distances.mean_p2cp(torch.from_numpy(out).transpose(-1, -2),
                                      torch.from_numpy(tgt).transpose(-1, -2)).numpy()
    np.testing.assert_array_equal(point_major, got)
    pairwise = distances.pairwise_distances(torch.from_numpy(out[0, 0, 0].T),
                                            torch.from_numpy(tgt[0, 0, 0].T)).numpy()
    np.testing.assert_allclose(pairwise, np.asarray(jax_distances.pairwise_distances(
        jnp.asarray(out[0, 0, 0].T), jnp.asarray(tgt[0, 0, 0].T))), rtol=0, atol=1e-6)


@pytest.mark.parametrize("reduce", [True, False])
def test_p2cp_distance_mm_matches_jax(reduce):
    out, tgt, lengths = _contours(1)
    got = losses.p2cp_distance_mm(torch.from_numpy(out), torch.from_numpy(tgt),
                                  torch.from_numpy(lengths), to_mm=TO_MM, reduce=reduce)
    ref = jax_losses.p2cp_distance_mm(jnp.asarray(out), jnp.asarray(tgt), jnp.asarray(lengths),
                                      to_mm=TO_MM, reduce=reduce)
    got, ref = (got, ref) if not reduce else ((got,), (ref,))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6, atol=1e-6)


def test_euclidean_loss_and_metric_match_jax():
    out, tgt, lengths = _contours(2)
    t = torch.from_numpy
    np.testing.assert_allclose(
        losses.masked_euclidean_loss(t(out), t(tgt), t(lengths)).numpy(),
        np.asarray(jax_losses.masked_euclidean_loss(out, tgt, lengths)), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(
        losses.euclidean_distance_mm(t(out), t(tgt), t(lengths), TO_MM).numpy(),
        np.asarray(jax_losses.euclidean_distance_mm(out, tgt, lengths, TO_MM)),
        rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(distances.euclidean_distance(t(out), t(tgt)).numpy(),
                               np.asarray(jax_distances.euclidean_distance(out, tgt)),
                               rtol=0, atol=1e-6)


# (d), (e) train and eval steps against JAX ---------------------------------

def _batch(seed=0, b=4, t=16):
    rng = np.random.default_rng(seed)
    lengths = np.array([t, 11, 5, 9], np.int32)[:b]
    return {"tokens": rng.integers(0, VOCAB, (b, t)).astype(np.int32),
            "targets": rng.random((b, t, N_ART, 2, 50)).astype(np.float32),
            "lengths": lengths}


@pytest.fixture(scope="module")
def jax_run():
    """Three JAX train steps from one init; the gradients of the first."""
    batch = _batch()
    model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                         hidden_size=HIDDEN)
    st = jax_state.create_train_state(model, jax.random.PRNGKey(0),
                                      (batch["tokens"], batch["lengths"]), LR, WD)
    params0 = jax.tree_util.tree_map(np.array, st.params)

    def loss_fn(params):
        outputs = model.apply({"params": params}, batch["tokens"], batch["lengths"])
        return jax_losses.masked_euclidean_loss(outputs, batch["targets"], batch["lengths"])

    grads = jax.tree_util.tree_map(np.array, jax.jit(jax.grad(loss_fn))(st.params))
    train_step = jax_step.make_artspeech_train_step(TO_MM, donate=False, with_p2cp=True)
    eval_metrics, _ = jax_step.make_artspeech_eval_step(TO_MM)(st, batch)
    step_metrics = []
    for i in range(3):
        st, metrics = train_step(st, batch, jax.random.PRNGKey(i))
        step_metrics.append({k: float(v) for k, v in metrics.items()})
    return {"batch": batch, "params0": params0, "grads": grads, "steps": step_metrics,
            "params3": jax.tree_util.tree_map(np.array, st.params),
            "eval": {k: float(v) for k, v in eval_metrics.items()}}


def _port_state(params):
    model = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    model.load_state_dict(artspeech_state_dict_from_flax(params))
    return state.create_train_state(model, LR, WD)


def test_train_step_matches_jax(jax_run):
    st = _port_state(jax_run["params0"])
    step = make_artspeech_train_step(TO_MM, with_p2cp=True, device="cpu")
    metrics = step(st, jax_run["batch"])
    # The converter maps a JAX gradient tree as it maps params.
    ref_grads = artspeech_state_dict_from_flax(jax_run["grads"])
    grads = {n: p.grad for n, p in st.model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert _rel_err(g.numpy(), ref_grads[name].numpy()) <= 1e-5, name
    losses_got = [metrics["loss"].item()] + [step(st, jax_run["batch"])["loss"].item()
                                             for _ in range(2)]
    for got, ref in zip(losses_got, jax_run["steps"]):
        assert abs(got - ref["loss"]) <= 1e-5 * abs(ref["loss"])
    np.testing.assert_allclose(metrics["p2cp_mm"].item(), jax_run["steps"][0]["p2cp_mm"],
                               rtol=1e-5)
    assert st.step == 3
    ref_params = artspeech_state_dict_from_flax(jax_run["params3"])
    for name, p in st.model.state_dict().items():
        assert np.abs(p.numpy() - ref_params[name].numpy()).max() <= 3 * LR, name


def test_eval_step_matches_jax(jax_run):
    st = _port_state(jax_run["params0"])
    st.model.train()
    metrics, outputs = make_artspeech_eval_step(TO_MM, device="cpu")(st, jax_run["batch"])
    assert not st.model.training and outputs.shape == (4, 16, N_ART, 2, 50)
    for key in ("loss", "p2cp_mm"):
        np.testing.assert_allclose(metrics[key].item(), jax_run["eval"][key], rtol=1e-5)


# (f) dropout ----------------------------------------------------------------

def test_dropout_is_seeded_and_train_only():
    tokens = torch.from_numpy(_batch()["tokens"])
    lengths = torch.from_numpy(_batch()["lengths"])
    model = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, dropout=0.5,
                      device="cpu")
    with torch.no_grad():
        plain = model(tokens, lengths)
        model.train()
        a = model(tokens, lengths, torch.Generator().manual_seed(1))
        b = model(tokens, lengths, torch.Generator().manual_seed(1))
        c = model(tokens, lengths, torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            model(tokens, lengths)
        model.eval()
        again = model(tokens, lengths, torch.Generator().manual_seed(3))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c) and not torch.equal(a, plain)
    torch.testing.assert_close(again, plain, rtol=0, atol=0)

    simple = SimpleArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, dropout=0.5,
                             device="cpu").train()
    with torch.no_grad():
        s1 = simple(tokens, lengths, torch.Generator().manual_seed(1))
        s2 = simple(tokens, lengths, torch.Generator().manual_seed(1))
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_keep_rate_and_scale(rate):
    n = 200_000
    out = apply_dropout(torch.ones(n, 2), rate, torch.Generator().manual_seed(0))
    kept = (out != 0).float().mean().item()
    sigma = (rate * (1 - rate) / (2 * n)) ** 0.5
    assert abs(kept - (1 - rate)) <= 3 * sigma
    torch.testing.assert_close(out[out != 0], torch.full_like(out[out != 0], 1 / (1 - rate)))


# (g) fit, checkpoints, scheduler and stopper --------------------------------

class _Corpus:
    """Seeded in-memory sentences with the ArtSpeechDataset item interface."""

    def __init__(self, n, seed):
        rng = np.random.default_rng(seed)
        self.data = []
        for i, length in enumerate(rng.integers(5, 30, n)):
            self.data.append({
                "sentence_name": f"S{i:02d}",
                "tokens": rng.integers(0, VOCAB, length).astype(np.int32),
                "targets": rng.random((length, N_ART, 2, 50)).astype(np.float32),
                "phonemes": ["p"] * length, "references": np.zeros((length, 1, 2, 50), np.float32),
                "critical_masks": np.zeros((0, length), np.int32), "frame_ids": list(range(length)),
                "voicing": np.zeros(length, np.float32), "length": int(length)})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        return self.data[index]


def _fit(tmp_path, n_epochs, model_seed=0, **kwargs):
    model = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, dropout=0.1,
                      generator=torch.Generator().manual_seed(model_seed), device="cpu")
    st = state.create_train_state(model, LR, WD)
    train = BucketedLoader(_Corpus(6, seed=0), batch_size=4, buckets=(16, 32), seed=0)
    valid = BucketedLoader(_Corpus(3, seed=1), batch_size=4, buckets=(16, 32), shuffle=False)
    return loop.fit(st, train, valid, make_artspeech_train_step(TO_MM, device="cpu"),
                    make_artspeech_eval_step(TO_MM, device="cpu"), n_epochs, str(tmp_path),
                    device="cpu", **kwargs)


def test_fit_writes_checkpoints_and_resumes(tmp_path):
    result = _fit(tmp_path, 2)
    assert [r["epoch"] for r in result.history] == [0, 1]
    assert set(result.history[0]) == {"epoch", "lr", "train_loss", "train_manual_spmd",
                                      "valid_loss", "valid_p2cp_mm", "best"}
    for record in result.history:
        assert all(np.isfinite(v) for k, v in record.items() if k != "best")
        assert record["lr"] == LR
    assert result.last_epoch == 1 and result.state.step > 0
    assert result.best_metric == min(r["valid_p2cp_mm"] for r in result.history)
    for sub in ("best/state.pt", "best/aux.json", "last/state.pt", "last/aux.json", "best_model"):
        assert os.path.isfile(tmp_path / sub), sub
    final = {k: v.clone() for k, v in result.state.model.state_dict().items()}

    resumed = _fit(tmp_path, 2, model_seed=9, resume=True)  # restores last/, no epoch left
    assert resumed.history == [] and resumed.last_epoch == 1
    assert resumed.state.step == result.state.step
    for name, value in resumed.state.model.state_dict().items():
        torch.testing.assert_close(value, final[name], rtol=0, atol=0, msg=name)
    more = _fit(tmp_path, 3, model_seed=9, resume=True)
    assert [r["epoch"] for r in more.history] == [2]

    best = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    best.load_state_dict(checkpoint.load_params(str(tmp_path / "best_model")))
    best.load_state_dict(checkpoint.load_params(str(tmp_path / "best")))
    with pytest.raises(FileNotFoundError):
        _fit(tmp_path / "other", 1, resume_from=str(tmp_path / "nowhere"))


def test_checkpoint_round_trip_restores_optimizer(tmp_path):
    st = _port_state(jax.tree_util.tree_map(np.array, _init_params()))
    step = make_artspeech_train_step(TO_MM, device="cpu")
    step(st, _batch())
    checkpoint.save_checkpoint(str(tmp_path), st, aux={"epoch": 4})
    other = _port_state(jax.tree_util.tree_map(np.array, _init_params(seed=1)))
    other, aux = checkpoint.restore_checkpoint(str(tmp_path), other)
    assert aux == {"epoch": 4} and other.step == 1
    for name, value in st.model.state_dict().items():
        torch.testing.assert_close(other.model.state_dict()[name], value, rtol=0, atol=0)
    step(st, _batch(1))
    step(other, _batch(1))
    for name, value in st.model.state_dict().items():
        torch.testing.assert_close(other.model.state_dict()[name], value, rtol=0, atol=0)


def _init_params(seed=0):
    batch = _batch()
    model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                         hidden_size=HIDDEN)
    return jax.jit(model.init)(jax.random.PRNGKey(seed), batch["tokens"],
                               batch["lengths"])["params"]


def test_scheduler_and_stopper_follow_jax():
    metrics = [5.0, 4.0, 4.5, 4.2, 4.1, 4.3, 3.9, 4.0, 4.0, 4.0, 4.0]
    jax_tx = optax.inject_hyperparams(optax.adamw)(learning_rate=1.0, weight_decay=0.0)
    jst = flax_train_state.TrainState.create(apply_fn=None, params={"w": jnp.zeros(1)},
                                             tx=jax_tx)
    jsched, jstop = jax_state.PlateauScheduler(patience=2), jax_state.EarlyStopping(patience=3)
    pst = state.create_train_state(torch.nn.Linear(1, 1), 1.0)
    psched, pstop = state.PlateauScheduler(patience=2), state.EarlyStopping(patience=3)
    for m in metrics:
        jst = jsched.step(m, jst)
        pst = psched.step(m, pst)
        assert pstop.update(m) == jstop.update(m)
        assert state.get_learning_rate(pst) == pytest.approx(jax_state.get_learning_rate(jst))
        assert (psched.best, psched.bad_epochs) == (jsched.best, jsched.bad_epochs)
        assert (pstop.best_metric, pstop.epochs_since_best, pstop.should_stop) == \
            (jstop.best_metric, jstop.epochs_since_best, jstop.should_stop)
    assert state.get_learning_rate(pst) < 1.0 and pstop.should_stop
    assert state.count_parameters(torch.nn.Linear(3, 2)) == 8
