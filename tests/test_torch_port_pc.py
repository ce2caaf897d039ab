"""The port's autoencoder-based method (phonemes -> principal components)
against the JAX package's.

Same numpy-seeded inputs through both packages at narrow widths (3
articulators of 10 points, latent 7, hidden 16), weights carried across by
``utils/convert.py``:
- ``MultiArticulatorAutoencoder`` (AE and PCA), including overlapping latent
  slots whose max-merge ties split the gradient evenly, within 1e-5;
- ``fit_pca`` (eigenvectors up to a sign: the SVD's choice) and the
  composite loss pieces;
- the latent RNN with GRU and LSTM, and its synthesis forward, within 1e-5;
- ``make_autoencoder_loss`` with the critical loss on, and with the
  recognizer term of a frozen DeepSpeech2 (``beta4``): value within 1e-5,
  gradients by the predicted latents within 1e-4 * max(|ref|, 1);
- one latent-RNN and one autoencoder train step (AdamW) and their eval
  steps: loss, gradients and metrics within 1e-5 (gradients relative to
  max(|ref|, 1)), updated parameters within 3 * lr of JAX's after three steps.
The flax models are initialised once per file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.losses import autoencoder as jax_losses
from artspeech_tpu.models import autoencoder as jax_ae
from artspeech_tpu.models import latent_rnn as jax_latent
from artspeech_tpu.models.deepspeech2 import DeepSpeech2 as JaxDeepSpeech2
from artspeech_tpu.ops.pca import fit_pca as jax_fit_pca
from artspeech_tpu.train import pc_step as jax_pc_step
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.eval.autoencoder import nomograms as jax_nomograms
from artspeech_tpu_torch.eval.autoencoder import nomograms
from artspeech_tpu_torch.losses import autoencoder as losses
from artspeech_tpu_torch.models.autoencoder import (
    MultiArticulatorAutoencoder,
    MultiDecoder,
    MultiEncoder,
    latent_size_of,
    normalize_indices_dict,
)
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2, frozen_recognizer_fn
from artspeech_tpu_torch.models.latent_rnn import (
    PrincipalComponentsArtSpeech,
    make_latent_rnn_synthesis_forward,
)
from artspeech_tpu_torch.ops.pca import fit_pca
from artspeech_tpu_torch.train import pc_step
from artspeech_tpu_torch.train.state import create_train_state
from artspeech_tpu_torch.utils.convert import (
    autoencoder_state_dict_from_flax,
    deepspeech2_state_dict_from_flax,
    latent_rnn_state_dict_from_flax,
)
from artspeech_tpu_torch.utils.io import make_indices_dict

INDICES = {"lower-lip": 2, "tongue": 3, "upper-lip": 2}
ARTS = sorted(INDICES)
N_SAMPLES = 10
IN_F = 2 * N_SAMPLES
HIDDEN_F = 8
LATENT = 7
VOCAB, EMBED, HIDDEN = 11, 8, 16
B, T = 3, 8
LR, WD = 1e-3, 1e-5
TO_MM = 136 * 1.6176470518112
TVS = ["LA", "TTCD"]
TOL = 1e-5


def _rel_err(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _stats(seed=20):
    rng = np.random.default_rng(seed)
    mean = rng.uniform(0.3, 0.7, (len(ARTS), 2, N_SAMPLES)).astype(np.float32)
    std = rng.uniform(0.05, 0.2, (len(ARTS), 2, N_SAMPLES)).astype(np.float32)
    return mean, std


def _batch(seed=21):
    rng = np.random.default_rng(seed)
    critical = rng.integers(0, 2, (B, len(TVS), T)).astype(np.int32)
    return {"tokens": rng.integers(0, VOCAB, (B, T)).astype(np.int32),
            "targets": rng.standard_normal((B, T, len(ARTS), 2, N_SAMPLES)).astype(np.float32),
            "references": rng.uniform(0.0, 1.0, (B, T, 1, 2, N_SAMPLES)).astype(np.float32),
            "critical_masks": critical,
            "lengths": np.array([T, 5, 3], np.int32)}


@pytest.fixture(scope="module")
def flax():
    """One flax init of each model of the family."""
    x = jnp.zeros((1, len(ARTS), IN_F))
    out = {}
    for cls in ("AE", "PCA"):
        model = jax_ae.MultiArticulatorAutoencoder(indices_dict=INDICES, in_features=IN_F,
                                                   hidden_features=HIDDEN_F, encoder_cls=cls,
                                                   decoder_cls=cls)
        out[cls] = (model, _tree(model.init(jax.random.PRNGKey(1), x)["params"]))
    batch = _batch()
    for rnn in ("GRU", "LSTM"):
        model = jax_latent.PrincipalComponentsArtSpeech(
            vocab_size=VOCAB, indices_dict=INDICES, embed_dim=EMBED, hidden_size=HIDDEN, rnn=rnn)
        st = jax_state.create_train_state(model, jax.random.PRNGKey(2),
                                          (batch["tokens"], batch["lengths"]), LR, WD)
        out[rnn] = (model, st)
    return out


def _port_ae(flax, cls):
    model = MultiArticulatorAutoencoder(INDICES, IN_F, HIDDEN_F, cls, cls, device="cpu")
    model.load_state_dict(autoencoder_state_dict_from_flax(flax[cls][1]))
    return model


def _port_rnn(flax, rnn, params=None):
    model = PrincipalComponentsArtSpeech(VOCAB, INDICES, EMBED, HIDDEN, rnn=rnn, device="cpu")
    params = flax[rnn][1].params if params is None else params
    model.load_state_dict(latent_rnn_state_dict_from_flax(_tree(params)))
    return model


def test_indices_dicts_match_jax():
    assert make_indices_dict(INDICES) == jax_ae.normalize_indices_dict(INDICES)
    assert normalize_indices_dict({"a": [2, 0]}) == {"a": [2, 0]}
    assert latent_size_of(normalize_indices_dict(INDICES)) == LATENT


@pytest.mark.parametrize("cls", ["AE", "PCA"])
def test_autoencoder_matches_jax(flax, cls):
    model, params = flax[cls]
    x = np.random.default_rng(3).standard_normal((5, len(ARTS), IN_F)).astype(np.float32)
    recon, latents = model.apply({"params": params}, jnp.asarray(x))
    port = _port_ae(flax, cls)
    got_recon, got_latents = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_latents.detach().numpy(), np.asarray(latents), rtol=0, atol=TOL)
    np.testing.assert_allclose(got_recon.detach().numpy(), np.asarray(recon), rtol=0, atol=TOL)
    # The frozen halves the latent RNN's loss and the generate CLI load on their own.
    enc = MultiEncoder(INDICES, IN_F, HIDDEN_F, cls, device="cpu")
    enc.load_state_dict(autoencoder_state_dict_from_flax(params["encoders"]))
    dec = MultiDecoder(INDICES, IN_F, HIDDEN_F, cls, device="cpu")
    dec.load_state_dict(autoencoder_state_dict_from_flax(params["decoders"]))
    torch.testing.assert_close(torch.tanh(enc(torch.from_numpy(x))), got_latents, rtol=0, atol=0)
    torch.testing.assert_close(dec(got_latents), got_recon, rtol=0, atol=0)


def test_shared_latent_slots_max_merge_matches_jax(monkeypatch):
    """Articulators a and b share slot 1 (a's second component, b's first).
    PCA encoders with integer weights on integer inputs make the two exactly
    equal on the first three rows: JAX's max and torch.amax both split the
    gradient of a tie evenly."""
    shared = {"a": [0, 1], "b": [1, 2]}
    enc = jax_ae.MultiEncoder(indices_dict=shared, in_features=8, encoder_cls="PCA")
    rng = np.random.default_rng(4)
    x = rng.integers(-2, 3, (6, 2, 8)).astype(np.float32)
    x[:3, 1] = x[:3, 0]
    params = _tree(enc.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"])
    ev_a = rng.integers(-1, 2, (2, 8)).astype(np.float32)
    ev_b = np.stack([ev_a[1], rng.integers(-1, 2, 8).astype(np.float32)])
    for name, ev in (("enc_a", ev_a), ("enc_b", ev_b)):
        params[name] = {**params[name], "eigenvectors": ev, "mean": np.zeros(8, np.float32)}
    weights = rng.standard_normal((6, 3)).astype(np.float32)

    def loss(x):
        return jnp.sum(enc.apply({"params": params}, x) * weights)

    ref_z = enc.apply({"params": params}, jnp.asarray(x))
    ref_g = jax.grad(loss)(jnp.asarray(x))
    port = MultiEncoder(shared, 8, encoder_cls="PCA", device="cpu")
    port.load_state_dict(autoencoder_state_dict_from_flax(params))
    xt = torch.from_numpy(x).requires_grad_()
    z = port(xt)
    (z * torch.from_numpy(weights)).sum().backward()
    np.testing.assert_allclose(z.detach().numpy(), np.asarray(ref_z), rtol=0, atol=TOL)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_g), rtol=0, atol=TOL)
    # torch.max(dim) would give each tie's gradient to one articulator only.
    monkeypatch.setattr(torch, "amax", lambda t, dim: torch.max(t, dim=dim).values)
    xt = torch.from_numpy(x).requires_grad_()
    (port(xt) * torch.from_numpy(weights)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(ref_g)).max() > 1e-3


def test_fit_pca_matches_jax():
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((60, IN_F)) @ rng.standard_normal((IN_F, IN_F)) * 0.1
         + rng.standard_normal(IN_F)).astype(np.float32)
    got, ref = fit_pca(x, 4), jax_fit_pca(x, 4)
    np.testing.assert_allclose(got["mean"], ref["mean"], rtol=0, atol=TOL)
    np.testing.assert_allclose(got["eigenvalues"], ref["eigenvalues"], rtol=1e-5)
    signs = np.sign(np.sum(got["eigenvectors"] * ref["eigenvectors"], axis=1))[:, None]
    np.testing.assert_allclose(got["eigenvectors"] * signs, ref["eigenvectors"], rtol=0, atol=1e-4)


@pytest.mark.parametrize("rnn", ["GRU", "LSTM"])
def test_latent_rnn_matches_jax(flax, rnn):
    model, st = flax[rnn]
    batch = _batch(seed=6)
    ref = model.apply({"params": st.params}, batch["tokens"], batch["lengths"])
    port = _port_rnn(flax, rnn)
    got = port(torch.from_numpy(batch["tokens"]).long(), torch.from_numpy(batch["lengths"]))
    assert got.shape == (B, T, LATENT)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=TOL)


def test_latent_rnn_refuses_unknown_rnn():
    with pytest.raises(ValueError, match="rnn must be one of"):
        PrincipalComponentsArtSpeech(VOCAB, INDICES, rnn="RNN", device="cpu")


def _frozen_ae(flax):
    """The AE's halves for the loss: JAX closures and port modules."""
    model, params = flax["AE"]
    enc = jax_ae.MultiEncoder(indices_dict=INDICES, in_features=IN_F, hidden_features=HIDDEN_F)
    dec = jax_ae.MultiDecoder(indices_dict=INDICES, in_features=IN_F, hidden_features=HIDDEN_F)
    jax_fns = (lambda x: jnp.tanh(enc.apply({"params": params["encoders"]}, x)),
               lambda z: dec.apply({"params": params["decoders"]}, z))
    port = _port_ae(flax, "AE").requires_grad_(False)
    return jax_fns, (port.encode, port.decode)


def _losses(flax, mean, std, rescale=1.0):
    (j_enc, j_dec), (p_enc, p_dec) = _frozen_ae(flax)
    kwargs = dict(beta1=0.5, beta2=3.0, beta3=1.0, rescale_factor=rescale)
    ref = jax_losses.make_autoencoder_loss(j_enc, j_dec, TVS, ARTS, denorm_mean=jnp.asarray(mean),
                                           denorm_std=jnp.asarray(std), **kwargs)
    got = losses.make_autoencoder_loss(p_enc, p_dec, TVS, ARTS, denorm_mean=torch.from_numpy(mean),
                                       denorm_std=torch.from_numpy(std), **kwargs)
    return ref, got, j_dec, p_dec


@pytest.mark.parametrize("rescale", [1.0, 12.0])
def test_autoencoder_loss_matches_jax(flax, rescale):
    mean, std = _stats()
    ref_fn, got_fn, _, _ = _losses(flax, mean, std, rescale)
    batch = _batch(seed=7)
    pcs = np.tanh(np.random.default_rng(8).standard_normal((B, T, LATENT))).astype(np.float32)
    args = (batch["targets"], batch["references"], batch["lengths"], batch["critical_masks"])
    ref, ref_g = jax.value_and_grad(lambda p: ref_fn(p, *args))(jnp.asarray(pcs))
    pt = torch.from_numpy(pcs).requires_grad_()
    got = got_fn(pt, *(torch.from_numpy(a) for a in args))
    got.backward()
    crit = float(jax_losses.critical_loss(jnp.asarray(batch["targets"]), batch["references"],
                                          batch["critical_masks"], TVS, ARTS, mean, std))
    assert crit > 0.0
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL)
    assert _rel_err(pt.grad.numpy(), np.asarray(ref_g)) <= 1e-4


def test_critical_loss_and_cov_penalty_match_jax():
    mean, std = _stats(seed=9)
    batch = _batch(seed=10)
    shapes = batch["targets"]
    ref = jax_losses.critical_loss(jnp.asarray(shapes), batch["references"],
                                   batch["critical_masks"], TVS, ARTS, mean, std)
    got = losses.critical_loss(torch.from_numpy(shapes), torch.from_numpy(batch["references"]),
                               torch.from_numpy(batch["critical_masks"]), TVS, ARTS,
                               torch.from_numpy(mean), torch.from_numpy(std))
    np.testing.assert_allclose(got.item(), float(ref), rtol=TOL)
    assert losses.critical_loss(torch.from_numpy(shapes), None, None, [], ARTS).item() == 0.0
    latents = np.random.default_rng(11).standard_normal((9, LATENT)).astype(np.float32)
    weights = np.array([1, 1, 0.1, 3, 1, 1, 1, 0, 0], np.float32)
    outputs = np.random.default_rng(12).standard_normal((9, len(ARTS), IN_F)).astype(np.float32)
    targets = np.random.default_rng(13).standard_normal((9, len(ARTS), IN_F)).astype(np.float32)
    indices = normalize_indices_dict(INDICES)
    for w in (None, weights):
        ref = jax_losses.regularized_latents_mse_loss(outputs, latents, targets, indices, 0.1,
                                                      sample_weights=w)
        got = losses.regularized_latents_mse_loss(
            torch.from_numpy(outputs), torch.from_numpy(latents), torch.from_numpy(targets),
            indices, 0.1, sample_weights=None if w is None else torch.from_numpy(w))
        np.testing.assert_allclose(got.item(), float(ref), rtol=TOL)


def test_recognizer_term_raises(flax):
    """The recognizer term of the loss, which the port once refused
    (``recognizer_fn``, ``beta4 > 0``): a frozen DeepSpeech2 (one flax init,
    narrow) over the decoded and the target contours, with voicing that is
    -1 on padded frames, against JAX's. Value within 1e-5, gradients by the
    predicted latents within 1e-4 * max(|ref|, 1); the term moves both; the
    recognizer's parameters take no gradient."""
    mean, std = _stats(seed=30)
    (j_enc, j_dec), (p_enc, p_dec) = _frozen_ae(flax)
    ds2_kwargs = dict(num_classes=VOCAB, num_features=len(ARTS) * N_SAMPLES,
                      adapter_out_features=6, num_residual_layers=1, conv_channels=4,
                      num_rnn_layers=1, rnn_hidden_size=8, dropout=0.0)
    ds2 = JaxDeepSpeech2(**ds2_kwargs)
    ds2_params = _tree(jax.jit(ds2.init)(jax.random.PRNGKey(5),
                                         jnp.zeros((1, 2, len(ARTS) * N_SAMPLES, 8)))["params"])
    port_ds2 = DeepSpeech2(**ds2_kwargs, device="cpu")
    port_ds2.load_state_dict(deepspeech2_state_dict_from_flax(ds2_params))
    batch = _batch(seed=31)
    pad = np.arange(T)[None, :] >= batch["lengths"][:, None]
    voicing = np.where(pad, np.float32(-1.0),
                       np.random.default_rng(32).integers(0, 2, (B, T)).astype(np.float32))
    pcs = np.tanh(np.random.default_rng(33).standard_normal((B, T, LATENT))).astype(np.float32)
    args = (batch["targets"], batch["references"], batch["lengths"], batch["critical_masks"])
    kwargs = dict(beta1=0.5, beta2=3.0, beta3=1.0, beta4=0.7)
    ref_fn = jax_losses.make_autoencoder_loss(
        j_enc, j_dec, TVS, ARTS, denorm_mean=jnp.asarray(mean), denorm_std=jnp.asarray(std),
        recognizer_fn=lambda s, v: ds2.apply({"params": ds2_params}, s, voicing=v,
                                             return_features=True)[1], **kwargs)
    ref, ref_g = jax.jit(jax.value_and_grad(
        lambda p: ref_fn(p, *args, voicing=jnp.asarray(voicing))))(jnp.asarray(pcs))
    t_args = [torch.from_numpy(a) for a in args]
    results = {}
    for name, rec in (("with", frozen_recognizer_fn(port_ds2)), ("without", None)):
        got_fn = losses.make_autoencoder_loss(
            p_enc, p_dec, TVS, ARTS, denorm_mean=torch.from_numpy(mean),
            denorm_std=torch.from_numpy(std), recognizer_fn=rec, **kwargs)
        pt = torch.from_numpy(pcs).requires_grad_()
        got = got_fn(pt, *t_args, voicing=torch.from_numpy(voicing))
        got.backward()
        results[name] = (got.item(), pt.grad.numpy())
    np.testing.assert_allclose(results["with"][0], float(ref), rtol=TOL)
    assert _rel_err(results["with"][1], np.asarray(ref_g)) <= 1e-4
    assert results["with"][0] - results["without"][0] > 1e-3 * results["with"][0]
    assert _rel_err(results["without"][1], np.asarray(ref_g)) > 1e-3
    assert all(p.grad is None and not p.requires_grad for p in port_ds2.parameters())


def test_synthesis_forward_and_nomograms_match_jax(flax):
    mean, std = _stats(seed=14)
    (_, j_dec), (_, p_dec) = _frozen_ae(flax)
    model, st = flax["LSTM"]
    batch = _batch(seed=15)
    ref = jax_latent.make_latent_rnn_synthesis_forward(
        model, st.params, None, None, jnp.asarray(mean), jnp.asarray(std), rescale_factor=2.0,
        decode_fn=j_dec)(batch["tokens"], batch["lengths"])
    forward = make_latent_rnn_synthesis_forward(_port_rnn(flax, "LSTM"), p_dec,
                                                torch.from_numpy(mean), torch.from_numpy(std),
                                                rescale_factor=2.0)
    with torch.no_grad():
        got = forward(torch.from_numpy(batch["tokens"]).long(), torch.from_numpy(batch["lengths"]))
    assert got.shape == (B, T, len(ARTS), 2, N_SAMPLES)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=TOL)
    ref_noms = jax_nomograms(j_dec, LATENT, normalize_indices_dict(INDICES), mean, std)
    got_noms = nomograms(p_dec, LATENT, mean, std, device="cpu")
    assert sorted(got_noms) == sorted(ref_noms)
    for i, v in ref_noms.items():
        np.testing.assert_allclose(got_noms[i], v, rtol=0, atol=TOL)


@pytest.fixture(scope="module")
def latent_run(flax):
    """Three JAX latent-RNN train steps (LSTM, dropout 0) from the one init,
    the gradients of the first, and the eval step's metrics."""
    mean, std = _stats(seed=16)
    ref_fn, _, j_dec, _ = _losses(flax, mean, std)
    model, st = flax["LSTM"]
    batch = _batch(seed=17)
    params0 = _tree(st.params)

    def loss(params):
        pcs = model.apply({"params": params}, batch["tokens"], batch["lengths"])
        return ref_fn(pcs, batch["targets"], batch["references"], batch["lengths"],
                      batch["critical_masks"])

    grads = _tree(jax.grad(loss)(st.params))
    eval_metrics, _ = jax_pc_step.make_latent_rnn_eval_step(model, ref_fn, j_dec, mean, std,
                                                            TO_MM)(st, batch)
    step = jax_pc_step.make_latent_rnn_train_step(model, ref_fn, j_dec, mean, std, TO_MM,
                                                  donate=False, with_p2cp=True)
    metrics = []
    for i in range(3):
        st, m = step(st, batch, jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"stats": (mean, std), "batch": batch, "params0": params0, "grads": grads,
            "steps": metrics, "params3": _tree(st.params),
            "eval": {k: float(v) for k, v in eval_metrics.items()}}


def test_latent_rnn_train_step_matches_jax(flax, latent_run):
    mean, std = latent_run["stats"]
    _, got_fn, _, p_dec = _losses(flax, mean, std)
    st = create_train_state(_port_rnn(flax, "LSTM", latent_run["params0"]), LR, WD)
    step = pc_step.make_latent_rnn_train_step(got_fn, p_dec, mean, std, TO_MM, with_p2cp=True,
                                              device="cpu")
    metrics = [step(st, latent_run["batch"])]
    ref_grads = latent_rnn_state_dict_from_flax(latent_run["grads"])
    grads = {n: p.grad for n, p in st.model.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, g in grads.items():
        assert _rel_err(g.numpy(), ref_grads[name].numpy()) <= TOL, name
    metrics += [step(st, latent_run["batch"]) for _ in range(2)]
    for got, ref in zip(metrics, latent_run["steps"]):
        for key in ("loss", "p2cp_mm"):
            np.testing.assert_allclose(got[key].item(), ref[key], rtol=TOL)
    ref_params = latent_rnn_state_dict_from_flax(latent_run["params3"])
    for name, p in st.model.state_dict().items():
        assert np.abs(p.numpy() - ref_params[name].numpy()).max() <= 3 * LR, name
    metrics, pcs = pc_step.make_latent_rnn_eval_step(got_fn, p_dec, mean, std, TO_MM,
                                                     device="cpu")(
        create_train_state(_port_rnn(flax, "LSTM", latent_run["params0"]), LR, WD),
        latent_run["batch"])
    assert pcs.shape == (B, T, LATENT)
    for key in ("loss", "p2cp_mm"):
        np.testing.assert_allclose(metrics[key].item(), latent_run["eval"][key], rtol=TOL)


def test_latent_rnn_dropout_is_seeded_and_train_only(flax):
    model = PrincipalComponentsArtSpeech(VOCAB, INDICES, EMBED, HIDDEN, rnn_dropout=0.5,
                                         rnn="LSTM", device="cpu")
    batch = _batch(seed=18)
    tokens, lengths = torch.from_numpy(batch["tokens"]).long(), torch.from_numpy(batch["lengths"])
    with torch.no_grad():
        plain = model(tokens, lengths)
        model.train()
        a = model(tokens, lengths, torch.Generator().manual_seed(1))
        b = model(tokens, lengths, torch.Generator().manual_seed(1))
        with pytest.raises(ValueError, match="Generator"):
            model(tokens, lengths)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, plain)


def test_autoencoder_train_and_eval_steps_match_jax(flax):
    model, params = flax["AE"]
    mean, std = _stats(seed=19)
    rng = np.random.default_rng(22)
    batch = {"inputs": rng.standard_normal((6, len(ARTS), IN_F)).astype(np.float32),
             "weights": np.array([1, 3, 0.1, 1, 0, 0], np.float32)}
    indices = normalize_indices_dict(INDICES)
    from flax.training import train_state as flax_train_state

    from artspeech_tpu.train.state import make_optimizer

    st = flax_train_state.TrainState.create(apply_fn=model.apply, params=params,
                                            tx=make_optimizer(LR, WD))
    eval_ref, _ = jax_pc_step.make_autoencoder_eval_step(model, indices, 0.1, mean, std,
                                                         TO_MM)(st, batch)
    step = jax_pc_step.make_autoencoder_train_step(model, indices, 0.1, mean, std, TO_MM,
                                                   donate=False, with_p2cp=True)
    refs = []
    for _ in range(3):
        st, m = step(st, batch)
        refs.append({k: float(v) for k, v in m.items()})

    port = create_train_state(_port_ae(flax, "AE"), LR, WD)
    eval_got, (recon, latents) = pc_step.make_autoencoder_eval_step(indices, 0.1, mean, std, TO_MM,
                                                                   device="cpu")(port, batch)
    assert recon.shape == (6, len(ARTS), IN_F) and latents.shape == (6, LATENT)
    for key in ("loss", "p2cp_mm"):
        np.testing.assert_allclose(eval_got[key].item(), float(eval_ref[key]), rtol=TOL)
    train_step = pc_step.make_autoencoder_train_step(indices, 0.1, mean, std, TO_MM,
                                                     with_p2cp=True, device="cpu")
    for ref in refs:
        got = train_step(port, batch)
        for key in ("loss", "p2cp_mm"):
            np.testing.assert_allclose(got[key].item(), ref[key], rtol=TOL)
    ref_params = autoencoder_state_dict_from_flax(_tree(st.params))
    for name, p in port.model.state_dict().items():
        assert np.abs(p.numpy() - ref_params[name].numpy()).max() <= 3 * LR, name


def test_normalize_and_articulator_norm_stats_match_jax(tmp_path):
    from artspeech_tpu.data import transforms as jax_transforms
    from artspeech_tpu_torch.data import transforms

    mean, std = _stats(seed=23)
    for i, art in enumerate(ARTS):
        np.save(tmp_path / f"{art}_mean.npy", mean[i].astype(np.float64))
        np.save(tmp_path / f"{art}_std.npy", std[i].astype(np.float64))
    got = transforms.load_articulator_norm_stats(str(tmp_path), ARTS)
    ref = jax_transforms.load_articulator_norm_stats(str(tmp_path), ARTS)
    x = np.random.default_rng(24).uniform(0.0, 1.0, (4, 2, N_SAMPLES)).astype(np.float32)
    for art in ARTS:
        assert got[art].mean.dtype == np.float32
        np.testing.assert_array_equal(got[art](x), ref[art](x))
        back = got[art].inverse(got[art](torch.from_numpy(x)))
        np.testing.assert_allclose(back.numpy(), x, rtol=0, atol=1e-6)
