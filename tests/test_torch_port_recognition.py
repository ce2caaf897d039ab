"""The port's phoneme recognizer (DeepSpeech2, melspec, losses, decoders,
metrics, weight import) against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages at narrow widths (2 and 1
residual layers of 8 channels, 2 and 1 GRU layers of H = 16, D = 20, T = 24,
B = 3 with a ragged row and a row of length 0), weights carried across by
``utils/convert.py``; the flax models are initialised once per file:
- melspec within 1e-5 of the largest value, and against the golden fixture
  at the JAX test's tolerance;
- logits and features with and without the Adapter and the voicing within
  1e-5 (relative to max(|ref|, 1)), gradients within 1e-4 * max(|ref|, 1),
  bf16 within twice flax's own bf16-to-float32 distance;
- both weight converters exactly;
- CTC and CE values and gradients, on feasible and infeasible rows (the CTC
  floors an impossible path at optax's -1e5, not at torch's inf), their
  ``*_parts`` and class weights;
- greedy and both beam decoders: equal ids; the metrics: equal values.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.eval import decoders as jax_decoders
from artspeech_tpu.eval import recognition_metrics as jax_metrics
from artspeech_tpu.losses import recognition as jax_losses
from artspeech_tpu.models.deepspeech2 import DeepSpeech2 as JaxDeepSpeech2
from artspeech_tpu.ops import melspec as jax_melspec
from artspeech_tpu.utils import torch_import as jax_import
from artspeech_tpu_torch.eval import decoders, recognition_metrics as metrics
from artspeech_tpu_torch.losses import recognition as losses
from artspeech_tpu_torch.models.deepspeech2 import DeepSpeech2, get_noise_logits, \
    get_normalized_outputs
from artspeech_tpu_torch.ops import melspec
from artspeech_tpu_torch.utils import torch_import
from artspeech_tpu_torch.utils.convert import deepspeech2_state_dict_from_flax

B, T, D, C, H, K = 3, 24, 20, 8, 16, 7
LENGTHS = np.array([T, 13, 0], np.int32)
WIDE = dict(num_residual_layers=2, num_rnn_layers=2, rnn_hidden_size=H, num_classes=K,
            num_features=D, conv_channels=C, adapter_out_features=12)
NARROW = dict(num_residual_layers=1, num_rnn_layers=1, rnn_hidden_size=H, num_classes=K,
              num_features=D, conv_channels=C)
TOL = 1e-5
GRAD_TOL = 1e-4
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "melspec_golden.npz")


def _rel_err(got, ref):
    got = np.asarray(got.detach().float() if isinstance(got, torch.Tensor) else got, np.float64)
    ref = np.asarray(ref, np.float64)
    return np.abs(got - ref).max() / max(np.abs(ref).max(), 1.0)


def _tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, 2, D, T)).astype(np.float32)
    x = np.where(LENGTHS[:, None, None, None] <= np.arange(T), np.float32(-1.0), x)  # padding
    voicing = rng.integers(0, 2, (B, T)).astype(np.float32)
    return x, voicing


@pytest.fixture(scope="module")
def models():
    """Both flax models initialised once, and the port's with their weights."""
    out = {}
    x, _ = _inputs()
    for name, kwargs in (("wide", WIDE), ("narrow", NARROW)):
        jax_model = JaxDeepSpeech2(**kwargs)
        params = _tree(jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x),
                                      lengths=jnp.asarray(LENGTHS))["params"])
        model = DeepSpeech2(**kwargs, device="cpu")
        model.load_state_dict(deepspeech2_state_dict_from_flax(params))
        out[name] = (jax_model, params, model)
    return out


# ---------- melspec ----------


def test_melspec_matches_golden_fixture_and_jax():
    z = np.load(FIXTURE)
    kwargs = dict(sample_rate=int(z["sample_rate"]), n_fft=int(z["n_fft"]),
                  hop_length=int(z["hop_length"]), n_mels=int(z["n_mels"]))
    ours = melspec.melspectrogram(torch.from_numpy(z["audio"]), **kwargs)
    np.testing.assert_allclose(ours.numpy(), z["mel"], rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(melspec.dynamic_range_compression(ours).numpy(),
                               np.log(np.maximum(z["mel"], 1e-5)), rtol=1e-3, atol=1e-3)
    ref = np.asarray(jax_melspec.melspectrogram(jnp.asarray(z["audio"]), **kwargs))
    assert ours.shape == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= TOL * np.abs(ref).max()


@pytest.mark.parametrize("n_fft,hop,win", [(64, 16, None), (64, 24, 48)])
def test_melspec_framing_matches_jax(n_fft, hop, win):
    """Batched audio; a hop that divides n_fft (JAX's static slices) and one
    that does not (its gather), with a window shorter than n_fft."""
    audio = np.random.default_rng(3).normal(size=(2, 3, 700)).astype(np.float32)
    kwargs = dict(n_fft=n_fft, hop_length=hop, win_length=win, n_mels=10, sample_rate=8000)
    frames = melspec.frame_signal(torch.from_numpy(audio), n_fft, hop)
    assert np.array_equal(frames.numpy(),
                          np.asarray(jax_melspec.frame_signal(jnp.asarray(audio), n_fft, hop)))
    ours = melspec.melspectrogram(torch.from_numpy(audio), **kwargs).numpy()
    ref = np.asarray(jax_melspec.melspectrogram(jnp.asarray(audio), **kwargs))
    assert ours.shape == ref.shape == (2, 3, 10, 1 + 700 // hop)
    assert np.abs(ours - ref).max() <= TOL * np.abs(ref).max()
    assert np.array_equal(melspec.mel_filterbank(10, 33, 8000), jax_melspec.mel_filterbank(10, 33, 8000))
    assert np.array_equal(melspec.dft_basis(n_fft), jax_melspec.dft_basis(n_fft))


# ---------- DeepSpeech2 ----------


@pytest.mark.parametrize("which", ["wide", "narrow"])
@pytest.mark.parametrize("with_voicing", [False, True])
def test_deepspeech2_forward_matches_jax(models, which, with_voicing):
    jax_model, params, model = models[which]
    x, voicing = _inputs(seed=5)
    v = voicing if with_voicing else None
    ref_logits, ref_feats = jax_model.apply(
        {"params": params}, jnp.asarray(x), voicing=None if v is None else jnp.asarray(v),
        lengths=jnp.asarray(LENGTHS), return_features=True)
    with torch.no_grad():
        logits, feats = model(torch.from_numpy(x), None if v is None else torch.from_numpy(v),
                              torch.from_numpy(LENGTHS), return_features=True)
    assert logits.shape == (B, T, K) and feats.shape == (B, T, H)
    assert _rel_err(logits, ref_logits) <= TOL
    assert _rel_err(feats, ref_feats) <= TOL
    probs = get_normalized_outputs(logits)
    assert _rel_err(probs, jax.nn.softmax(ref_logits, axis=-1)) <= TOL
    assert _rel_err(get_normalized_outputs(logits, use_log_prob=True),
                    jax.nn.log_softmax(ref_logits, axis=-1)) <= TOL


def test_deepspeech2_gradients_match_jax(models):
    """Gradients of a weighted sum of the valid frames' logits, with voicing,
    through every layer of the model with the Adapter, within 1e-4 *
    max(|ref|, 1) of JAX's. The conv stem's bias is the exception: every
    LayerNorm over D cancels a shift along D, so its gradient is a sum that
    cancels to the residual path's share, and JAX's own float32 parts from
    float64 there by ~5e-4 (5.6e-4 read on the CPU). That distance, JAX's
    float32 from the port's float64, is capped at 2e-3 (a zeroed or detached
    port gradient parts from JAX's by ~0.6), and the port's float32 is held
    within twice it of both the port's float64 and JAX's."""
    jax_model, params, model = models["wide"]
    x, voicing = _inputs(seed=7)
    w = np.random.default_rng(8).normal(size=(B, T, K)).astype(np.float32)
    w[LENGTHS[:, None] <= np.arange(T)] = 0.0

    def jax_loss(p):
        out = jax_model.apply({"params": p}, jnp.asarray(x), voicing=jnp.asarray(voicing),
                              lengths=jnp.asarray(LENGTHS))
        return jnp.sum(out * w)

    # Eager, not jitted: XLA's fusion rounds the Adapter LayerNorm's variance
    # on the padded (constant) rows otherwise, which its 1/sqrt(eps) gradient
    # there turns into 1 % on the Adapter's biases.
    ref = deepspeech2_state_dict_from_flax(_tree(jax.grad(jax_loss)(params)))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        port = DeepSpeech2(**WIDE, device="cpu")
        port.load_state_dict(model.state_dict())
        port.to(dtype)
        out = port(torch.from_numpy(x).to(dtype), torch.from_numpy(voicing).to(dtype),
                   torch.from_numpy(LENGTHS))
        (out * torch.from_numpy(w).to(dtype)).sum().backward()
        grads[dtype] = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads[torch.float32]) == set(ref)
    exact = grads[torch.float64]
    errs = {n: _rel_err(g, ref[n]) for n, g in grads[torch.float32].items() if n != "conv.bias"}
    assert max(errs.values()) <= GRAD_TOL, sorted(errs.items(), key=lambda kv: -kv[1])[:4]
    jax_distance = _rel_err(ref["conv.bias"], exact["conv.bias"])
    assert jax_distance <= 2e-3
    assert _rel_err(grads[torch.float32]["conv.bias"], exact["conv.bias"]) <= 2 * jax_distance
    assert _rel_err(grads[torch.float32]["conv.bias"], ref["conv.bias"]) <= 2 * jax_distance


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_deepspeech2_bf16_within_twice_flax_bf16_distance(models, dtype):
    """16-bit compute (bf16, and fp16 under the same name), float32
    parameters: the port's logits part from flax's at that dtype by at most
    twice what flax's part from its float32."""
    jax_model, params, _ = models["wide"]
    x, voicing = _inputs(seed=9)
    kwargs = dict(voicing=jnp.asarray(voicing), lengths=jnp.asarray(LENGTHS))
    f32 = np.asarray(jax_model.apply({"params": params}, jnp.asarray(x), **kwargs))
    jax_half = JaxDeepSpeech2(**WIDE, dtype=getattr(jnp, dtype))
    ref = np.asarray(jax_half.apply({"params": params}, jnp.asarray(x), **kwargs), np.float32)
    model = DeepSpeech2(**WIDE, dtype=getattr(torch, dtype), device="cpu")
    model.load_state_dict(deepspeech2_state_dict_from_flax(params))
    with torch.no_grad():
        got = model(torch.from_numpy(x), torch.from_numpy(voicing), torch.from_numpy(LENGTHS))
    assert got.dtype == getattr(torch, dtype)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    flax_distance = np.abs(ref - f32).max()
    assert 0 < flax_distance < 0.5
    assert np.abs(got.float().numpy() - ref).max() <= 2 * flax_distance


def test_noise_logits_draw_from_the_generator():
    logits = torch.zeros(2, 5, 3)
    a = get_noise_logits(logits, 0.5, torch.Generator().manual_seed(4))
    b = get_noise_logits(logits, 0.5, torch.Generator().manual_seed(4))
    assert torch.equal(a, b) and 0.2 < a.std().item() < 0.8


# ---------- weight converters ----------


def _reference_state_dict(adapter: bool, n_res: int, n_rnn: int, d: int, c: int, h: int,
                          k: int, seed: int = 11):
    """A reference DeepSpeech2 torch state dict (the key names and shapes
    JAX utils/torch_import.py:140-182 reads), seeded."""
    rng = np.random.default_rng(seed)
    sd = {}

    def put(name, *shape):
        sd[name] = rng.normal(size=shape).astype(np.float32)

    if adapter:
        for i, (shape) in ((0, (d,)), (2, (12,))):
            put(f"adapter.adapter.{i}.weight", *shape)
            put(f"adapter.adapter.{i}.bias", *shape)
        put("adapter.adapter.1.weight", 12, d)
        put("adapter.adapter.1.bias", 12)
        put("adapter.adapter.3.weight", 12, 12)
        put("adapter.adapter.3.bias", 12)
        d = 12
    put("cnn.weight", c, 2, 3, 3)
    put("cnn.bias", c)
    for i in range(n_res):
        for j in (1, 2):
            put(f"residual_layers.{i}.layer_norm{j}.weight", d)
            put(f"residual_layers.{i}.layer_norm{j}.bias", d)
            put(f"residual_layers.{i}.cnn{j}.weight", c, c, 3, 3)
            put(f"residual_layers.{i}.cnn{j}.bias", c)
    put("linear.weight", h, c * d)
    put("linear.bias", h)
    for i in range(n_rnn):
        put(f"recurrent_layers.{i}.layer_norm.weight", h)
        put(f"recurrent_layers.{i}.layer_norm.bias", h)
        for kind in ("ih", "hh"):
            put(f"recurrent_layers.{i}.rnn.weight_{kind}_l0", 3 * h, h)
            put(f"recurrent_layers.{i}.rnn.bias_{kind}_l0", 3 * h)
    put("feature_extractor.0.weight", h, h)
    put("feature_extractor.0.bias", h)
    put("classifier.weight", k, h)
    put("classifier.bias", k)
    return sd


def test_flax_converter_is_exact(models):
    """Every flax leaf lands in the port unchanged (Dense kernels transposed)."""
    _, params, model = models["wide"]
    sd = model.state_dict()
    assert np.array_equal(sd["conv.kernel"].numpy(), params["Conv_0"]["kernel"])
    assert np.array_equal(sd["residual.1.norm1.scale"].numpy(),
                          params["ResidualCNN_1"]["LayerNorm_1"]["scale"])
    assert np.array_equal(sd["dense.weight"].numpy(), params["Dense_0"]["kernel"].T)
    assert np.array_equal(sd["recurrent.1.gru.layers.0.wh"].numpy(),
                          params["RecurrentBlock_1"]["GRUStack_0"]["GRULayer_0"]["wh"])
    n_leaves = len(jax.tree_util.tree_leaves(params))
    assert len(deepspeech2_state_dict_from_flax(params)) == n_leaves == len(sd)


@pytest.mark.parametrize("adapter", [False, True])
def test_reference_import_matches_jax(adapter, models, tmp_path):
    """A reference torch state dict -> the port equals JAX's import -> the
    port, the classifier dropped when asked; and the loaded models agree."""
    kwargs = WIDE if adapter else NARROW
    n_res, n_rnn = kwargs["num_residual_layers"], kwargs["num_rnn_layers"]
    sd = _reference_state_dict(adapter, n_res, n_rnn, D, C, H, K)
    ours = torch_import.convert_deepspeech2_state_dict(sd, n_res, n_rnn, conv_channels=C)
    ref = deepspeech2_state_dict_from_flax(
        jax_import.convert_deepspeech2_state_dict(sd, n_res, n_rnn, conv_channels=C))
    assert set(ours) == set(ref)
    assert all(torch.equal(ours[n], ref[n]) for n in ref)
    skipped = torch_import.convert_deepspeech2_state_dict(sd, n_res, n_rnn, conv_channels=C,
                                                          skip_classifier=True)
    assert set(ours) - set(skipped) == {"classifier.weight", "classifier.bias"}
    # The imported weights compute JAX's function on the imported params.
    jax_model = models["wide" if adapter else "narrow"][0]
    model = DeepSpeech2(**kwargs, device="cpu")
    model.load_state_dict(ours)
    flax_params = jax_import.convert_deepspeech2_state_dict(sd, n_res, n_rnn, conv_channels=C)
    x, voicing = _inputs(seed=12)
    ref_logits = jax_model.apply({"params": flax_params}, jnp.asarray(x),
                                 lengths=jnp.asarray(LENGTHS))
    with torch.no_grad():
        logits = model(torch.from_numpy(x), lengths=torch.from_numpy(LENGTHS))
    assert _rel_err(logits, ref_logits) <= TOL
    # load_torch_state_dict reads a .pt back as numpy.
    path = tmp_path / "ref.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    back = torch_import.load_torch_state_dict(str(path))
    assert set(back) == set(sd) and all(np.array_equal(back[k], sd[k]) for k in sd)


def test_load_librispeech_deepspeech2(tmp_path):
    """The LibriSpeech architecture (5 residual, 3 GRU layers, H = 128, 32
    channels) with the file's weights; a new vocabulary keeps a fresh
    classifier, the file's own size takes the file's."""
    sd = _reference_state_dict(False, 5, 3, D, 32, 128, 31, seed=13)
    path = tmp_path / "librispeech.pt"
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    converted = torch_import.convert_deepspeech2_state_dict(sd, 5, 3)
    same = torch_import.load_librispeech_deepspeech2(str(path), num_classes=31, num_features=D,
                                                     device="cpu")
    assert all(torch.equal(same.state_dict()[n], v) for n, v in converted.items())
    fresh = torch_import.load_librispeech_deepspeech2(str(path), num_classes=9, num_features=D,
                                                      device="cpu")
    state = fresh.state_dict()
    assert state["classifier.weight"].shape == (9, 128)
    assert all(torch.equal(state[n], v) for n, v in converted.items() if "classifier" not in n)


# ---------- losses ----------


def _ctc_inputs(seed=0):
    """Log-probs (B=4, T=12, K=7); rows: feasible, feasible with repeats,
    infeasible (6 labels over 4 frames), and a padding row (length 0)."""
    rng = np.random.default_rng(seed)
    logits = rng.normal(size=(4, 12, K)).astype(np.float32)
    targets = np.full((4, 12), -1, np.int32)
    targets[0, :5] = [1, 2, 3, 4, 5]
    targets[1, :4] = [2, 2, 3, 3]
    targets[2, :6] = [1, 2, 3, 4, 5, 6]
    input_lengths = np.array([12, 10, 4, 0], np.int32)
    target_lengths = np.array([5, 4, 6, 0], np.int32)
    return logits, targets, input_lengths, target_lengths


def test_ctc_matches_jax_on_feasible_and_infeasible_rows():
    logits, targets, il, tl = _ctc_inputs()

    def jax_fn(lg):
        return jax_losses.ctc_loss(jax.nn.log_softmax(lg, axis=-1), jnp.asarray(targets),
                                   jnp.asarray(il), jnp.asarray(tl))

    ref, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    grads = {}
    for dtype in (torch.float32, torch.float64):
        lg = torch.from_numpy(logits).to(dtype).requires_grad_()
        loss = losses.ctc_loss(torch.log_softmax(lg, -1), torch.from_numpy(targets),
                               torch.from_numpy(il), torch.from_numpy(tl))
        loss.backward()
        grads[dtype] = lg.grad
        if dtype == torch.float32:
            got = loss
    # The infeasible row costs ~1e5 / 6, as in JAX (not 0): ~5.6e3 over 3 rows.
    assert float(ref) > 5e3
    assert abs(got.item() - float(ref)) <= TOL * abs(float(ref))
    ref_grad = np.asarray(ref_grad)
    assert _rel_err(grads[torch.float32][[0, 1, 3]], ref_grad[[0, 1, 3]]) <= GRAD_TOL
    # On the infeasible row the alphas sit near -1e5, where a float32 step is
    # 2^-7: JAX's own gradient there parts from the port's float64 by ~2e-4
    # (2.4e-4 read on the CPU). Cap that distance at 1e-3 (a zeroed or
    # detached gradient, as torch's zero_infinity gives, parts by ~3e-2) and
    # hold the port's float32 within twice it of its float64 and of JAX's.
    exact = grads[torch.float64][2]
    jax_distance = _rel_err(ref_grad[2], exact)
    assert jax_distance <= 1e-3
    assert _rel_err(grads[torch.float32][2], exact) <= 2 * jax_distance
    assert _rel_err(grads[torch.float32][2], ref_grad[2]) <= 2 * jax_distance
    per_seq = losses.ctc_per_sequence(
        torch.log_softmax(torch.from_numpy(logits), -1),
        1.0 - (torch.arange(12)[None] < torch.from_numpy(il)[:, None]).float(),
        torch.from_numpy(np.maximum(targets, 0)),
        1.0 - (torch.arange(12)[None] < torch.from_numpy(tl)[:, None]).float())
    assert 9e4 < per_seq[2].item() < 1.1e5
    # torch's CTC is the yardstick on the feasible rows only.
    feasible = slice(0, 2)
    yard = torch.nn.CTCLoss(blank=0, zero_infinity=True)(
        torch.log_softmax(torch.from_numpy(logits[feasible]), -1).transpose(0, 1),
        torch.from_numpy(targets[feasible].clip(0).astype(np.int64)),
        torch.from_numpy(il[feasible].astype(np.int64)),
        torch.from_numpy(tl[feasible].astype(np.int64)))
    ours_feasible = losses.ctc_loss(torch.log_softmax(torch.from_numpy(logits[feasible]), -1),
                                    torch.from_numpy(targets[feasible]),
                                    torch.from_numpy(il[feasible]), torch.from_numpy(tl[feasible]))
    assert ours_feasible.item() == pytest.approx(yard.item(), rel=1e-4)
    # *_parts: the numerator over the valid-row count.
    num, den = losses.ctc_loss_parts(torch.log_softmax(torch.from_numpy(logits), -1),
                                     targets, il, tl)
    ref_num, ref_den = jax_losses.ctc_loss_parts(jax.nn.log_softmax(jnp.asarray(logits), -1),
                                                 jnp.asarray(targets), jnp.asarray(il),
                                                 jnp.asarray(tl))
    assert float(den) == float(ref_den) == 3.0
    assert abs(float(num) - float(ref_num)) <= TOL * abs(float(ref_num))


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_matches_jax(weighted, tmp_path):
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(B, T, K)).astype(np.float32)
    targets = rng.integers(0, K, (B, T)).astype(np.int32)
    targets[LENGTHS[:, None] <= np.arange(T)] = -1
    vocab = {f"t{i}": i for i in range(K)}
    path = tmp_path / "weights.json"
    path.write_text(json.dumps({"t2": 3.0, "t5": 0.5, "absent": 9.0}))
    cw = losses.load_class_weights(str(path), vocab) if weighted else None
    ref_cw = jax_losses.load_class_weights(str(path), vocab) if weighted else None
    if weighted:
        assert np.array_equal(cw.numpy(), np.asarray(ref_cw))
        assert torch.equal(losses.load_class_weights(str(path), 4), torch.ones(4))

    def jax_fn(lg):
        return jax_losses.cross_entropy_loss(lg, jnp.asarray(targets), jnp.asarray(LENGTHS),
                                             class_weights=ref_cw)

    ref, ref_grad = jax.value_and_grad(jax_fn)(jnp.asarray(logits))
    lg = torch.from_numpy(logits).requires_grad_()
    got = losses.cross_entropy_loss(lg, torch.from_numpy(targets), torch.from_numpy(LENGTHS),
                                    class_weights=cw)
    got.backward()
    assert abs(got.item() - float(ref)) <= TOL * max(abs(float(ref)), 1.0)
    assert _rel_err(lg.grad, ref_grad) <= GRAD_TOL
    num, den = losses.cross_entropy_loss_parts(torch.from_numpy(logits), targets, LENGTHS,
                                               class_weights=cw)
    ref_num, ref_den = jax_losses.cross_entropy_loss_parts(
        jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(LENGTHS), class_weights=ref_cw)
    assert float(den) == pytest.approx(float(ref_den), rel=1e-6)
    assert float(num) == pytest.approx(float(ref_num), rel=1e-5)
    assert float(den) == pytest.approx(
        float(losses.cross_entropy_weights(targets, LENGTHS, T, cw).sum()), rel=1e-6)


# ---------- decoders ----------


def _emissions(seed, b=4, t=16, k=6):
    logp = jax.nn.log_softmax(jnp.asarray(
        2.0 * np.random.default_rng(seed).normal(size=(b, t, k)).astype(np.float32)), axis=-1)
    lengths = np.array([t, 9, 1, 0][:b], np.int32)
    return np.array(logp), lengths


def test_greedy_decode_matches_jax():
    logp, lengths = _emissions(4)
    logp[0, 3:6] = logp[0, 2]  # repeats to collapse
    got, got_len = decoders.greedy_ctc_decode(torch.from_numpy(logp), torch.from_numpy(lengths))
    ref, ref_len = jax_decoders.greedy_ctc_decode(jnp.asarray(logp), jnp.asarray(lengths))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got_len.numpy(), np.asarray(ref_len))
    assert decoders.decode_to_strings(got.numpy(), got_len.numpy()) == \
        jax_decoders.decode_to_strings(np.asarray(ref), np.asarray(ref_len))


@pytest.mark.parametrize("beam_width", [3, 8])
def test_beam_decoders_match_jax(beam_width):
    """The device beam search against JAX's (equal ids), and against the
    host search without a frame restriction; the host search with its
    default restriction against JAX's host search."""
    logp, lengths = _emissions(5 + beam_width)
    got, got_len = decoders.beam_ctc_decode_device(torch.from_numpy(logp),
                                                   torch.from_numpy(lengths), beam_width)
    ref, ref_len = jax_decoders.beam_ctc_decode_device(jnp.asarray(logp), jnp.asarray(lengths),
                                                       beam_width)
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got_len.numpy(), np.asarray(ref_len))
    host = decoders.beam_ctc_decode(logp, lengths, beam_width, frame_candidates=None)
    assert host == [list(r[:n]) for r, n in zip(got.numpy(), got_len.numpy())]
    assert decoders.beam_ctc_decode(logp, lengths, beam_width) == \
        jax_decoders.beam_ctc_decode(logp, lengths, beam_width)
    with pytest.raises(ValueError, match="frame_candidates"):
        decoders.beam_ctc_decode(logp, lengths, beam_width, frame_candidates=0)


# ---------- metrics ----------


def test_metrics_match_jax():
    rng = np.random.default_rng(6)
    preds = [" ".join(map(str, rng.integers(1, 6, rng.integers(0, 9)))) for _ in range(7)]
    targets = [" ".join(map(str, rng.integers(1, 6, rng.integers(1, 9)))) for _ in range(7)]
    vocab = [str(i) for i in range(6)]
    for name in ("word_error_rate", "word_information_lost", "compute_transitions"):
        assert getattr(metrics, name)(preds, targets) == getattr(jax_metrics, name)(preds, targets)
    assert metrics.edit_distance(preds[0], targets[0]) == \
        jax_metrics.edit_distance(preds[0], targets[0])
    for mode in (None, "insertions", "deletions", "both"):
        for norm in (None, "true", "pred", "all"):
            assert np.array_equal(
                metrics.substitution_matrix(preds, targets, vocab, mode, norm),
                jax_metrics.substitution_matrix(preds, targets, vocab, mode, norm))
    p, t = rng.integers(0, 4, 50), rng.integers(0, 4, 50)
    mask = rng.random(50) > 0.3
    probs = rng.random((50, 4))
    assert metrics.token_accuracy(p, t, mask) == jax_metrics.token_accuracy(p, t, mask)
    assert metrics.macro_f1(p, t, 4, mask) == jax_metrics.macro_f1(p, t, 4, mask)
    assert metrics.macro_auroc(probs, t, 4, mask) == jax_metrics.macro_auroc(probs, t, 4, mask)
