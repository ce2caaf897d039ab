"""The port's transformer training path against the JAX package's, on the CPU.

One narrow model (3 articulators, embed 16, 2 heads, 2 layers, encoder
feed-forward 32, 10 contour samples) is initialised once with flax; every
leaf then gets seeded noise (no zero bias, no unit LayerNorm scale) and the
weights go into the port's ``ArtSpeechTransformer`` through the converter.
On one seeded padded batch (B = 4, T = 16, lengths 16, 11, 5, 0):
- the training-mode forward at dropout 0 (the pairs through the fused path)
  against JAX's ``apply(..., deterministic=False)`` (its ``nn.vmap`` lift)
  on valid positions, within 1e-5;
- the gradients of ``masked_euclidean_loss`` against ``jax.value_and_grad``
  within 1e-4 * max |ref| per parameter, max |ref| floored at 1e-5: the
  key biases' gradient is exactly zero (a softmax does not see one shift of
  all its keys), and both sides compute rounding noise of ~1e-10 for it;
- one ``make_transformer_train_step`` against JAX's (donate off): the loss
  within 1e-5 relative, the updated parameters within 1e-6 where
  |g| >= 100 * Adam's eps (as for ArtSpeech: AdamW's first update turns rounding
  differences of near-zero gradients into moves of up to lr);
- ``accum_steps`` 1, 2 and 4: the same loss and gradients within 1e-5 (of
  the largest), and the accumulated step against JAX's accumulated step;
- dropout: seeded and train-only, the keep rate and scale, every drop site
  with its rate and shape, attention masks shared across batch and heads
  and distinct per channel and per pair;
- the train CLI end to end with ``--device cpu`` (2 epochs over a
  ``make_synthetic_corpus`` corpus): its checkpoints, ``best/state`` read
  back into the model, ``test_results.json``, and the transformer test CLI
  on ``best/state`` reproducing the train CLI's final test.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.training import train_state as flax_train_state

from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.losses import articulation as jax_losses
from artspeech_tpu.models.transformer import ArtSpeechTransformer as JaxTransformer
from artspeech_tpu.train import state as jax_state
from artspeech_tpu.train import step as jax_step
from artspeech_tpu_torch.losses.articulation import masked_euclidean_loss
from artspeech_tpu_torch.models import transformer
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
from artspeech_tpu_torch.ops import hopper_train_attention
from artspeech_tpu_torch.train import checkpoint, state
from artspeech_tpu_torch.train.step import (
    make_transformer_eval_step,
    make_transformer_train_step,
    shift_targets_right,
    transformer_accum_steps,
)
from artspeech_tpu_torch.utils.convert import transformer_state_dict_from_flax
from test_torch_port_cli import _flat, _run

VOCAB, C, N_FEAT, T = 12, 3, 20, 16
MODEL = {"embed_dim": 16, "num_heads": 2, "num_layers": 2, "encoder_ff_dim": 32}
LR, WD, EPS = 1e-3, 1e-5, 1e-8
TO_MM = 136 * 1.6176470518112


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lengths = np.array([T, 11, 5, 0], np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    return {"tokens": np.where(valid, rng.integers(0, VOCAB, (4, T)), 0).astype(np.int32),
            "targets": (rng.random((4, T, C, 2, N_FEAT // 2)) * valid[:, :, None, None, None]
                        ).astype(np.float32),
            "lengths": lengths}


@pytest.fixture(scope="module")
def setup():
    model = JaxTransformer(vocab_size=VOCAB, num_articulators=C, num_feat=N_FEAT, **MODEL)
    batch = _batch()
    tgt_in = np.asarray(jax_step.shift_targets_right(jnp.asarray(batch["targets"])))
    params = model.init(jax.random.PRNGKey(0), batch["tokens"], tgt_in, batch["lengths"],
                        batch["lengths"])["params"]
    rng = np.random.default_rng(0)
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])

    def loss_fn(p):
        out = model.apply({"params": p}, batch["tokens"], tgt_in, batch["lengths"],
                          batch["lengths"], deterministic=False)
        return jax_losses.masked_euclidean_loss(out, batch["targets"], batch["lengths"]), out

    (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(params)
    return {"model": model, "params": params, "batch": batch, "out": np.asarray(out),
            "loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads)}


def _port(params, dropout=0.0):
    model = ArtSpeechTransformer(VOCAB, C, num_feat=N_FEAT, dropout=dropout, **MODEL, device="cpu")
    model.load_state_dict(transformer_state_dict_from_flax(params))
    return model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_training_forward_at_dropout_0_matches_jax(setup):
    b = _tensors(setup["batch"])
    port = _port(setup["params"]).train()
    with torch.no_grad():
        got = port(b["tokens"], shift_targets_right(b["targets"]), b["lengths"], b["lengths"])
    valid = np.arange(T)[None, :] < setup["batch"]["lengths"][:, None]
    np.testing.assert_allclose(got.numpy()[valid], setup["out"][valid], rtol=0, atol=1e-5)


def test_loss_gradients_match_jax(setup):
    b = _tensors(setup["batch"])
    port = _port(setup["params"]).train()
    loss = masked_euclidean_loss(
        port(b["tokens"], shift_targets_right(b["targets"]), b["lengths"], b["lengths"]),
        b["targets"], b["lengths"])
    loss.backward()
    assert abs(loss.item() - setup["loss"]) <= 1e-5 * setup["loss"]
    ref = transformer_state_dict_from_flax(setup["grads"])  # maps a gradient tree as params
    grads = {n: p.grad for n, p in port.named_parameters()}
    assert set(grads) == set(ref)
    for name, g in grads.items():
        assert (g - ref[name]).abs().max() <= 1e-4 * max(ref[name].abs().max(), 1e-5), name


def _jax_step(setup, accum_steps):
    """One JAX train step from the setup's weights: (loss, updated params)."""
    st = flax_train_state.TrainState.create(apply_fn=setup["model"].apply, params=setup["params"],
                                            tx=jax_state.make_optimizer(LR, WD))
    step = jax_step.make_transformer_train_step(TO_MM, donate=False, accum_steps=accum_steps)
    st, metrics = step(st, setup["batch"], jax.random.PRNGKey(0))
    return float(metrics["loss"]), transformer_state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, st.params))


def _port_step(setup, accum_steps):
    st = state.create_train_state(_port(setup["params"]), LR, WD)
    metrics = make_transformer_train_step(TO_MM, with_p2cp=True, accum_steps=accum_steps,
                                          device="cpu")(st, setup["batch"])
    grads = {n: p.grad.clone() for n, p in st.model.named_parameters()}
    return metrics, grads, {k: v.clone() for k, v in st.model.state_dict().items()}, st


def _assert_params_match(params, ref, grads):
    for name, p in params.items():
        stable = grads[name].abs() >= 100 * EPS
        if stable.any():
            assert (p - ref[name]).abs()[stable].max() <= 1e-6, name


@pytest.fixture(scope="module")
def accumulated(setup):
    return {k: _port_step(setup, k) for k in (1, 2, 4)}


def test_train_step_matches_jax(setup, accumulated):
    metrics, grads, params, st = accumulated[1]
    assert st.step == 1 and st.model.training
    jax_loss, jax_params = _jax_step(setup, 1)
    assert abs(metrics["loss"].item() - jax_loss) <= 1e-5 * jax_loss
    assert abs(metrics["loss"].item() - setup["loss"]) <= 1e-5 * setup["loss"]
    _assert_params_match(params, jax_params, grads)


def test_accumulation_is_exact(setup, accumulated):
    """accum_steps 2 and 4 against 1 (loss, P2CP and gradients within 1e-5 of
    the largest), and the accumulated step against JAX's."""
    ref_metrics, ref_grads, _, _ = accumulated[1]
    for k in (2, 4):
        metrics, grads, _, _ = accumulated[k]
        for key in ("loss", "p2cp_mm"):
            assert abs(metrics[key] - ref_metrics[key]) <= 1e-5 * ref_metrics[key], (k, key)
        for name, g in grads.items():
            assert (g - ref_grads[name]).abs().max() <= 1e-5 * ref_grads[name].abs().max(), name
    jax_loss, jax_params = _jax_step(setup, 2)
    metrics, grads, params, _ = accumulated[2]
    assert abs(metrics["loss"].item() - jax_loss) <= 1e-5 * jax_loss
    _assert_params_match(params, jax_params, grads)
    with pytest.raises(ValueError, match="divisible"):
        make_transformer_train_step(TO_MM, accum_steps=3, device="cpu")(
            state.create_train_state(_port(setup["params"]), LR), setup["batch"])


def test_accum_policy_and_eval_step(setup):
    assert all(transformer_accum_steps(b) == 1 for b in (2, 12, 64, 256))  # measured on the H100
    st = state.create_train_state(_port(setup["params"]).train(), LR)
    metrics, outputs = make_transformer_eval_step(TO_MM, device="cpu")(st, setup["batch"])
    assert not st.model.training and outputs.shape == (4, T, C, 2, N_FEAT // 2)
    assert abs(metrics["loss"].item() - setup["loss"]) <= 1e-5 * setup["loss"]


# -- dropout -----------------------------------------------------------------

def test_dropout_is_seeded_and_train_only(setup):
    b = _tensors(setup["batch"])
    args = (b["tokens"], shift_targets_right(b["targets"]), b["lengths"], b["lengths"])
    model = _port(setup["params"], dropout=0.3)
    with torch.no_grad():
        plain = model(*args)
        model.train()
        first = model(*args, generator=torch.Generator().manual_seed(1))
        again = model(*args, generator=torch.Generator().manual_seed(1))
        other = model(*args, generator=torch.Generator().manual_seed(2))
        with pytest.raises(ValueError, match="Generator"):
            model(*args)
        model.eval()
        evaluated = model(*args, generator=torch.Generator().manual_seed(3))
    torch.testing.assert_close(first, again, rtol=0, atol=0)
    assert not torch.equal(first, other) and not torch.equal(first, plain)
    torch.testing.assert_close(evaluated, plain, rtol=0, atol=0)


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_attention_keep_mask_rate_and_scale(rate):
    n = 400_000
    keep = transformer._keep_mask((n,), rate, torch.Generator().manual_seed(0), "cpu")
    kept = (keep != 0).float().mean().item()
    assert abs(kept - (1 - rate)) <= 3 * (rate * (1 - rate) / n) ** 0.5
    torch.testing.assert_close(keep[keep != 0], torch.full_like(keep[keep != 0], 1 / (1 - rate)))
    assert transformer._keep_mask((4,), rate, None, "cpu") is None


def test_dropout_sites_and_mask_shapes(setup, monkeypatch):
    """Every drop site of one training forward, with its rate and the shape
    of its mask: elementwise drops through apply_dropout, attention masks
    through lean_attention and fused_causal_attend."""
    rate = 0.1
    composed = 1 - (1 - rate) ** 2
    drops, attends, pairs = [], [], []
    real_dropout, real_lean = transformer.apply_dropout, transformer.lean_attention
    real_fused = hopper_train_attention.fused_causal_attend

    def spy_dropout(x, r, generator):
        drops.append((tuple(x.shape), round(r, 6)))
        return real_dropout(x, r, generator)

    def spy_lean(query, key, value, mask=None, keep=None):
        attends.append(keep)
        return real_lean(query, key, value, mask, keep)

    def spy_fused(q, k, v, keep, n_pairs):
        pairs.append((keep, n_pairs, q.shape[0]))
        return real_fused(q, k, v, keep, n_pairs)

    monkeypatch.setattr(transformer, "apply_dropout", spy_dropout)
    monkeypatch.setattr(transformer, "lean_attention", spy_lean)
    monkeypatch.setattr(hopper_train_attention, "fused_causal_attend", spy_fused)
    b = _tensors(setup["batch"])
    model = _port(setup["params"], dropout=rate).train()
    with torch.no_grad():
        model(b["tokens"], shift_targets_right(b["targets"]), b["lengths"], b["lengths"],
              generator=torch.Generator().manual_seed(0))
    e, bsz, r = MODEL["embed_dim"], 4, round(rate, 6)
    encoder_layer = [((bsz, T, e), r), ((bsz, T, MODEL["encoder_ff_dim"]), r), ((bsz, T, e), r)]
    decoder_layer = [((bsz, C, T, e), r),  # drop(tgt)
                     ((bsz, C, T, e), round(composed, 6)),  # the pairs' own channel
                     ((bsz, C, C - 1, T, e), round(composed, 6)),  # the other channels
                     ((bsz, C, T, (C - 1) * e), r),  # the concat
                     ((bsz, T, e), r), ((bsz, C, T, e), r),  # drop(memory), drop(inter)
                     ((bsz, C, T, e), r)]  # pre-feed-forward
    layers = MODEL["num_layers"]
    assert drops == ([((bsz, T, e), r)] + encoder_layer * layers + [((bsz, C, T, e), r)]
                     + decoder_layer * layers)
    # Against scores (B, n, H, L, S): the encoder's one (S, S) mask a layer
    # and the decoder's one (L, L) or (L, S) mask a channel, each broadcast
    # over batch (no dim) and heads (size 1).
    assert [tuple(k.shape) for k in attends] == (
        [(1, 1, T, T)] * layers + [(C, 1, T, T)] * 2 * layers)
    for keep in attends[layers:]:
        assert all(not torch.equal(keep[i], keep[j]) for i in range(C) for j in range(i))
    n_pairs = C * (C - 1)
    assert [(tuple(k.shape), n, g) for k, n, g in pairs] == (
        [((n_pairs, T, T), n_pairs, n_pairs * bsz * MODEL["num_heads"])] * layers)
    for keep, _, _ in pairs:
        assert all(not torch.equal(keep[i], keep[j]) for i in range(n_pairs) for j in range(i))


# -- the train CLI ------------------------------------------------------------

def test_train_cli_end_to_end(tmp_path, monkeypatch):
    corpus = str(tmp_path / "corpus")
    info = make_synthetic_corpus(corpus, subjects=("s1",), sequences=("S01", "S02", "S03"),
                                 n_sentences=3, frames_per_sentence=10)
    vocab_path = os.path.join(corpus, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    cfg = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path,
           "articulators": ["lower-lip", "tongue", "upper-lip"], "clip_tails": True,
           "batch_size": 2, "num_epochs": 2, "patience": 30, "learning_rate": 1e-3,
           "weight_decay": 1e-5, "model_kwargs": {**MODEL, "dropout": 0.1},
           "train_seq_dict": {"s1": ["S01", "S02"]}, "valid_seq_dict": {"s1": ["S03"]},
           "test_seq_dict": {"s1": ["S03"]}, "generate_cache_dtype": "float32"}
    out = tmp_path / "train_run"
    results = _run("artspeech_tpu_torch", "train_phoneme_to_articulation_transformer", cfg, out,
                   monkeypatch, tmp_path)
    for sub in ("checkpoints/best/state.pt", "checkpoints/last/state.pt", "checkpoints/best_model",
                "test_results.json", "run/metrics.jsonl"):
        assert (out / sub).is_file(), sub
    with open(out / "run" / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    assert [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(v) for r in records for k, v in r.items() if k != "ts")
    with open(out / "test_results.json") as f:
        written = json.load(f)
    assert written == results and all(np.isfinite(v) for v in _flat(written).values())
    params = checkpoint.load_params(str(out / "checkpoints" / "best" / "state"))
    vocab_size = params["src_embedding.weight"].shape[0]
    ArtSpeechTransformer(vocab_size, C, **MODEL, device="cpu").load_state_dict(params)
    test_out = tmp_path / "test_run"
    tested = _run("artspeech_tpu_torch", "test_phoneme_to_articulation_transformer",
                  {**cfg, "state_dict_filepath": str(out / "checkpoints" / "best" / "state")},
                  test_out, monkeypatch, tmp_path)
    assert _flat(tested) == _flat(results)
