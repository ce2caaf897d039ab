"""16-bit compute in the port against flax's ``dtype=jnp.bfloat16`` and
``dtype=jnp.float16``, on the CPU.

The JAX package's bf16 configs (compute_dtype: bfloat16, and float16 where a
config asks for it) keep the parameters in float32 and compute in the 16-bit
type where the flax modules cast. The port takes the same ``dtype``; each
test runs at both. ArtSpeech (embed 8, hidden 16) and the transformer
(embed 16, 2 heads, 1 layer, 3 articulators) are each initialised once with
flax; every leaf gets seeded noise and goes into the port through the
converter. One seeded padded batch (B = 4, T = 16, lengths 16, 11, 5, 1).

Tolerances, in rounding steps of the dtype: 2^-8 for bf16 (8 bits of
mantissa), 2^-11 for fp16 (11). Both sides round to the 16-bit type at
every cast point, but not in the same order: torch and XLA sum bf16 products
in different orders and the port's GRU keeps its gate math in f32 (the
kernels' semantics) where flax's scan computes it in bf16. One rounding step
of a sigmoid output in [0, 1] is one step, and a few of them accumulate over
the layers, so the outputs are held within 4 steps of max |ref| (2^-6 in
bf16, 2^-9 in fp16), or, where it is larger, within twice the distance of
flax's own 16-bit output from its float32 output on the same weights: the
port may not stray from flax's 16-bit output by more than that type itself
strays from float32. The transformer's attention, softmax and LayerNorms in
the 16-bit type give that second bound. The loss, a mean over every valid
frame, holds within 4 steps relative; the gradients, which flow back through
the same roundings, point the same way (cosine >= 0.99 over all parameters)
with the same norm within 2^-4, at both types. The
training-mode pair attention runs its kernel in float32 and casts back, as
JAX does, which is checked on the call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.losses import articulation as jax_losses
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.models.transformer import ArtSpeechTransformer as JaxTransformer
from artspeech_tpu.train import step as jax_step
from artspeech_tpu_torch.models import transformer
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
from artspeech_tpu_torch.ops import hopper_train_attention
from artspeech_tpu_torch.train import state
from artspeech_tpu_torch.train.step import (
    make_artspeech_train_step,
    make_transformer_train_step,
    shift_targets_right,
)
from artspeech_tpu_torch.utils.convert import (
    artspeech_state_dict_from_flax,
    transformer_state_dict_from_flax,
)

VOCAB, C, N_FEAT, T, B = 12, 3, 20, 16, 4
ARTSPEECH = {"embed_dim": 8, "hidden_size": 16, "n_samples": N_FEAT // 2}
TRANSFORMER = {"embed_dim": 16, "num_heads": 2, "num_layers": 1, "encoder_ff_dim": 32,
               "num_feat": N_FEAT}
#: One rounding step of each compute dtype; outputs and the loss are held to
#: four of them.
STEPS = {"bfloat16": 2.0**-8, "float16": 2.0**-11}
GRAD_NORM_TOL, GRAD_COS = 2.0**-4, 0.99
HALF = pytest.mark.parametrize("dtype", sorted(STEPS))
TO_MM = 136 * 1.6176470518112


def _batch():
    rng = np.random.default_rng(0)
    lengths = np.array([T, 11, 5, 1], np.int32)
    valid = np.arange(T)[None, :] < lengths[:, None]
    return {"tokens": np.where(valid, rng.integers(0, VOCAB, (B, T)), 0).astype(np.int32),
            "targets": (rng.random((B, T, C, 2, N_FEAT // 2)) * valid[:, :, None, None, None]
                        ).astype(np.float32),
            "lengths": lengths}, valid


def _noisy(params, seed):
    rng = np.random.default_rng(seed)
    leaves, tree = jax.tree_util.tree_flatten(params)
    return jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])


class _References(dict):
    """flax's output, loss and gradients (float32) at each 16-bit dtype,
    computed at first use, and its float32 output on the same weights."""

    def __init__(self, make, params, args, batch):
        super().__init__()
        self.make, self.params, self.args, self.batch = make, params, args, batch
        self.out_f32 = np.asarray(jax.jit(make(None).apply)({"params": params}, *args))

    def __missing__(self, dtype):
        model = self.make(getattr(jnp, dtype))

        def loss_fn(p):
            out = model.apply({"params": p}, *self.args)
            return (jax_losses.masked_euclidean_loss(out, self.batch["targets"],
                                                     self.batch["lengths"]), out)

        (loss, out), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(self.params)
        self[dtype] = {"out": np.asarray(out.astype(jnp.float32)), "loss": float(loss),
                       "grads": jax.tree_util.tree_map(lambda g: np.asarray(g, np.float32),
                                                       grads),
                       "out_f32": self.out_f32}
        return self[dtype]


@pytest.fixture(scope="module")
def artspeech():
    batch, valid = _batch()
    make = lambda dt: JaxArtSpeech(vocab_size=VOCAB, n_articulators=C, dtype=dt,  # noqa: E731
                                   **ARTSPEECH)
    args = (batch["tokens"], batch["lengths"])
    params = _noisy(make(None).init(jax.random.PRNGKey(0), *args)["params"], seed=1)
    state_dict = artspeech_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    return {"ref": _References(make, params, args, batch), "batch": batch, "valid": valid,
            "state_dict": state_dict,
            "port": lambda dt: _load(ArtSpeech(VOCAB, C, **ARTSPEECH, dtype=dt, device="cpu"),
                                     state_dict)}


@pytest.fixture(scope="module")
def transformer_ref():
    batch, valid = _batch()
    tgt_in = np.asarray(jax_step.shift_targets_right(jnp.asarray(batch["targets"])))
    make = lambda dt: JaxTransformer(vocab_size=VOCAB, num_articulators=C,  # noqa: E731
                                     dtype=dt, **TRANSFORMER)
    args = (batch["tokens"], tgt_in, batch["lengths"], batch["lengths"])
    params = _noisy(make(None).init(jax.random.PRNGKey(0), *args)["params"], seed=2)
    state_dict = transformer_state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params))
    # Training mode at dropout 0 (the pairs through the port's fused path;
    # flax's deterministic=False takes no dropout at rate 0).
    return {"ref": _References(make, params, args, batch),
            "train": _References(make, params, (*args, False), batch), "batch": batch,
            "valid": valid, "state_dict": state_dict,
            "port": lambda dt: _load(ArtSpeechTransformer(VOCAB, C, **TRANSFORMER, dtype=dt,
                                                          device="cpu"), state_dict)}


def _load(model, state_dict):
    model.load_state_dict(state_dict)
    return model


def _tensors(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _assert_output_close(got, ref, valid, dtype):
    assert got.dtype == getattr(torch, dtype)
    got = got.float().detach().numpy()
    tol = max(4 * STEPS[dtype] * np.abs(ref["out"]).max(),
              2 * np.abs(ref["out"] - ref["out_f32"])[valid].max())
    assert np.abs(got - ref["out"])[valid].max() <= tol


def _assert_step_close(loss, model, ref_loss, ref_grads, to_state_dict, dtype):
    assert abs(loss - ref_loss) <= 4 * STEPS[dtype] * ref_loss
    ref = to_state_dict(ref_grads)  # maps a gradient tree as it maps params
    names = sorted(ref)
    got = torch.cat([dict(model.named_parameters())[n].grad.flatten() for n in names])
    exp = torch.cat([ref[n].flatten() for n in names])
    assert all(p.dtype == torch.float32 and p.grad.dtype == torch.float32
               for p in model.parameters())
    assert torch.nn.functional.cosine_similarity(got, exp, dim=0) >= GRAD_COS
    assert abs(got.norm() / exp.norm() - 1.0) <= GRAD_NORM_TOL


@HALF
def test_artspeech_forward_matches_flax_bf16(artspeech, dtype):
    b = _tensors(artspeech["batch"])
    with torch.no_grad():
        got = artspeech["port"](getattr(torch, dtype))(b["tokens"], b["lengths"])
        f32 = artspeech["port"](None)(b["tokens"], b["lengths"])
    _assert_output_close(got, artspeech["ref"][dtype], artspeech["valid"], dtype)
    assert f32.dtype == torch.float32 and not torch.equal(got.float(), f32)


@HALF
def test_artspeech_train_step_matches_flax_bf16(artspeech, dtype):
    ref = artspeech["ref"][dtype]
    st = state.create_train_state(artspeech["port"](getattr(torch, dtype)), 1e-3, 1e-5)
    metrics = make_artspeech_train_step(TO_MM, device="cpu")(st, artspeech["batch"])
    _assert_step_close(metrics["loss"].item(), st.model, ref["loss"], ref["grads"],
                       artspeech_state_dict_from_flax, dtype)


@HALF
def test_transformer_forward_matches_flax_bf16(transformer_ref, dtype):
    b = _tensors(transformer_ref["batch"])
    with torch.no_grad():
        got = transformer_ref["port"](getattr(torch, dtype))(
            b["tokens"], shift_targets_right(b["targets"]), b["lengths"], b["lengths"])
    _assert_output_close(got, transformer_ref["ref"][dtype], transformer_ref["valid"], dtype)


@HALF
def test_transformer_train_step_matches_flax_bf16(transformer_ref, monkeypatch, dtype):
    calls = []
    attend = hopper_train_attention.fused_causal_attend

    def recorded(q, k, v, keep, n_pairs):
        out = attend(q, k, v, keep, n_pairs)
        calls.append((q.dtype, k.dtype, v.dtype, out.dtype))
        return out

    monkeypatch.setattr(transformer.hopper_train_attention, "fused_causal_attend", recorded)
    ref = transformer_ref["train"][dtype]
    st = state.create_train_state(transformer_ref["port"](getattr(torch, dtype)), 1e-3, 1e-5)
    metrics = make_transformer_train_step(TO_MM, device="cpu")(st, transformer_ref["batch"])
    # One fused pair attention a decoder layer, in float32 around the kernel.
    assert calls == [(torch.float32,) * 4] * TRANSFORMER["num_layers"]
    _assert_step_close(metrics["loss"].item(), st.model, ref["loss"], ref["grads"],
                       transformer_state_dict_from_flax, dtype)
    b = _tensors(transformer_ref["batch"])
    with torch.no_grad():
        got = st.model.train()(b["tokens"], shift_targets_right(b["targets"]), b["lengths"],
                               b["lengths"])
    assert got.dtype == getattr(torch, dtype)
