"""The port's fused causal training attention against the JAX package's, on
the CPU.

Same numpy-seeded inputs through both packages:
- ``fused_causal_attend`` (the plain versions, as a CPU tensor takes them)
  against JAX's ``pallas_train_attention.fused_causal_attend``, its Pallas
  kernels in interpret mode as tests/test_pallas_train_attention.py runs
  them: n_pairs 2, L 128, hd 8, a fixed numpy keep mask at p = 0.2 and the
  all-ones mask; the forward within 2e-5, dQ/dK/dV by ``torch.autograd``
  against ``jax.vjp`` within 5e-5, and the explicit
  ``fused_causal_attend_bwd_reference`` against both (the JAX test's own
  tolerances: f32 sums in another order);
- the port's training-mode ``ChannelInteractionsLayer`` (the fused pair
  path) against JAX's ``FusedChannelInteractions`` on the Pallas interpret
  path, weights carried by the converter, forward and gradients;
- on a padded batch, the fused path against the eval path on valid
  positions;
- the same pair layer at a bucket past the resident kernels' 512 (the one
  ``BucketedLoader`` adds for a 530-frame sentence, L = 576), where JAX
  takes its XLA attention and the port's kernels take every L;
- the refusals the kernels' bounds impose, on the CPU too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.models.transformer import FusedChannelInteractions
from artspeech_tpu.ops import pallas_train_attention
from artspeech_tpu_torch.data.batching import BucketedLoader
from artspeech_tpu_torch.models.transformer import ChannelInteractionsLayer
from artspeech_tpu_torch.ops import hopper_train_attention
from artspeech_tpu_torch.utils import convert

N_PAIRS, BH, L, HD = 2, 8, 128, 8
FWD_TOL, GRAD_TOL = 2e-5, 5e-5


def _inputs(keep_kind, seed=3):
    rng = np.random.default_rng(seed)
    g = N_PAIRS * BH
    q, k = (rng.normal(size=(g, L, HD)).astype(np.float32) * 0.4 for _ in range(2))
    v = rng.normal(size=(g, L, HD)).astype(np.float32)
    do = rng.normal(size=(g, L, HD)).astype(np.float32)
    if keep_kind == "dropout":
        keep = (rng.uniform(size=(N_PAIRS, L, L)) > 0.2).astype(np.float32) / np.float32(0.8)
        n_pairs = N_PAIRS
    else:
        keep, n_pairs = np.ones((1, L, L), np.float32), 1
    return q, k, v, keep, n_pairs, do


@pytest.fixture(scope="module", params=["dropout", "ones"])
def attend(request):
    """JAX's kernel forward and vjp, the port's forward, autograd gradients
    and explicit backward, on one set of inputs."""
    q, k, v, keep, n_pairs, do = _inputs(request.param)
    out, vjp = jax.vjp(lambda *a: pallas_train_attention.fused_causal_attend(*a, keep, n_pairs),
                       q, k, v)
    jax_grads = [np.asarray(x) for x in vjp(do)]
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    got = hopper_train_attention.fused_causal_attend(tq, tk, tv, torch.from_numpy(keep), n_pairs)
    autograd = torch.autograd.grad(got, (tq, tk, tv), torch.from_numpy(do))
    explicit = hopper_train_attention.fused_causal_attend_bwd_reference(
        *(torch.from_numpy(x) for x in (q, k, v, keep, do)), n_pairs)
    return {"jax_out": np.asarray(out), "jax_grads": jax_grads, "out": got.detach().numpy(),
            "autograd": [g.numpy() for g in autograd], "explicit": [g.numpy() for g in explicit]}


def test_forward_matches_jax_kernel(attend):
    assert attend["out"].shape == (N_PAIRS * BH, L, HD)
    np.testing.assert_allclose(attend["out"], attend["jax_out"], rtol=0, atol=FWD_TOL)


@pytest.mark.parametrize("which", [0, 1, 2], ids=["dq", "dk", "dv"])
def test_gradients_match_jax_vjp(attend, which):
    for name in ("autograd", "explicit"):
        np.testing.assert_allclose(attend[name][which], attend["jax_grads"][which], rtol=0,
                                   atol=GRAD_TOL, err_msg=name)
    np.testing.assert_allclose(attend["explicit"][which], attend["autograd"][which], rtol=0,
                               atol=GRAD_TOL)


def test_plain_forward_is_the_plain_reference():
    q, k, v, keep, n_pairs, _ = _inputs("dropout", seed=4)
    args = [torch.from_numpy(x) for x in (q, k, v, keep)]
    torch.testing.assert_close(hopper_train_attention.fused_causal_attend(*args, n_pairs),
                               hopper_train_attention.fused_causal_attend_reference(*args, n_pairs),
                               rtol=0, atol=0)


def _refusal_cases():
    def t(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype)

    ok = dict(q=t(4, 8, 4), k=t(4, 8, 4), v=t(4, 8, 4), keep=t(1, 8, 8), n_pairs=1)
    return {
        "head_dim_above_bound": (dict(ok, q=t(4, 8, 129), k=t(4, 8, 129), v=t(4, 8, 129)),
                                 ValueError, "head dim 129"),
        "float64": (dict(ok, q=t(4, 8, 4, dtype=torch.float64)), TypeError, "float32"),
        "non_contiguous": (dict(ok, q=t(4, 4, 8).transpose(1, 2)), ValueError, "contiguous"),
        "n_pairs_not_dividing_G": (dict(ok, keep=t(3, 8, 8), n_pairs=3), ValueError, "dividing"),
        "keep_shape": (dict(ok, keep=t(1, 8, 7)), ValueError, "keep"),
    }


@pytest.mark.parametrize("case", sorted(_refusal_cases()))
def test_refuses_what_the_kernels_do_not_take(case):
    kwargs, error, match = _refusal_cases()[case]
    with pytest.raises(error, match=match):
        hopper_train_attention.fused_causal_attend(**kwargs)


# -- the training-mode pair layer -------------------------------------------

B, C, E, H = 4, 3, 16, 2


def _port_layer(params):
    """The port's ChannelInteractionsLayer with a JAX FusedChannelInteractions'
    (tree-identical to the vmap lift's) weights, through the converter."""
    prefixed = {**convert._channel_processing(params["VmapChannelProcessingLayer_0"], "x.pairs"),
                **convert._layer_norm(params["LayerNorm_0"], "x", "ln"),
                **convert._dense(params["Dense_0"], "x", "dense")}
    layer = ChannelInteractionsLayer(C, E, H, torch.Generator().manual_seed(0))
    layer.load_state_dict({k.split(".", 1)[1]: v for k, v in prefixed.items()})
    return layer


def _jax_pair_layer(rng, proc):
    """JAX's FusedChannelInteractions and its parameters, every leaf with
    seeded noise (no zero bias, no unit LN scale). Init, forward and
    gradients are jitted: op by op, the L = 576 case took ~25 s."""
    layer = FusedChannelInteractions(embed_dim=E, num_heads=H, num_channels=C)
    params = jax.jit(layer.init)(jax.random.PRNGKey(0), proc)["params"]
    leaves, tree = jax.tree_util.tree_flatten(params)
    return layer, jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])


@pytest.fixture(scope="module")
def pair_layer():
    rng = np.random.default_rng(1)
    proc = (rng.normal(size=(B, C, L, E)) * 0.5).astype(np.float32)
    layer, params = _jax_pair_layer(rng, proc)
    g = C * (C - 1) * B * H
    assert pallas_train_attention.supported(g, L, E // H, g)  # JAX takes its kernel path
    return layer, params, proc


def test_fused_pair_layer_matches_jax_fused_channel_interactions(pair_layer):
    """Forward within 2e-5 and gradients (by the input and every parameter)
    within 1e-4 * max(|ref|, 1), the JAX test's tolerances
    (tests/test_pallas_train_attention.py: kernel against its fallback)."""
    _assert_pair_layer_matches_jax(*pair_layer)


def _assert_pair_layer_matches_jax(layer, params, proc):
    def loss(p, x):
        return jnp.sum(jnp.sin(layer.apply({"params": p}, x, deterministic=True)))

    ref_out = np.asarray(jax.jit(lambda p, x: layer.apply({"params": p}, x, deterministic=True))(
        params, proc))
    ref_gp, ref_gx = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, proc)
    port = _port_layer(params).train()
    x = torch.from_numpy(proc).requires_grad_()
    out = port(x)
    np.testing.assert_allclose(out.detach().numpy(), ref_out, rtol=0, atol=2e-5)
    torch.sin(out).sum().backward()
    ref_grads = {"x": np.asarray(ref_gx)}
    prefixed = {**convert._channel_processing(ref_gp["VmapChannelProcessingLayer_0"], "x.pairs"),
                **convert._layer_norm(ref_gp["LayerNorm_0"], "x", "ln"),
                **convert._dense(ref_gp["Dense_0"], "x", "dense")}
    ref_grads.update({k.split(".", 1)[1]: v.numpy() for k, v in prefixed.items()})
    got = {"x": x.grad.numpy(), **{n: p.grad.numpy() for n, p in port.named_parameters()}}
    assert set(got) == set(ref_grads)
    for name, g in got.items():
        scale = max(np.abs(ref_grads[name]).max(), 1.0)
        assert np.abs(g - ref_grads[name]).max() <= 1e-4 * scale, name


def test_fused_path_equals_eval_path_on_valid_positions(pair_layer):
    """Padded batch (lengths 128, 90, 40, 7): the fused path masks causally
    only, the eval path with the full tgt_mask; valid positions agree."""
    layer, params, proc = pair_layer
    port = _port_layer(params)
    lengths = torch.tensor([L, 90, 40, 7])
    valid = torch.arange(L)[None, :] < lengths[:, None]  # (B, L)
    mask = torch.ones(L, L, dtype=torch.bool).tril()[None, None] & valid[:, None, None, :]
    x = torch.from_numpy(proc)
    with torch.no_grad():
        fused = port.train()(x)
        plain = port.eval()(x, mask)
    diff = (fused - plain).abs().permute(0, 2, 1, 3)  # (B, L, C, E)
    assert diff[valid].max().item() <= 2e-5
    assert diff[~valid].max().item() > 1e-3  # padded queries do differ: the paths are distinct


LONG_SENTENCE, LONG_B = 530, 2  # frames: past the longest default bucket (512)


def _loader_bucket(lengths):
    """The first batch ``BucketedLoader`` makes of sentences of these
    lengths: (bucket length, lengths)."""
    items = [{"tokens": np.ones(n, np.int32), "targets": np.zeros((n, C, 2, 1), np.float32),
              "references": np.zeros((n, 1, 2, 1), np.float32),
              "critical_masks": np.zeros((0, n), np.int32), "voicing": np.zeros(n, np.float32),
              "length": n, "sentence_name": f"s{i}", "phonemes": ["a"] * n,
              "frame_ids": list(range(n))} for i, n in enumerate(lengths)]
    batch, _ = next(iter(BucketedLoader(items, batch_size=len(items), shuffle=False)))
    return batch["tokens"].shape[1], batch["lengths"]


def test_fused_pair_layer_matches_jax_past_the_longest_default_bucket():
    """A bucket the loader adds past 512 (L = 576 for a 530-frame sentence):
    JAX's FusedChannelInteractions takes its XLA attention there, the port
    the same fused_causal_attend as at every L (its plain versions on the
    CPU). Forward and gradients, by the input and every parameter (the
    query, key and value kernels among them), at the tolerances above; the
    padded frames of the shorter sentence are zero, as a padded batch's."""
    bucket, lengths = _loader_bucket((LONG_SENTENCE, 519))
    assert bucket == 576 and not hopper_train_attention.resident(bucket, E // H)
    rng = np.random.default_rng(5)
    valid = np.arange(bucket)[None, :] < lengths[:, None]
    proc = ((rng.normal(size=(LONG_B, C, bucket, E)) * 0.5).astype(np.float32)
            * valid[:, None, :, None])
    layer, params = _jax_pair_layer(rng, proc)
    g = C * (C - 1) * LONG_B * H
    assert not pallas_train_attention.supported(g, bucket, E // H, g)  # JAX: XLA attention
    _assert_pair_layer_matches_jax(layer, params, proc)
