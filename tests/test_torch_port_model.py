"""The port's ArtSpeech against the JAX package's, through utils/convert.py.

One JAX param tree at a narrow width (vocab 12, 3 articulators, hidden 16)
goes through ``artspeech_state_dict_from_flax`` into the port; the same
numpy-made tokens go through both. Tolerance 1e-5 in float32, over every
position including padded ones (both repeat the last valid GRU state there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.models.artspeech_rnn import SimpleArtSpeech as JaxSimpleArtSpeech
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech, SimpleArtSpeech
from artspeech_tpu_torch.utils.convert import (
    artspeech_state_dict_from_flax,
    simple_artspeech_state_dict_from_flax,
)

VOCAB, N_ART, EMBED, HIDDEN = 12, 3, 8, 16
TOL = 1e-5


def _tokens(batch, t=14, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, VOCAB, (batch, t)).astype(np.int32)
    lengths = rng.integers(1, t + 1, batch).astype(np.int32)
    lengths[0] = t
    return tokens, lengths


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.array, params)


@pytest.mark.parametrize("batch", [4, 24])
def test_artspeech_matches_jax(batch):
    tokens, lengths = _tokens(batch, seed=batch)
    jax_model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                             hidden_size=HIDDEN)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(batch), tokens, lengths)["params"]
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, tokens, lengths))

    model = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    model.load_state_dict(artspeech_state_dict_from_flax(_numpy_tree(params)))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens), torch.from_numpy(lengths)).numpy()
    assert got.shape == (batch, tokens.shape[1], N_ART, 2, 50)
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_simple_artspeech_matches_jax():
    tokens, lengths = _tokens(5, seed=11)
    jax_model = JaxSimpleArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                                   hidden_size=HIDDEN)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), tokens, lengths)["params"]
    ref = np.asarray(jax.jit(jax_model.apply)({"params": params}, tokens, lengths))

    model = SimpleArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    model.load_state_dict(simple_artspeech_state_dict_from_flax(_numpy_tree(params)))
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens), torch.from_numpy(lengths)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=TOL)


def test_state_dict_covers_every_parameter_with_jax_shapes():
    jax_model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=N_ART, embed_dim=EMBED,
                             hidden_size=HIDDEN)
    tokens, lengths = _tokens(2)
    shapes = jax.eval_shape(jax_model.init, jax.random.PRNGKey(0), jnp.asarray(tokens),
                            jnp.asarray(lengths))["params"]
    params = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    converted = artspeech_state_dict_from_flax(params)
    model = ArtSpeech(VOCAB, N_ART, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    own = model.state_dict()
    assert set(converted) == set(own)
    for name, value in own.items():
        assert converted[name].shape == value.shape, name
    assert own["rnn.layers.1.wh"].shape == (HIDDEN, 3 * HIDDEN)
    assert own["decoder.dense2_kernel"].shape == (N_ART, 256, 50)


def test_seeded_construction_is_reproducible_and_finite():
    a = ArtSpeech(VOCAB, N_ART, hidden_size=HIDDEN, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    b = ArtSpeech(VOCAB, N_ART, hidden_size=HIDDEN, generator=torch.Generator().manual_seed(5),
                  device="cpu")
    for (name, pa), pb in zip(a.state_dict().items(), b.state_dict().values()):
        torch.testing.assert_close(pa, pb, rtol=0, atol=0, msg=name)
    tokens, lengths = _tokens(3)
    with torch.inference_mode():
        out = a(torch.from_numpy(tokens), torch.from_numpy(lengths))
    assert torch.isfinite(out).all() and out.min() >= 0 and out.max() <= 1
