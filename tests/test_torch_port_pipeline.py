"""The port's synthesis (serving) path against the JAX package's.

``make_synthesis_step`` with and without canonical-incisor injection, and
``synthesize_corpus`` file for file, on one narrow JAX ArtSpeech param tree
carried across with utils/convert.py. Tolerance 1e-5 in float32 (1e-5 * RES
for the Xarticul text, which stores wall points times the image resolution).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.core.config import TEXTGRID_ONLY_CONFIG
from artspeech_tpu.core.constants import RECOGNITION_ARTICULATORS, TUBE_ARTICULATORS
from artspeech_tpu.models.artspeech_rnn import ArtSpeech as JaxArtSpeech
from artspeech_tpu.synth import pipeline as jax_pipeline
from artspeech_tpu_torch.core.config import TEXTGRID_ONLY_CONFIG as PORT_CONFIG
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech
from artspeech_tpu_torch.synth import pipeline as port_pipeline
from artspeech_tpu_torch.utils.convert import artspeech_state_dict_from_flax

VOCAB, EMBED, HIDDEN = 12, 8, 16
TOL = 1e-5


class _Sentences:
    """In-memory dataset with the ``SynthesisDataset`` interface."""

    def __init__(self, articulators, lengths, seed=0):
        rng = np.random.default_rng(seed)
        self.articulators = sorted(articulators)
        self.data = []
        for i, n in enumerate(lengths):
            tokens = rng.integers(0, VOCAB, n).astype(np.int32)
            self.data.append({"sentence_name": f"S{i:02d}", "subject": "subject1",
                              "phonemes": [f"p{t}" for t in tokens], "tokens": tokens})

    def __len__(self):
        return len(self.data)

    def __getitem__(self, index):
        item = self.data[index]
        return {**item, "length": len(item["tokens"])}


def _models(n_articulators, seed=0):
    jax_model = JaxArtSpeech(vocab_size=VOCAB, n_articulators=n_articulators,
                             embed_dim=EMBED, hidden_size=HIDDEN)
    dummy = jnp.zeros((1, 8), jnp.int32)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(seed), dummy,
                                     jnp.full((1,), 8, jnp.int32))["params"]

    def jax_forward(tokens, lengths):
        return jax_model.apply({"params": params}, tokens, lengths)

    port = ArtSpeech(VOCAB, n_articulators, embed_dim=EMBED, hidden_size=HIDDEN, device="cpu")
    port.load_state_dict(artspeech_state_dict_from_flax(jax.tree_util.tree_map(np.array, params)))
    return jax_forward, port


@pytest.mark.parametrize("articulators", [RECOGNITION_ARTICULATORS, TUBE_ARTICULATORS],
                         ids=["inject_incisor", "model_incisor"])
def test_synthesis_step_matches_jax(articulators):
    jax_forward, port = _models(len(articulators))
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, VOCAB, (3, 16)).astype(np.int32)
    lengths = np.array([16, 9, 1], np.int32)

    jax_step, jax_arts = jax_pipeline.make_synthesis_step(jax_forward, list(articulators))
    port_step, port_arts = port_pipeline.make_synthesis_step(port, list(articulators),
                                                             device="cpu")
    assert port_arts == jax_arts == sorted(TUBE_ARTICULATORS)
    ref = jax_step(jnp.asarray(tokens), jnp.asarray(lengths))
    got = port_step(tokens, lengths)
    for key in ("contours", "internal_wall", "external_wall"):
        assert got[key].shape == ref[key].shape, key
        assert torch.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=TOL,
                                   err_msg=key)


def _files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, names in os.walk(root) for f in names)


def test_synthesize_corpus_matches_jax_file_for_file(tmp_path):
    lengths = [3, 30, 7, 12, 21]
    dataset = _Sentences(RECOGNITION_ARTICULATORS, lengths, seed=2)
    jax_forward, port = _models(len(RECOGNITION_ARTICULATORS), seed=3)
    kwargs = dict(batch_size=2, buckets=(16, 32))
    jax_dirs = jax_pipeline.synthesize_corpus(
        jax_forward, dataset, str(tmp_path / "jax"), TEXTGRID_ONLY_CONFIG, **kwargs)
    port_dirs = port_pipeline.synthesize_corpus(
        port, dataset, str(tmp_path / "port"), PORT_CONFIG, device="cpu", **kwargs)
    assert [os.path.relpath(d, tmp_path / "port") for d in port_dirs] == [
        os.path.relpath(d, tmp_path / "jax") for d in jax_dirs]

    files = _files(tmp_path / "jax")
    assert files == _files(tmp_path / "port")
    n_frames = sum(lengths)
    assert len(files) == n_frames * (len(TUBE_ARTICULATORS) + 2) + len(lengths)
    res = PORT_CONFIG.RES
    for rel in files:
        ref_path, got_path = tmp_path / "jax" / rel, tmp_path / "port" / rel
        if rel.endswith(".npy"):
            ref, got = np.load(ref_path), np.load(got_path)
            assert got.shape == ref.shape and got.dtype == ref.dtype, rel
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=rel)
        elif "xarticul" in rel:
            ref = np.loadtxt(ref_path)
            got = np.loadtxt(got_path)
            np.testing.assert_allclose(got, ref, rtol=0, atol=TOL * res, err_msg=rel)
        else:
            assert got_path.read_text() == ref_path.read_text(), rel
