"""The port's multi-channel transformer against the JAX package's, on the CPU.

One narrow model (embed 16, 2 heads, 2 layers, encoder feed-forward 32, the
corpus's vocabulary, 5 articulators) is initialised once with flax, at the
shapes the JAX test CLI initialises its template with, so that CLI's own init
reuses the compiled programs; every leaf then gets seeded noise, so no bias is
zero and no LayerNorm scale one. Five articulators, not three, because the
test harness computes tract variables only when lower lip, pharynx, soft
palate, tongue and upper lip are all there. The converted weights go into the
port's ``ArtSpeechTransformer`` on the CPU:

- the converter uses every flax leaf and sets every port parameter;
- the teacher-forced ``forward`` and ``encode`` (B = 2: one short row, one of
  length 0) within 1e-5;
- ``generate`` (the buffer re-decode) and ``make_fast_generate`` with float32
  caches: every frame within 1e-5 of what JAX's forward predicts from the
  port's earlier frames, and end to end against JAX's same decode within the
  spread of JAX's own two decodes (``_check_generated`` says why); with
  bfloat16 caches against JAX's bfloat16 decode (see that test);
- ``make_auto_generate`` takes the buffer inside its band and the cached
  decode outside it;
- the port's transformer test CLI (``--device cpu``, ``generate_cache_dtype:
  float32``) against the JAX CLI on the same weights, from each form of
  ``state_dict_filepath``: ``test_results.json`` and the ``test_outputs/``
  tree (contours and TV CSVs) with the same keys and files, each number
  within the spread of the JAX CLI's own two decodes (see that test);
- a training-mode forward with dropout raises without a generator; the CLI
  refuses bf16 compute.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.models import transformer as jax_transformer
from artspeech_tpu.models.transformer import ArtSpeechTransformer as JaxTransformer
from artspeech_tpu.models.transformer import make_fast_generate as jax_make_fast_generate
from artspeech_tpu.train.checkpoint import save_params as jax_save_params
from artspeech_tpu_torch.cli.test_phoneme_to_articulation_transformer import (
    cache_dtype_from_cfg,
    generate_batch_size,
)
from artspeech_tpu_torch.core.constants import REQUIRED_ARTICULATORS_FOR_TVS, UPPER_INCISOR
from artspeech_tpu_torch.core.vocab import load_vocabulary
from artspeech_tpu_torch.models import transformer
from artspeech_tpu_torch.models.transformer import ArtSpeechTransformer
from artspeech_tpu_torch.train import checkpoint, state
from artspeech_tpu_torch.utils.convert import transformer_state_dict_from_flax
from test_torch_port_cli import _assert_same_tree, _flat, _numbers, _run

ARTS = sorted(a for a in REQUIRED_ARTICULATORS_FOR_TVS if a != UPPER_INCISOR)
C, N_FEAT = len(ARTS), 100
MODEL = {"embed_dim": 16, "num_heads": 2, "num_layers": 2, "encoder_ff_dim": 32}
#: bfloat16 caches: the port's decode against JAX's, as a share of what the
#: rounding itself changes (see test_fast_generate_with_bf16_caches_matches_jax_bf16).
BF16_REL = 0.1


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("transformer")
    corpus = str(root / "corpus")
    info = make_synthetic_corpus(corpus, subjects=("s1",), sequences=("S01",), n_sentences=3,
                                 frames_per_sentence=10)
    vocab_path = os.path.join(corpus, "vocabulary.json")
    with open(vocab_path, "w") as f:
        json.dump(info["phonemes"], f)
    vocab_size = len(load_vocabulary(vocab_path))

    model = JaxTransformer(vocab_size=vocab_size, num_articulators=C, num_feat=N_FEAT, **MODEL)
    b, t = 1, 8  # the JAX test CLI's template shapes
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((b, t), jnp.int32),
                        jnp.zeros((b, t, C, N_FEAT)), jnp.full((b,), t, jnp.int32),
                        jnp.full((b,), t, jnp.int32))["params"]
    rng = np.random.default_rng(0)
    leaves, tree = jax.tree_util.tree_flatten(params)
    params = jax.tree_util.tree_unflatten(tree, [
        np.asarray(x) + 0.1 * rng.standard_normal(x.shape).astype(np.float32) for x in leaves])
    jax_save_params(str(root / "jax_ckpts" / "best_model"), params)

    port = ArtSpeechTransformer(vocab_size, C, num_feat=N_FEAT, **MODEL, device="cpu")
    port.load_state_dict(transformer_state_dict_from_flax(params))
    checkpoint.save_params(str(root / "ckpts" / "best_model"), port)
    checkpoint.save_checkpoint(str(root / "ckpts" / "best"), state.create_train_state(port, 1e-3))
    base = {"database_name": "gottingen", "datadir": corpus, "vocab_filepath": vocab_path,
            "articulators": ARTS, "clip_tails": True, "batch_size": 2, "model_kwargs": MODEL,
            "test_seq_dict": {"s1": ["S01"]}, "generate_cache_dtype": "float32"}
    return {"root": root, "model": model, "params": params, "port": port, "base": base,
            "vocab_size": vocab_size, "forward": jax.jit(model.apply)}


def _batch(vocab_size, s, l, seed):
    """B = 2: the first row short of the padded length, the second of length 0."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, vocab_size, (2, s)).astype(np.int32)
    src_lengths = np.array([s - 2, 0], np.int32)
    tgt = rng.uniform(size=(2, l, C, N_FEAT)).astype(np.float32)
    tgt_lengths = np.array([l - 1, 0], np.int32)
    return src, src_lengths, tgt, tgt_lengths


class _Recorder(dict):
    """A param tree that records which leaves are read."""

    def __init__(self, tree, path, seen):
        super().__init__(tree)
        self.path, self.seen = path, seen

    def __getitem__(self, key):
        value = super().__getitem__(key)
        if isinstance(value, dict):
            return _Recorder(value, self.path + (key,), self.seen)
        self.seen.add(self.path + (key,))
        return value


def test_converter_uses_every_leaf_and_sets_every_parameter(setup):
    seen = set()
    state_dict = transformer_state_dict_from_flax(_Recorder(setup["params"], (), seen))
    leaves = {tuple(k.key for k in path)
              for path, _ in jax.tree_util.tree_flatten_with_path(setup["params"])[0]}
    assert seen == leaves and len(leaves) > 100
    expected = setup["port"].state_dict()
    assert set(state_dict) == set(expected)
    for name, value in state_dict.items():
        assert value.shape == expected[name].shape, name
        torch.testing.assert_close(value, expected[name], rtol=0, atol=0)


def test_forward_and_encode_match_jax(setup):
    model, params, port = setup["model"], setup["params"], setup["port"]
    src, src_lengths, tgt, tgt_lengths = _batch(setup["vocab_size"], 9, 7, seed=1)
    ref = setup["forward"]({"params": params}, src, tgt, src_lengths, tgt_lengths)
    ref_memory, ref_mask = jax.jit(model.apply, static_argnames="method")(
        {"params": params}, src, src_lengths, method=JaxTransformer.encode)
    with torch.no_grad():
        got = port(*map(torch.as_tensor, (src, tgt, src_lengths, tgt_lengths)))
        memory, mask = port.encode(torch.as_tensor(src), torch.as_tensor(src_lengths))
    assert got.shape == (2, 7, C, 2, N_FEAT // 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)
    np.testing.assert_allclose(memory.numpy(), np.asarray(ref_memory), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))


@pytest.fixture(scope="module")
def decode(setup):
    """A batch (S = 12) and JAX's three decodes of it: the cached decode with
    float32 and with bfloat16 caches, and the buffer re-decode."""
    src, src_lengths = _batch(setup["vocab_size"], 12, 1, seed=3)[:2]
    model, params = setup["model"], setup["params"]
    jax_out = {cache: np.asarray(jax.jit(jax_make_fast_generate(model, cache_dtype=dtype))(
        params, src, src_lengths)) for cache, dtype in (("f32", None), ("bf16", jnp.bfloat16))}
    jax_out["buffer"] = np.asarray(model.apply({"params": params}, src, src_lengths,
                                               method=JaxTransformer.generate))
    return src, src_lengths, jax_out


def _per_frame(a, b):
    """max |a - b| per (row, frame) of (B, S, C, 2, D) contours."""
    return np.abs(a - b).reshape(*a.shape[:2], -1).max(-1)


def _check_generated(setup, decode, got, ref):
    """A generated batch against JAX.

    - Per frame, without feedback, within 1e-5: every frame the port emits is
      what JAX's teacher-forced forward predicts from the port's own earlier
      frames (this reads every cache row at every step).
    - End to end, against JAX's output ``ref`` of the same decode: the first
      frame within 1e-5; each later frame within the larger of 1e-5 and four
      times the gap between JAX's own two decodes (cached and buffer) at that
      frame. The decode feeds each frame back; at these random weights it
      amplifies the ~1e-6 float32 reassociation noise of a step about
      threefold per step, so JAX's two decodes of the same model already part
      by up to ~6e-4 within 12 frames (printed).
    """
    src, src_lengths, jax_out = decode
    frames = got.numpy().reshape(*got.shape[:2], C, N_FEAT)
    shifted = np.concatenate([np.zeros_like(frames[:, :1]), frames[:, :-1]], axis=1)
    teacher = setup["forward"]({"params": setup["params"]}, src, shifted, src_lengths)
    np.testing.assert_allclose(got.numpy(), np.asarray(teacher), rtol=0, atol=1e-5)
    gap, jax_gap = _per_frame(got.numpy(), ref), _per_frame(jax_out["f32"], jax_out["buffer"])
    print(f"port vs JAX, per frame max {gap.max():.3g}; JAX cached vs buffer {jax_gap.max():.3g}")
    assert (gap[:, 0] <= 1e-5).all()
    assert (gap <= np.maximum(1e-5, 4 * jax_gap)).all(), (gap, jax_gap)


def test_buffer_generate_matches_jax(setup, decode):
    src, src_lengths, jax_out = decode
    got = setup["port"].generate(torch.as_tensor(src), torch.as_tensor(src_lengths))
    assert got.shape == (2, 12, C, 2, N_FEAT // 2)
    _check_generated(setup, decode, got, jax_out["buffer"])


def test_fast_generate_with_f32_caches_matches_jax(setup, decode):
    src, src_lengths, jax_out = decode
    got = transformer.make_fast_generate(setup["port"], device="cpu")(src, src_lengths)
    assert got.shape == (2, 12, C, 2, N_FEAT // 2) and got.dtype == torch.float32
    _check_generated(setup, decode, got, jax_out["f32"])


def test_fast_generate_with_bf16_caches_matches_jax_bf16(setup, decode):
    """Both sides round the same cache rows to bfloat16, rows that differ by
    float32 reassociation (~1e-7) before rounding. The first frame (one
    cache row, no feedback) agrees within 1e-5. Later, where such a
    difference straddles a rounding boundary one cache entry moves by a
    bfloat16 ulp (2^-8 relative) and the feedback amplifies it, so the bar is
    relative to what the rounding itself does: the port's bfloat16 decode
    stays within a tenth of the gap between JAX's bfloat16 and float32
    decodes (both printed)."""
    src, src_lengths, jax_out = decode
    got = transformer.make_fast_generate(setup["port"], "bfloat16", device="cpu")(src, src_lengths)
    gap = _per_frame(got.numpy(), jax_out["bf16"])
    rounding = np.abs(jax_out["bf16"] - jax_out["f32"]).max()
    print(f"port vs JAX bf16: {gap.max():.3g}; JAX bf16 vs f32 caches: {rounding:.3g}")
    assert (gap[:, 0] <= 1e-5).all()
    assert gap.max() <= BF16_REL * rounding


def test_auto_generate_takes_the_buffer_inside_its_band(setup, decode, monkeypatch):
    port = setup["port"]
    src, src_lengths = map(torch.as_tensor, decode[:2])
    buffer = port.generate(src, src_lengths)
    fast = transformer.make_fast_generate(port, device="cpu")(src, src_lengths)
    auto = transformer.make_auto_generate(port, device="cpu")
    torch.testing.assert_close(auto(src, src_lengths), fast, rtol=0, atol=0)
    monkeypatch.setattr(transformer, "BUFFER_WINS_LO", 12)
    monkeypatch.setattr(transformer, "BUFFER_WINS_HI", 12)
    torch.testing.assert_close(auto(src, src_lengths), buffer, rtol=0, atol=0)
    bf16 = transformer.make_auto_generate(port, "bfloat16", device="cpu")
    torch.testing.assert_close(
        bf16(src, src_lengths),
        transformer.make_fast_generate(port, "bfloat16", device="cpu")(src, src_lengths),
        rtol=0, atol=0)


def _tree_gap(a, b):
    """max |a - b| over the arrays and CSV numbers of two artifact trees with
    the same files."""
    gap = 0.0
    for d, _, names in os.walk(b):
        for name in names:
            ref = os.path.join(d, name)
            got = os.path.join(a, os.path.relpath(ref, b))
            if name.endswith(".npy"):
                gap = max(gap, float(np.abs(np.load(got) - np.load(ref)).max()))
            elif name.endswith(".csv"):
                gap = max(gap, float(np.abs(np.subtract(_numbers(got), _numbers(ref))).max()))
    return gap


@pytest.fixture(scope="module")
def jax_cli_runs(setup, tmp_path_factory):
    """The JAX test CLI from the JAX ``best_model``: as it runs (the cached
    decode at this length) and with its buffer band stretched over every
    length (the buffer re-decode). Their gap is the JAX package's own spread
    on this corpus."""
    runs = {}
    cfg = {**setup["base"], "state_dict_filepath": str(setup["root"] / "jax_ckpts" / "best_model")}
    for name in ("cached", "buffer"):
        out = setup["root"] / f"jax_test_{name}"
        with pytest.MonkeyPatch.context() as monkeypatch:
            if name == "buffer":
                monkeypatch.setattr(jax_transformer, "BUFFER_WINS_LO", 1)
                monkeypatch.setattr(jax_transformer, "BUFFER_WINS_HI", 10**6)
            info = _run("artspeech_tpu", "test_phoneme_to_articulation_transformer", cfg, out,
                        monkeypatch, tmp_path_factory.mktemp(f"jax_cli_{name}"))
        runs[name] = (_flat(info), out)
    return runs


@pytest.mark.parametrize("form", ["best/state", "best", "best_model"])
def test_transformer_cli_matches_jax(setup, jax_cli_runs, tmp_path, monkeypatch, form):
    """The port's CLI against the JAX CLI's cached decode: the same
    ``test_results.json`` keys and ``test_outputs/`` files, headers and
    phonemes. Each number within the larger of 1e-5 and four times the gap
    between the JAX CLI's two decodes (cached and buffer) of the same number
    (for the results) or of the whole tree (for the artifacts): as in
    ``_check_generated``, the decode's feedback amplifies float32 noise, and
    on this corpus JAX does not reproduce its own results to 1e-5 (printed).
    The decode itself is held to JAX at 1e-5 per frame there."""
    (ref, ref_out), (buffer, buffer_out) = jax_cli_runs["cached"], jax_cli_runs["buffer"]
    out = tmp_path / "port_test"
    cfg = {**setup["base"], "state_dict_filepath": str(setup["root"] / "ckpts" / form)}
    info = _run("artspeech_tpu_torch", "test_phoneme_to_articulation_transformer", cfg, out,
                monkeypatch, tmp_path)
    with open(out / "test_results.json") as f:
        written = json.load(f)
    assert written == info and set(_flat(written)) == set(ref) == set(buffer)
    gaps = {k: abs(v - ref[k]) for k, v in _flat(written).items()}
    jax_gaps = {k: abs(buffer[k] - v) for k, v in ref.items()}
    tree_gap = _tree_gap(str(buffer_out / "test_outputs"), str(ref_out / "test_outputs"))
    print(f"results: port vs JAX {max(gaps.values()):.3g}, JAX cached vs buffer "
          f"{max(jax_gaps.values()):.3g}; artifacts: JAX cached vs buffer {tree_gap:.3g}")
    for key, gap in gaps.items():
        assert np.isfinite(gap) and gap <= max(1e-5, 4 * jax_gaps[key]), (key, gap, jax_gaps[key])
    tree = str(out / "test_outputs")
    _assert_same_tree(tree, str(ref_out / "test_outputs"), atol=max(1e-5, 4 * tree_gap))
    assert any(name == "tract_variables.csv" for _, _, names in os.walk(tree) for name in names)


def test_cli_defaults_and_refusals(setup, tmp_path, monkeypatch):
    cfg = {"batch_size": 12}
    assert generate_batch_size(cfg, torch.device("cuda")) == 64
    assert generate_batch_size(cfg, torch.device("cpu")) == 12
    assert generate_batch_size({**cfg, "generate_batch_size": 5}, torch.device("cuda")) == 5
    assert cache_dtype_from_cfg({}) == "bfloat16"
    for name in ("float32", "fp32", "none", "None"):
        assert cache_dtype_from_cfg({"generate_cache_dtype": name}) is None
    assert cache_dtype_from_cfg({"generate_cache_dtype": "float16"}) == "float16"
    # float16 caches and compute are ported; what neither package computes
    # in is refused (JAX's resolve_dtype raises KeyError there).
    with pytest.raises(ValueError, match="float32, bfloat16 or float16"):
        transformer.make_fast_generate(setup["port"], "float64", device="cpu")
    cfg = {**setup["base"], "model_kwargs": {**MODEL, "dtype": "float64"},
           "state_dict_filepath": str(setup["root"] / "ckpts" / "best_model")}
    with pytest.raises(ValueError, match="unknown compute dtype float64"):
        _run("artspeech_tpu_torch", "test_phoneme_to_articulation_transformer", cfg,
             tmp_path / "out", monkeypatch, tmp_path)


def test_training_forward_with_dropout_raises(setup):
    src, src_lengths, tgt, tgt_lengths = map(torch.as_tensor, _batch(setup["vocab_size"], 5, 4, 4))
    model = ArtSpeechTransformer(setup["vocab_size"], C, num_feat=N_FEAT, dropout=0.1, **MODEL,
                                 device="cpu")
    model.load_state_dict(setup["port"].state_dict())
    with torch.no_grad():  # eval mode: the dropout is accepted and inactive
        torch.testing.assert_close(model(src, tgt, src_lengths, tgt_lengths),
                                   setup["port"](src, tgt, src_lengths, tgt_lengths))
    model.train()  # training mode: the dropout masks need a generator
    with pytest.raises(ValueError, match="Generator"):
        model(src, tgt, src_lengths, tgt_lengths)
