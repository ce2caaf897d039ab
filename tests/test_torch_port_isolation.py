"""The port stands alone and never runs on the CPU by accident.

- No module of ``artspeech_tpu_torch`` (nor ``chip_smoke.py``) imports jax,
  flax, orbax, yaml, pandas (the card machine has neither of the last two)
  or anything of ``artspeech_tpu``.
- Importing the whole package leaves jax out of ``sys.modules``.
- Entry points called without ``device=`` raise where no CUDA device is.
- The GRU wrapper takes its plain version only for CPU tensors, without
  counting a launch, and raises for any other non-CUDA device.
- So do the GRU backward, P2CP and min-distance wrappers, and a gradient
  taken through the GRU on the CPU runs the plain backward without counting a
  launch.
- The CLIs' ``main`` and the test step raise without a GPU unless the CPU is
  asked for.
- So do ``ArtSpeechTransformer``, ``make_fast_generate``,
  ``make_auto_generate`` and the transformer test CLI; a decode on the CPU
  takes the flash decode-attend's plain version without counting a launch.
- So do the transformer train CLI and its train and eval steps; the fused
  training attention takes its plain versions on CPU tensors (forward and
  backward, through a training step too) without counting a launch, and
  raises on any other non-CUDA device.
- So do the autoencoder-based method's models, steps, test harness and CLIs.
- So do the mean-contour baseline's forward and CLIs; on the CPU its forward
  is a plain gather.
"""

import argparse
import ast
import os
import pkgutil
import subprocess
import sys

import numpy as np
import pytest
import torch

import artspeech_tpu_torch
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS
from artspeech_tpu_torch.models.artspeech_rnn import ArtSpeech, SimpleArtSpeech
from artspeech_tpu_torch.cli import (
    generate_vocal_tract_shape,
    test_phoneme_to_articulation,
    test_phoneme_to_articulation_transformer,
    test_phoneme_to_principal_components,
    test_phoneme_wise_mean_contour,
    test_principal_components_autoencoder,
    train_phoneme_to_articulation,
    train_phoneme_to_articulation_transformer,
    train_phoneme_to_principal_components,
    train_phoneme_wise_mean_contour,
    train_principal_components_autoencoder,
)
from artspeech_tpu_torch.eval import autoencoder as pc_eval
from artspeech_tpu_torch.models import mean_contour
from artspeech_tpu_torch.models.autoencoder import (
    MultiArticulatorAutoencoder,
    MultiDecoder,
    MultiEncoder,
)
from artspeech_tpu_torch.models.latent_rnn import PrincipalComponentsArtSpeech
from artspeech_tpu_torch.eval.articulation import make_test_step, run_test
from artspeech_tpu_torch.models.transformer import (
    ArtSpeechTransformer,
    make_auto_generate,
    make_fast_generate,
)
from artspeech_tpu_torch.ops import (
    _build,
    hopper_attention,
    hopper_gru,
    hopper_min_dist,
    hopper_p2cp,
    hopper_train_attention,
)
from artspeech_tpu_torch.synth import pipeline
from artspeech_tpu_torch.train import loop, pc_step, state
from artspeech_tpu_torch.train.step import (
    make_artspeech_eval_step,
    make_artspeech_train_step,
    make_transformer_eval_step,
    make_transformer_train_step,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "artspeech_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "orbax", "yaml", "pandas", "artspeech_tpu"}


def _sources():
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PKG):
        paths += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return paths


def _imported_roots(path):
    with open(path) as f:
        tree = ast.parse(f.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]


def test_no_forbidden_imports():
    sources = _sources()
    assert len(sources) > 20
    for module in ("ops/hopper_train_attention.py", "models/transformer.py", "train/step.py",
                   "cli/train_phoneme_to_articulation_transformer.py"):
        assert os.path.join(PKG, module) in sources
    offending = {os.path.relpath(p, REPO): sorted(set(_imported_roots(p)) & FORBIDDEN)
                 for p in sources}
    assert {p: mods for p, mods in offending.items() if mods} == {}


def test_importing_the_package_leaves_jax_out():
    modules = [m.name for m in pkgutil.walk_packages(artspeech_tpu_torch.__path__,
                                                     "artspeech_tpu_torch.")]
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "leaked = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{sorted(FORBIDDEN)!r})\n"
        "assert not leaked, leaked\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert len(modules) > 15


def _no_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")


def test_entry_points_raise_without_cuda_and_without_device():
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        ArtSpeech(12, 3, hidden_size=16)
    with pytest.raises(RuntimeError, match="CUDA"):
        SimpleArtSpeech(12, 3, hidden_size=16)
    model = ArtSpeech(12, len(RECOGNITION_ARTICULATORS), hidden_size=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.make_synthesis_step(model, RECOGNITION_ARTICULATORS)

    class _Empty:
        articulators = list(RECOGNITION_ARTICULATORS)
        data = []

        def __len__(self):
            return 0

    with pytest.raises(RuntimeError, match="CUDA"):
        pipeline.synthesize_corpus(model, _Empty(), "unused", None)


def _gru_inputs(device):
    rng = np.random.default_rng(0)
    t, b, h = 5, 3, 8
    xp = torch.from_numpy(rng.standard_normal((t, b, 3 * h)).astype(np.float32)).to(device)
    wh = torch.from_numpy(rng.standard_normal((h, 3 * h)).astype(np.float32)).to(device)
    bh = torch.zeros(3 * h, device=device)
    mask = torch.ones(t, b, dtype=torch.bool, device=device)
    return xp, wh, bh, mask


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    before = hopper_gru.launches
    xp, wh, bh, mask = _gru_inputs("cpu")
    for reverse in (False, True):
        got = hopper_gru.gru_sequence(xp, wh, bh, mask, reverse)
        torch.testing.assert_close(got, hopper_gru.gru_sequence_reference(xp, wh, bh, mask, reverse),
                                   rtol=0, atol=0)
    hopper_gru.bigru_sequence(torch.cat([xp, xp], -1), torch.stack([wh, wh]),
                              torch.stack([bh, bh]), mask)
    assert hopper_gru.launches == before
    assert _build._libraries == {}  # nothing was built or loaded


def test_other_devices_raise_instead_of_falling_back():
    before = hopper_gru.launches
    xp, wh, bh, mask = _gru_inputs("meta")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_gru.gru_sequence(xp, wh, bh, mask)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_gru.bigru_sequence(torch.cat([xp, xp], -1), torch.stack([wh, wh]),
                                  torch.stack([bh, bh]), mask)
    assert hopper_gru.launches == before


def test_training_entry_points_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_artspeech_train_step(1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_artspeech_eval_step(1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ArtSpeech(12, 3, hidden_size=16, dropout=0.1)
    model = ArtSpeech(12, 3, hidden_size=16, device="cpu")
    st = state.create_train_state(model, 1e-3)
    with pytest.raises(RuntimeError, match="CUDA"):
        loop.fit(st, [], [], None, None, 1, str(tmp_path))


def _bwd_inputs(device):
    xp, wh, bh, mask = _gru_inputs(device)
    ys = hopper_gru.gru_sequence(xp, wh, bh, mask) if device == "cpu" else torch.empty(
        xp.shape[0], xp.shape[1], wh.shape[0], device=device)
    return xp, wh[None], bh[None], mask, ys, torch.ones_like(ys)


def _p2cp_inputs(device):
    rng = np.random.default_rng(1)
    u, v = (torch.from_numpy(rng.random((3, 2, 2, 7)).astype(np.float32)).to(device)
            for _ in range(2))
    return u, v


def test_backward_and_p2cp_take_the_plain_version_on_cpu_without_a_launch():
    before = (hopper_gru.launches, hopper_gru.bwd_launches, hopper_p2cp.launches)
    xp, wh, bh, mask, ys, g = _bwd_inputs("cpu")
    dxp, dw, db = hopper_gru.gru_backward(xp, wh, bh, mask, ys, g, 0)
    ref = hopper_gru.gru_sequence_backward_reference(xp, wh[0], bh[0], mask, ys, g)
    for got, want in zip((dxp, dw[0], db[0]), ref):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    u, v = _p2cp_inputs("cpu")
    torch.testing.assert_close(hopper_p2cp.mean_p2cp_channel_major(u, v),
                               hopper_p2cp.mean_p2cp_channel_major_reference(u, v),
                               rtol=0, atol=0)
    assert (hopper_gru.launches, hopper_gru.bwd_launches, hopper_p2cp.launches) == before
    assert _build._libraries == {}


def test_gradient_through_the_gru_on_cpu_counts_no_launch():
    before = (hopper_gru.launches, hopper_gru.bwd_launches)
    xp, wh, bh, mask = (t.requires_grad_() if t.is_floating_point() else t
                        for t in _gru_inputs("cpu"))
    for reverse in (False, True):
        loss = hopper_gru.gru_sequence(xp, wh, bh, mask, reverse).square().sum()
        grads = torch.autograd.grad(loss, (xp, wh, bh))
        assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    ys = hopper_gru.bigru_sequence(torch.cat([xp, xp], -1), torch.stack([wh, wh]),
                                   torch.stack([bh, bh]), mask)
    grads = torch.autograd.grad(ys.sum(), (xp, wh, bh))
    assert all(torch.isfinite(g).all() for g in grads)
    assert (hopper_gru.launches, hopper_gru.bwd_launches) == before
    assert _build._libraries == {}


def test_backward_and_p2cp_raise_on_other_devices():
    before = (hopper_gru.bwd_launches, hopper_p2cp.launches)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_gru.gru_backward(*_bwd_inputs("meta"), 0)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_p2cp.mean_p2cp_channel_major(*_p2cp_inputs("meta"))
    assert (hopper_gru.bwd_launches, hopper_p2cp.launches) == before


def _min_dist_inputs(device):
    rng = np.random.default_rng(2)
    return (torch.from_numpy(rng.random((3, 4, 2, 15)).astype(np.float32)).to(device),
            torch.from_numpy(rng.random((3, 4, 2, 25)).astype(np.float32)).to(device))


def test_min_distance_takes_the_plain_version_on_cpu_and_raises_elsewhere():
    before = hopper_min_dist.launches
    u, v = _min_dist_inputs("cpu")
    got = hopper_min_dist.min_distance_channel_major(u, v)
    ref = hopper_min_dist.min_distance_channel_major_reference(u, v)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert got[0].shape == (3, 4) and got[1].dtype == torch.int64
    assert _build._libraries == {}
    with pytest.raises(ValueError, match="CUDA"):
        hopper_min_dist.min_distance_channel_major(*_min_dist_inputs("meta"))
    assert hopper_min_dist.launches == before


def test_cli_mains_and_test_step_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    args = argparse.Namespace(device="cuda", output_dir=str(tmp_path), checkpoint_filepath=None)
    for cli in (train_phoneme_to_articulation, test_phoneme_to_articulation,
                generate_vocal_tract_shape):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main({}, args, tracker=None)
    model = ArtSpeech(12, len(RECOGNITION_ARTICULATORS), hidden_size=16, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_test_step(model, RECOGNITION_ARTICULATORS)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_test(model, [], RECOGNITION_ARTICULATORS, 1.0)


def test_principal_components_entry_points_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    indices = {"lower-lip": 2, "tongue": 2}
    stats = np.zeros((2, 2, 3), np.float32)
    for build in (lambda: MultiArticulatorAutoencoder(indices, 6, 4),
                  lambda: MultiEncoder(indices, 6, 4), lambda: MultiDecoder(indices, 6, 4),
                  lambda: PrincipalComponentsArtSpeech(12, indices, 8, 8, rnn="LSTM"),
                  lambda: pc_step.make_autoencoder_train_step(indices, 0.1, stats, stats, 1.0),
                  lambda: pc_step.make_autoencoder_eval_step(indices, 0.1, stats, stats, 1.0),
                  lambda: pc_step.make_latent_rnn_train_step(None, None, stats, stats, 1.0),
                  lambda: pc_step.make_latent_rnn_eval_step(None, None, stats, stats, 1.0),
                  lambda: pc_eval.nomograms(None, 4, stats, stats)):
        with pytest.raises(RuntimeError, match="CUDA"):
            build()
    model = PrincipalComponentsArtSpeech(12, indices, 8, 8, rnn="LSTM", device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        pc_eval.run_latent_rnn_test(model, None, [], sorted(indices), stats, stats, 1.0)
    args = argparse.Namespace(device="cuda", output_dir=str(tmp_path), checkpoint_filepath=None)
    for cli in (train_principal_components_autoencoder, test_principal_components_autoencoder,
                train_phoneme_to_principal_components, test_phoneme_to_principal_components):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main({}, args, tracker=None)


def test_mean_contour_entry_points_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    table = mean_contour.MeanContourTable(np.arange(24, dtype=np.float32).reshape(3, 1, 2, 4),
                                          np.ones(3, np.int64))
    with pytest.raises(RuntimeError, match="CUDA"):
        mean_contour.make_mean_contour_forward(table)
    args = argparse.Namespace(device="cuda", output_dir=str(tmp_path), checkpoint_filepath=None)
    for cli in (train_phoneme_wise_mean_contour, test_phoneme_wise_mean_contour):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main({}, args, tracker=None)
    got = mean_contour.make_mean_contour_forward(table, device="cpu")(torch.tensor([[2, 0]]))
    assert got.device.type == "cpu" and torch.equal(got[0], torch.from_numpy(table.table[[2, 0]]))


TINY_TRANSFORMER = {"embed_dim": 8, "num_heads": 2, "num_layers": 1, "num_feat": 6,
                    "encoder_ff_dim": 8}


def test_transformer_entry_points_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    with pytest.raises(RuntimeError, match="CUDA"):
        ArtSpeechTransformer(12, 3, **TINY_TRANSFORMER)
    model = ArtSpeechTransformer(12, 3, **TINY_TRANSFORMER, device="cpu")
    for make in (make_fast_generate, make_auto_generate):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(model)
    args = argparse.Namespace(device="cuda", output_dir=str(tmp_path), checkpoint_filepath=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        test_phoneme_to_articulation_transformer.main({}, args, tracker=None)


def test_cpu_decode_takes_the_plain_attend_without_a_launch():
    model = ArtSpeechTransformer(12, 3, **TINY_TRANSFORMER, device="cpu")
    src = torch.tensor([[1, 2, 3, 4, 5], [6, 7, 8, 0, 0]], dtype=torch.int32)
    lengths = torch.tensor([5, 3], dtype=torch.int32)
    before = hopper_attention.launches
    for cache_dtype in (None, "bfloat16"):
        out = make_fast_generate(model, cache_dtype, device="cpu")(src, lengths)
        assert out.shape == (2, 5, 3, 2, 3) and bool(torch.isfinite(out).all())
    assert hopper_attention.launches == before
    assert "flash_decode" not in _build._libraries


def _attend_inputs(device):
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((4, 6, 4)).astype(np.float32)).to(device)
               for _ in range(3))
    return q, k, v, torch.ones(1, 6, 6, device=device), 1


def test_training_attention_takes_the_plain_versions_on_cpu_without_a_launch():
    before = (hopper_train_attention.launches_fwd, hopper_train_attention.launches_bwd)
    q, k, v, keep, n_pairs = _attend_inputs("cpu")
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = hopper_train_attention.fused_causal_attend(q, k, v, keep, n_pairs)
    torch.testing.assert_close(
        out, hopper_train_attention.fused_causal_attend_reference(q, k, v, keep, n_pairs),
        rtol=0, atol=0)
    grads = torch.autograd.grad(out.square().sum(), (q, k, v))
    assert all(torch.isfinite(g).all() and g.abs().sum() > 0 for g in grads)
    model = ArtSpeechTransformer(12, 3, **TINY_TRANSFORMER, dropout=0.1, device="cpu")
    st = state.create_train_state(model, 1e-3)
    batch = {"tokens": np.array([[1, 2, 3, 4], [5, 6, 0, 0]], np.int32),
             "targets": np.full((2, 4, 3, 2, 3), 0.5, np.float32),
             "lengths": np.array([4, 2], np.int32)}
    metrics = make_transformer_train_step(1.0, device="cpu")(st, batch, torch.Generator())
    assert torch.isfinite(metrics["loss"])
    assert (hopper_train_attention.launches_fwd, hopper_train_attention.launches_bwd) == before
    assert "train_attention" not in _build._libraries


def test_training_attention_raises_on_other_devices():
    before = (hopper_train_attention.launches_fwd, hopper_train_attention.launches_bwd)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_train_attention.fused_causal_attend(*_attend_inputs("meta"))
    q, k, v, keep, n_pairs = _attend_inputs("cpu")
    with pytest.raises(ValueError, match="CUDA"):
        hopper_train_attention.fused_causal_attend_fwd(q, k, v, keep, n_pairs)
    with pytest.raises(ValueError, match="CUDA"):
        hopper_train_attention.fused_causal_attend_bwd(q, k, v, keep, q, q[..., 0], q, n_pairs)
    assert (hopper_train_attention.launches_fwd, hopper_train_attention.launches_bwd) == before


def test_transformer_training_entry_points_raise_without_cuda_and_without_device(tmp_path):
    _no_cuda()
    for make in (make_transformer_train_step, make_transformer_eval_step):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(1.0)
    args = argparse.Namespace(device="cuda", output_dir=str(tmp_path), checkpoint_filepath=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_phoneme_to_articulation_transformer.main({}, args, tracker=None)
