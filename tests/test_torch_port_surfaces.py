"""The port's remaining user surfaces against the JAX package's, on the CPU.

Same numpy-seeded inputs through both packages:
- ``build_report`` over the same fake test outputs: the four CSVs read back
  with pandas have the same headers, and values within 1e-5 relative with
  NaN where NaN (a one-frame sentence's std, a constant target's missing
  correlation); the report CLI says in one line that plots were skipped
  without matplotlib;
- the sentence layers (``make_sentence_layers`` and its CLI): identical tiers;
- ``xarticul_to_npy``, ``set_seeds`` (the same numpy and ``random`` draws)
  and ``assert_expression``;
- ``dcm_to_npy`` and ``make_dataset_videos`` through stub ``pydicom`` /
  ``cv2`` modules: the same frames written, and the same error without them;
- the plots of ``save_vocal_tract_shapes`` and of the plot CLI: the same jpg
  names (matplotlib is present here);
- ``fit``'s ``epoch_callback``: the same epochs and record keys;
- the backward of the P2CP and min-distance autograd functions (the kernel's
  forward stood in for by the plain version, as there is no card here):
  against ``jax.vjp`` of JAX's ``_mean_p2cp_fast`` and of its tract
  variables, within 1e-4 * max(|ref|, 1);
- ``utils/profiling``: ``StepTimer.summary`` has JAX's keys, ``trace`` writes
  a Chrome trace holding ``annotate``'s region.
"""

import argparse
import json
import os
import random
import shutil
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from artspeech_tpu.core.config import DATASET_CONFIG as JAX_DATASET_CONFIG
from artspeech_tpu.data import textgrid as jax_textgrid
from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu.eval.report import build_report as jax_build_report
from artspeech_tpu.geometry import tract_variables as jax_tvs
from artspeech_tpu.ops.distances import _mean_p2cp_fast
from artspeech_tpu.synth import viz as jax_viz
from artspeech_tpu.utils import io as jax_io
from artspeech_tpu.utils import profiling as jax_profiling
from artspeech_tpu_torch.cli import report_phoneme_to_articulation
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import RECOGNITION_ARTICULATORS, UPPER_INCISOR
from artspeech_tpu_torch.data import sentence_layer, textgrid
from artspeech_tpu_torch.eval.report import build_report, read_csv_table
from artspeech_tpu_torch.geometry import tract_variables
from artspeech_tpu_torch.ops import hopper_min_dist, hopper_p2cp
from artspeech_tpu_torch.synth import viz
from artspeech_tpu_torch.train import loop, state
from artspeech_tpu_torch.utils import io, profiling

REPORT_ARTS = ["lower-lip", "tongue", "upper-lip"]
TOL = 1e-5
GRAD_TOL = 1e-4


def _args(tmp_path, device="cpu"):
    return argparse.Namespace(device=device, output_dir=str(tmp_path), checkpoint_filepath=None)


def _cli(package, name):
    return __import__(f"{package}.cli.{name}", fromlist=["main"])


# The report ------------------------------------------------------------------

def _write_fake_sentence(results_dir, name, n_frames, rng, constant_la=False, drop=None):
    """One sentence of test outputs as the test CLIs write them: contours
    (pred and true), phonemes.csv and tract_variables.csv."""
    sdir = os.path.join(results_dir, "test_outputs", "0", name)
    os.makedirs(os.path.join(sdir, "contours"))
    rows, tv_rows = [], []
    for t in range(n_frames):
        frame = f"{t + 1:04d}"
        phoneme = "a" if t < n_frames // 2 else "p"
        rows.append({"sentence": name, "frame": frame, "phoneme": phoneme})
        tv_row = {"sentence": name, "frame": frame, "phoneme": phoneme}
        for tv in ("LA", "TTCD", "TBCD", "VEL"):
            tv_row[f"{tv}_target"] = 0.05 if constant_la and tv == "LA" else rng.uniform(0.01, 0.2)
            tv_row[f"{tv}_pred"] = rng.uniform(0.01, 0.2)
            for w in ("target", "pred"):
                for p in ("poc_1", "poc_2"):
                    tv_row[f"{tv}_{w}_{p}_x"] = rng.uniform()
                    tv_row[f"{tv}_{w}_{p}_y"] = rng.uniform()
        tv_rows.append(tv_row)
        for art in REPORT_ARTS:
            for suffix in ("", "_true"):
                if drop == (t, art, suffix):
                    continue
                np.save(os.path.join(sdir, "contours", f"{frame}_{art}{suffix}.npy"),
                        rng.uniform(size=(2, 50)).astype(np.float32))
    pd.DataFrame(rows).to_csv(os.path.join(sdir, "phonemes.csv"), index=False)
    # Written out of frame order: the report sorts by (sentence, frame).
    pd.DataFrame(tv_rows[::-1]).to_csv(os.path.join(sdir, "tract_variables.csv"), index=False)


@pytest.fixture(scope="module")
def fake_results(tmp_path_factory):
    """Three sentences: one with a frame missing a true contour, one of a
    single frame (std NaN, no correlation), one with a constant LA target."""
    root = tmp_path_factory.mktemp("fake_results")
    rng = np.random.default_rng(0)
    _write_fake_sentence(str(root), "s1_S01-0.0_1.0", 5, rng, drop=(2, "tongue", "_true"))
    _write_fake_sentence(str(root), "s1_S01-1.0_1.1", 1, rng)
    _write_fake_sentence(str(root), "s1_S02-0.0_0.8", 3, rng, constant_la=True)
    return root


def _assert_same_csv(got, ref, **read):
    got, ref = pd.read_csv(got, **read), pd.read_csv(ref, **read)
    assert list(got.columns) == list(ref.columns) and len(got) == len(ref)
    for column in ref.columns:
        if pd.api.types.is_numeric_dtype(ref[column]):
            np.testing.assert_allclose(got[column].to_numpy(np.float64),
                                       ref[column].to_numpy(np.float64), rtol=TOL, atol=0,
                                       equal_nan=True, err_msg=str(column))
        else:
            assert got[column].tolist() == ref[column].tolist(), column


def test_report_matches_jax(fake_results, tmp_path):
    dirs = {}
    for package, build, config in (("jax", jax_build_report, JAX_DATASET_CONFIG),
                                   ("port", build_report, DATASET_CONFIG)):
        dirs[package] = tmp_path / package
        shutil.copytree(fake_results, dirs[package])
        kwargs = {"device": "cpu"} if package == "port" else {}
        report = build(str(dirs[package]), REPORT_ARTS, config["artspeech"], make_plots=False,
                       **kwargs)
    assert report["plots_skipped"] is False
    for name in ("tract_variables.csv", "error_report_full.csv", "TV_corr_report.csv"):
        _assert_same_csv(dirs["port"] / name, dirs["jax"] / name)
    _assert_same_csv(dirs["port"] / "error_report_agg.csv", dirs["jax"] / "error_report_agg.csv",
                     header=[0, 1])
    with open(dirs["port"] / "error_report_agg.csv") as f_got, \
            open(dirs["jax"] / "error_report_agg.csv") as f_ref:
        assert f_got.read().splitlines()[:2] == f_ref.read().splitlines()[:2]
    # 4 + 1 + 3 frames with all contours, 3 articulators each.
    assert len(report["errors"].rows) == 8 * 3
    corr = pd.read_csv(dirs["port"] / "TV_corr_report.csv")
    la = corr[corr.TV == "LA"].iloc[0]
    # LA: only the first sentence has a correlation (one frame; constant).
    assert np.isnan(la["std"]) and la["min"] == la["max"] == la["mean"]
    tvs = pd.read_csv(dirs["port"] / "tract_variables.csv")
    assert list(tvs.frame) == [1, 2, 3, 4, 5, 1, 1, 2, 3]


def test_report_cli_says_when_plots_are_skipped(fake_results, tmp_path, monkeypatch, capsys):
    shutil.copytree(fake_results, tmp_path / "results")
    cfg = {"database_name": "artspeech", "results_dir": str(tmp_path / "results"),
           "articulators": REPORT_ARTS}
    monkeypatch.setitem(sys.modules, "matplotlib", None)  # ``import matplotlib`` raises
    report = report_phoneme_to_articulation.main(cfg, _args(tmp_path), tracker=None)
    assert report["plots_skipped"]
    assert capsys.readouterr().out.count("TV plots skipped: matplotlib is not installed") == 1
    assert not any("plots" in dirs for _, dirs, _ in os.walk(tmp_path / "results"))
    assert os.path.isfile(tmp_path / "results" / "error_report_agg.csv")


def test_report_draws_one_tv_plot_a_sentence(fake_results, tmp_path):
    pytest.importorskip("matplotlib")
    name = "s1_S02-0.0_0.8"
    shutil.copytree(fake_results / "test_outputs" / "0" / name,
                    tmp_path / "results" / "test_outputs" / "0" / name)
    report = build_report(str(tmp_path / "results"), REPORT_ARTS, DATASET_CONFIG["artspeech"],
                          device="cpu")
    assert not report["plots_skipped"]
    assert _jpgs(tmp_path / "results") == [
        os.path.join("test_outputs", "0", name, "plots", f"TVs_{name}.jpg")]


def test_csv_reader_types_columns_as_pandas(tmp_path):
    path = tmp_path / "t.csv"
    path.write_text("sentence,frame,phoneme,x,y\ns1,0001,a,0.5,\ns2,0010,#,1,2.5\n")
    table = read_csv_table(str(path))
    ref = pd.read_csv(path)
    assert table.columns == list(ref.columns)
    assert table.column("frame") == [1, 10] and table.column("sentence") == ["s1", "s2"]
    assert table.column("x") == [0.5, 1.0] and np.isnan(table.column("y")[0])
    for column in ("frame", "x", "y"):
        np.testing.assert_array_equal(np.array(table.column(column), float),
                                      ref[column].to_numpy(float))


# Sentence layers -------------------------------------------------------------

def _grid(module):
    iv, tier = module.Interval, module.IntervalTier
    words = [("#", 0.0, 0.4), ("hello", 0.4, 0.9), ("hello", 0.9, 1.0), ("#", 1.0, 1.8),
             ("world", 1.8, 2.2), ("#", 2.2, 4.0), ("again", 4.0, 4.5), ("#", 4.5, 5.0)]
    phones = [("#", 0.0, 0.4), ("h", 0.4, 0.6), ("e", 0.6, 1.0), ("#", 1.0, 1.8),
              ("w", 1.8, 2.2), ("#", 2.2, 4.0), ("a", 4.0, 4.5), ("#", 4.5, 5.0)]
    return module.TextGrid([tier("WordTier", [iv(a, b, t) for t, a, b in words]),
                            tier("PhonTier", [iv(a, b, t) for t, a, b in phones])])


def _tiers(grid):
    return [(t.name, [(iv.start_time, iv.end_time, iv.text) for iv in t.intervals])
            for t in grid.tiers]


def test_sentence_layers_match_jax(tmp_path):
    from artspeech_tpu.data.sentence_layer import make_sentence_layers as jax_layers

    got = _tiers(sentence_layer.make_sentence_layers(_grid(textgrid)))
    assert got == _tiers(jax_layers(_grid(jax_textgrid)))
    assert [name for name, _ in got] == ["LongSentenceTier", "ShortSentenceTier", "WordTier",
                                        "PhonTier"]
    # Both CLIs over the same TextGrid files write the same tiers.
    for i in range(2):
        os.makedirs(tmp_path / "corpus" / f"S0{i}")
        jax_textgrid.write_textgrid(_grid(jax_textgrid),
                                    str(tmp_path / "corpus" / f"S0{i}" / f"S0{i}.textgrid"))
    written = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        cfg = {"glob": str(tmp_path / "corpus" / "*" / "*.textgrid"),
               "save_to": str(tmp_path / package)}
        written[package] = _cli(package, "make_sentence_layer").main(cfg, _args(tmp_path), None)
    assert [os.path.basename(p) for p in written["artspeech_tpu_torch"]] == \
        [os.path.basename(p) for p in written["artspeech_tpu"]]
    for got_path, ref_path in zip(written["artspeech_tpu_torch"], written["artspeech_tpu"]):
        assert _tiers(textgrid.read_textgrid(got_path)) == \
            _tiers(jax_textgrid.read_textgrid(ref_path))


# IO helpers ------------------------------------------------------------------

def test_io_helpers_match_jax(tmp_path):
    points = np.random.default_rng(3).uniform(0, 136, (50, 2))
    path = str(tmp_path / "contour.txt")
    io.npy_to_xarticul(points, path)
    np.testing.assert_array_equal(io.xarticul_to_npy(path), jax_io.xarticul_to_npy(path))
    np.testing.assert_allclose(io.xarticul_to_npy(path), points, rtol=1e-12)
    draws = []
    for set_seeds in (jax_io.set_seeds, io.set_seeds):
        set_seeds(worker_id=3, base_seed=2**32 + 5)
        draws.append((np.random.rand(4).tolist(), random.random()))
    assert draws[0] == draws[1]
    io.assert_expression(True)
    for assert_expression in (jax_io.assert_expression, io.assert_expression):
        with pytest.raises(ValueError, match="bad"):
            assert_expression(0, ValueError, "bad")


# DICOM import and dataset videos through stub modules --------------------------

def _stub_pydicom():
    module = types.ModuleType("pydicom")
    module.dcmread = lambda path: types.SimpleNamespace(pixel_array=np.load(path))
    return module


def test_dcm_to_npy_matches_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(4)
    src = tmp_path / "src"
    for i, shape in enumerate(((3, 8, 8), (8, 8))):
        os.makedirs(src / f"S0{i}")
        with open(src / f"S0{i}" / f"cine{i}.dcm", "wb") as f:
            np.save(f, rng.integers(0, 4096, shape).astype(np.uint16))
    trees = {}
    monkeypatch.setitem(sys.modules, "pydicom", _stub_pydicom())
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        tree = tmp_path / package
        shutil.copytree(src, tree)
        cfg = {"glob": str(tree / "*" / "*.dcm")}
        assert _cli(package, "dcm_to_npy").main(cfg, _args(tmp_path), None) == 4
        trees[package] = {os.path.relpath(os.path.join(d, n), tree): np.load(os.path.join(d, n))
                          for d, _, names in os.walk(tree) for n in names if n.endswith(".npy")}
    assert sorted(trees["artspeech_tpu_torch"]) == sorted(trees["artspeech_tpu"])
    assert sorted(trees["artspeech_tpu"])[0] == os.path.join("S00", "NPY_MR", "0001.npy")
    for name, array in trees["artspeech_tpu"].items():
        np.testing.assert_array_equal(trees["artspeech_tpu_torch"][name], array)
    monkeypatch.setitem(sys.modules, "pydicom", None)
    messages = []
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        with pytest.raises(RuntimeError) as err:
            _cli(package, "dcm_to_npy").main({"glob": "*.dcm"}, _args(tmp_path), None)
        messages.append(str(err.value))
    assert messages[0] == messages[1] and "pydicom" in messages[0]


def _stub_cv2(frames):
    """cv2's calls that make_dataset_videos makes, in numpy; each writer's
    frames are kept in ``frames`` by path."""
    module = types.ModuleType("cv2")
    module.COLOR_GRAY2BGR = 8

    class VideoWriter:
        def __init__(self, path, fourcc, fps, size):
            self.path, self.meta = path, (fourcc, fps, size)
            frames[path] = []

        def write(self, img):
            frames[self.path].append(img.copy())

        def release(self):
            frames[self.path].append(self.meta)

    module.VideoWriter = VideoWriter
    module.VideoWriter_fourcc = lambda *chars: "".join(chars)
    module.cvtColor = lambda img, code: np.repeat(img[..., None], 3, axis=-1)

    def resize(img, size):
        return np.repeat(np.repeat(img, size[1] // img.shape[0], 0), size[0] // img.shape[1], 1)

    def polylines(img, pts, closed, color, thickness):
        for p in pts[0][:, 0]:
            if 0 <= p[1] < img.shape[0] and 0 <= p[0] < img.shape[1]:
                img[p[1], p[0]] = color

    module.resize, module.polylines = resize, polylines
    return module


def test_make_dataset_videos_matches_jax(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    make_synthetic_corpus(str(corpus), sequences=("S01",), n_sentences=1, frames_per_sentence=4)
    os.makedirs(corpus / "s1" / "S01" / "NPY_MR")
    rng = np.random.default_rng(5)
    for frame in ("0001", "0003"):
        np.save(corpus / "s1" / "S01" / "NPY_MR" / f"{frame}.npy",
                rng.integers(0, 4096, (136, 136)).astype(np.uint16))
    frames = {}
    monkeypatch.setitem(sys.modules, "cv2", _stub_cv2(frames))
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        cfg = {"datadir": str(corpus), "database_name": "gottingen", "seq_dict": {"s1": ["S01"]},
               "save_to": str(tmp_path / package)}
        written = _cli(package, "make_dataset_videos").main(cfg, _args(tmp_path), None)
        assert written == [str(tmp_path / package / "s1_S01.avi")]
    got, ref = (frames[str(tmp_path / p / "s1_S01.avi")]
                for p in ("artspeech_tpu_torch", "artspeech_tpu"))
    assert len(ref) == 5 and got[-1] == ref[-1]  # four frames, then the writer's settings
    for a, b in zip(got[:-1], ref[:-1]):
        np.testing.assert_array_equal(a, b)
    assert (ref[0] == (0, 255, 255)).all(-1).any()  # the contours are drawn
    monkeypatch.setitem(sys.modules, "cv2", None)
    messages = []
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        with pytest.raises(RuntimeError) as err:
            _cli(package, "make_dataset_videos").main({}, _args(tmp_path), None)
        messages.append(str(err.value))
    assert messages[0] == messages[1] == "make_dataset_videos requires cv2"


# Plots -------------------------------------------------------------------------

def _jpgs(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names if n.endswith(".jpg"))


def test_vocal_tract_plots_match_jax_names(tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    outputs = np.random.default_rng(6).uniform(size=(3, 2, 2, 50)).astype(np.float32)
    arts = ["tongue", "upper-lip"]
    assert jax_viz.save_vocal_tract_shapes(arts, outputs, ["a", "b"], str(tmp_path / "jax")) \
        is None
    assert viz.save_vocal_tract_shapes(arts, outputs, ["a", "b"], str(tmp_path / "port"))
    assert _jpgs(tmp_path / "port") == _jpgs(tmp_path / "jax") == ["0001.jpg", "0002.jpg",
                                                                    "0003.jpg"]
    img = np.arange(100, dtype=np.uint16).reshape(10, 10)
    np.testing.assert_array_equal(viz.uint16_to_uint8(img), jax_viz.uint16_to_uint8(img))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert viz.save_vocal_tract_shapes(arts, outputs, [], str(tmp_path / "none")) is False
    assert viz.make_vocal_tract_shape_video(arts, outputs, [], str(tmp_path / "v.avi")) is False
    assert viz.plot_vocal_tract_shape({"tongue": outputs[0, 0]}) is None
    assert viz.missing_packages("matplotlib", "numpy") == ["matplotlib"]


def test_plot_cli_matches_jax_names(fake_results, tmp_path, monkeypatch):
    pytest.importorskip("matplotlib")
    counts = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        shutil.copytree(fake_results, tmp_path / package)
        cfg = {"results_dir": str(tmp_path / package), "articulators": REPORT_ARTS}
        counts[package] = _cli(package, "plot_phoneme_to_articulation_outputs").main(
            cfg, _args(tmp_path), None)
    assert counts["artspeech_tpu_torch"] == counts["artspeech_tpu"] == 9
    assert _jpgs(tmp_path / "artspeech_tpu_torch") == _jpgs(tmp_path / "artspeech_tpu")
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(RuntimeError, match="matplotlib"):
        _cli("artspeech_tpu_torch", "plot_phoneme_to_articulation_outputs").main(
            cfg, _args(tmp_path), None)


# fit's epoch callback ------------------------------------------------------------

class _Loader(list):
    batch_size = collate_batch_size = 2


def test_fit_epoch_callback_matches_jax(tmp_path):
    from flax.training import train_state as flax_train_state

    from artspeech_tpu.train import loop as jax_loop
    from artspeech_tpu.train.state import make_optimizer

    batch = {"x": np.ones((2, 3), np.float32)}
    metrics = iter([3.0, 2.0, 2.5])

    def jax_eval(st, b):
        return {"loss": jnp.asarray(1.0), "p2cp_mm": jnp.asarray(next(metrics))}, None

    jax_calls = []
    st = flax_train_state.TrainState.create(apply_fn=None, params={"w": jnp.zeros(3)},
                                            tx=make_optimizer(1e-3))
    jax_loop.fit(st, _Loader([(batch, {"n_real": 2})]), _Loader([(batch, {"n_real": 2})]),
                 lambda s, b, rng: (s, {"loss": jnp.asarray(0.5)}), jax_eval, 3,
                 str(tmp_path / "jax"), epoch_callback=lambda e, s, r: jax_calls.append((e, r)))

    port_metrics = iter([3.0, 2.0, 2.5])
    port_calls = []
    port_state = state.create_train_state(torch.nn.Linear(3, 1), 1e-3)
    loop.fit(port_state, [(batch, {"n_real": 2})], [(batch, {"n_real": 2})],
             lambda s, b, g: {"loss": torch.tensor(0.5)},
             lambda s, b: ({"loss": torch.tensor(1.0), "p2cp_mm": torch.tensor(next(port_metrics))},
                           None),
             3, str(tmp_path / "port"), device="cpu",
             epoch_callback=lambda e, s, r: port_calls.append((e, s, r)))
    assert [e for e, _, _ in port_calls] == [e for e, _ in jax_calls] == [0, 1, 2]
    assert [list(r) for _, _, r in port_calls] == [list(r) for _, r in jax_calls]
    assert [r["best"] for _, _, r in port_calls] == [r["best"] for _, r in jax_calls]
    assert all(s is port_state for _, s, _ in port_calls)


# Gradients through the distance kernels' autograd functions --------------------

def _fake_p2cp_launch(calls):
    def launch(u, v):
        calls.append(1)
        return hopper_p2cp.mean_p2cp_channel_major_reference(u.float(), v.float())
    return launch


def _fake_min_dist_launch(calls):
    def launch(sources, problems, with_idx):
        calls.append(1)
        sources = [s.float() for s in sources]
        out = hopper_min_dist.min_distance_windows_reference(sources, problems)
        idx = None
        if with_idx:
            _, i, j = hopper_min_dist.min_distance_channel_major_reference(*sources)
            idx = torch.stack([i, j])[:, None]
        return out, idx
    return launch


def test_p2cp_autograd_backward_matches_jax_vjp(monkeypatch):
    calls = []
    monkeypatch.setattr(hopper_p2cp, "_launch", _fake_p2cp_launch(calls))
    rng = np.random.default_rng(7)
    u = rng.uniform(size=(3, 4, 2, 50)).astype(np.float32)
    v = rng.uniform(size=(3, 4, 2, 37)).astype(np.float32)
    g = rng.standard_normal((3, 4)).astype(np.float32)
    @jax.jit
    def jax_vjp(a, b, cotangent):
        out, vjp = jax.vjp(lambda x, y: _mean_p2cp_fast(jnp.swapaxes(x, -1, -2),
                                                        jnp.swapaxes(y, -1, -2)), a, b)
        return out, vjp(cotangent)

    value, refs = jax_vjp(u, v, g)
    tu, tv = (torch.from_numpy(a).requires_grad_() for a in (u, v))
    out = hopper_p2cp._MeanP2CP.apply(tu, tv)
    got = torch.autograd.grad(out, (tu, tv), torch.from_numpy(g))
    assert len(calls) == 1
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(value), rtol=TOL)
    for a, r in zip(got, refs):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= GRAD_TOL * max(np.abs(r).max(), 1.0)
    # Only one side asks for a gradient.
    out = hopper_p2cp._MeanP2CP.apply(tu.detach(), tv)
    (gv,) = torch.autograd.grad(out, (tv,), torch.from_numpy(g))
    np.testing.assert_allclose(gv.numpy(), got[1].numpy(), rtol=0, atol=0)


def test_p2cp_wrapper_takes_the_autograd_function_only_when_grad_is_asked(monkeypatch):
    calls = []
    monkeypatch.setattr(hopper_p2cp, "_launch", _fake_p2cp_launch(calls))
    u, v = (torch.empty(2, 3, 2, 50, device="meta") for _ in range(2))
    out = hopper_p2cp.mean_p2cp_channel_major(u, v)
    assert out.grad_fn is None and len(calls) == 1
    out = hopper_p2cp.mean_p2cp_channel_major(u.requires_grad_(), v)
    assert type(out.grad_fn).__name__ == "_MeanP2CPBackward" and len(calls) == 2
    with torch.no_grad():
        assert hopper_p2cp.mean_p2cp_channel_major(u, v).grad_fn is None


def test_tract_variables_autograd_backward_matches_jax_vjp(monkeypatch):
    calls = []
    monkeypatch.setattr(hopper_min_dist, "_launch", _fake_min_dist_launch(calls))
    arts = sorted(set(RECOGNITION_ARTICULATORS) | {UPPER_INCISOR})
    rng = np.random.default_rng(8)
    stack = rng.uniform(size=(2, 5, len(arts), 2, 50)).astype(np.float32)
    names = ("LA", "TTCD", "TBCD", "VEL")
    g_value = rng.standard_normal((4, 2, 5)).astype(np.float32)
    g_pocs = rng.standard_normal((4, 2, 5, 4)).astype(np.float32)

    def jax_fn(s):
        tvs = jax_tvs.tract_variables_from_stack(s, arts)
        return (jnp.stack([tvs[n]["value"] for n in names]),
                jnp.stack([jnp.concatenate([tvs[n]["poc_1"], tvs[n]["poc_2"]], -1)
                           for n in names]))

    # Eager, as under jit XLA may fuse the squared distances differently in
    # the min and in its tie mask, which then finds no winner.
    (value, pocs), vjp = jax.vjp(jax_fn, stack)
    tstack = torch.from_numpy(stack).requires_grad_()
    sources, problems = tract_variables.tv_table({a: 50 for a in arts})
    out = hopper_min_dist._MinDistanceWindows.apply(
        problems, *[tstack[..., arts.index(name), :, :] for name in sources])
    assert len(calls) == 1
    np.testing.assert_allclose(out[..., 0].detach().numpy(), np.asarray(value), rtol=TOL)
    np.testing.assert_allclose(out[..., 1:].detach().numpy(), np.asarray(pocs), rtol=TOL)
    for g_out, cotangent in ((np.concatenate([g_value[..., None], 0 * g_pocs], -1),
                              (g_value, 0 * g_pocs)),
                             (np.concatenate([g_value[..., None], g_pocs], -1),
                              (g_value, g_pocs))):
        (got,) = torch.autograd.grad(out, (tstack,), torch.from_numpy(g_out), retain_graph=True)
        ref = np.asarray(vjp(tuple(jnp.asarray(c) for c in cotangent))[0])
        assert np.abs(got.numpy() - ref).max() <= GRAD_TOL * max(np.abs(ref).max(), 1.0)
        assert np.abs(ref).max() > 0


def test_min_distance_autograd_backward_matches_jax(monkeypatch):
    from artspeech_tpu.ops.distances import min_distance as jax_min_distance

    calls = []
    monkeypatch.setattr(hopper_min_dist, "_launch", _fake_min_dist_launch(calls))
    rng = np.random.default_rng(9)
    u = rng.uniform(size=(3, 2, 15)).astype(np.float32)
    v = rng.uniform(size=(3, 2, 25)).astype(np.float32)
    g = rng.standard_normal(3).astype(np.float32)
    value, vjp = jax.vjp(lambda a, b: jax_min_distance(jnp.swapaxes(a, -1, -2),
                                                       jnp.swapaxes(b, -1, -2))[0], u, v)
    refs = vjp(jnp.asarray(g))
    tu, tv = (torch.from_numpy(a).requires_grad_() for a in (u, v))
    dist, iu, iv = hopper_min_dist._MinDistance.apply(tu, tv)
    assert len(calls) == 1 and not iu.requires_grad and iu.dtype == torch.int64
    np.testing.assert_allclose(dist.detach().numpy(), np.asarray(value), rtol=TOL)
    got = torch.autograd.grad(dist, (tu, tv), torch.from_numpy(g))
    for a, r in zip(got, refs):
        r = np.asarray(r)
        assert np.abs(a.numpy() - r).max() <= GRAD_TOL * max(np.abs(r).max(), 1.0)


def test_min_distance_wrappers_take_the_autograd_functions_only_when_grad_is_asked(monkeypatch):
    calls = []
    monkeypatch.setattr(hopper_min_dist, "_launch", _fake_min_dist_launch(calls))
    u, v = torch.empty(4, 2, 15, device="meta"), torch.empty(4, 2, 25, device="meta")
    assert hopper_min_dist.min_distance_channel_major(u, v)[0].grad_fn is None
    dist = hopper_min_dist.min_distance_channel_major(u.requires_grad_(), v)[0]
    assert type(dist.grad_fn).__name__ == "_MinDistanceBackward"
    problem = (hopper_min_dist.Window(0, 0, 15), (hopper_min_dist.Window(1, 0, 25),))
    out = hopper_min_dist.min_distance_windows([u, v], [problem])
    assert type(out.grad_fn).__name__ == "_MinDistanceWindowsBackward"
    with torch.inference_mode():
        assert hopper_min_dist.min_distance_windows([u, v], [problem]).grad_fn is None
    assert len(calls) == 4


# Profiling ------------------------------------------------------------------------

def test_profiling_matches_jax_keys(tmp_path):
    timers = (profiling.StepTimer(), jax_profiling.StepTimer())
    for timer in timers:
        for _ in range(3):
            with timer.step() as out:
                out["result"] = torch.ones(2) if timer is timers[0] else jnp.ones(2)
    summaries = [timer.summary() for timer in timers]
    assert list(summaries[0]) == list(summaries[1]) and summaries[0]["steps"] == 3
    with profiling.trace(str(tmp_path / "trace")):
        with profiling.annotate("surface_region"):
            torch.ones(8).sum()
    with open(tmp_path / "trace" / "trace.json") as f:
        assert "surface_region" in f.read()
    out, first_s, steady_s = profiling.log_compile_time(lambda x: x * 2, torch.ones(3))
    assert torch.equal(out, torch.full((3,), 2.0)) and first_s >= 0 and steady_s >= 0
    json.dumps(summaries[0])


# Entry points on the card unless asked ---------------------------------------------

def test_device_entry_points_raise_without_cuda_and_without_device(fake_results, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the behaviour without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_report(str(fake_results), REPORT_ARTS, DATASET_CONFIG["artspeech"])
    for name in ("report_phoneme_to_articulation", "shape_to_air_column"):
        with pytest.raises(RuntimeError, match="CUDA"):
            _cli("artspeech_tpu_torch", name).main({}, _args(tmp_path, device="cuda"), None)
