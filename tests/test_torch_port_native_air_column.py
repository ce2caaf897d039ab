"""The port's air-column precompute and native contour loader against the JAX
package's, on the CPU.

- ``shape_to_air_column``: both CLIs over one small corpus (a last chunk
  smaller than ``batch_size``, a frame with a contour missing) write the same
  set of ``air_column/*.npy`` files, each (2, 2, 100), within 1e-5;
- ``load_contour_batch`` of both packages over float32 contour files: equal
  bit for bit to the plain loader wherever a file has 50 points (the port's
  also over float64 files, where it rounds as numpy does), failures and
  point counts reported alike;
- ``prefetch_contours`` primes only the 50-point files, with the plain
  loader's arrays bit for bit, and ``VocalTractShapeLoader`` gives the same
  arrays with the prefetch as without it;
- a failed build raises with the compiler's message.
"""

import argparse
import os
import shutil

import numpy as np
import pytest

from artspeech_tpu.data import native as jax_native
from artspeech_tpu.data.synthetic_corpus import make_synthetic_corpus
from artspeech_tpu_torch.core.config import DATASET_CONFIG
from artspeech_tpu_torch.core.constants import UPPER_INCISOR
from artspeech_tpu_torch.data import loaders, native

TOL = 1e-5


def _cli(package, name):
    return __import__(f"{package}.cli.{name}", fromlist=["main"])


def test_shape_to_air_column_matches_jax(tmp_path):
    corpus = tmp_path / "corpus"
    make_synthetic_corpus(str(corpus), sequences=("S01", "S02"), n_sentences=1,
                          frames_per_sentence=6)
    os.remove(corpus / "s1" / "S02" / "inference_contours" / f"0003_{UPPER_INCISOR}.npy")
    files = {}
    for package in ("artspeech_tpu", "artspeech_tpu_torch"):
        root = tmp_path / package
        shutil.copytree(corpus, root)
        cfg = {"datadir": str(root), "database_name": "gottingen",
               "seq_dict": {"s1": ["S01", "S02"]}, "batch_size": 4}
        args = argparse.Namespace(device="cpu", output_dir=str(tmp_path))
        assert _cli(package, "shape_to_air_column").main(cfg, args, None) == 11
        files[package] = {os.path.relpath(os.path.join(d, n), root): np.load(os.path.join(d, n))
                          for d, _, names in os.walk(root) if d.endswith("air_column")
                          for n in names}
    assert sorted(files["artspeech_tpu_torch"]) == sorted(files["artspeech_tpu"])
    assert os.path.join("s1", "S02", "air_column", "0003.npy") not in files["artspeech_tpu"]
    for name, ref in files["artspeech_tpu"].items():
        got = files["artspeech_tpu_torch"][name]
        assert got.shape == ref.shape == (2, 2, 100) and got.dtype == ref.dtype
        np.testing.assert_allclose(got, ref, rtol=0, atol=TOL, err_msg=name)


@pytest.fixture(scope="module")
def contour_files(tmp_path_factory):
    """Contour npys of 50 points stored (50, 2) and (2, 50), of 37 points,
    float32 and float64, and a missing path."""
    root = tmp_path_factory.mktemp("contours")
    rng = np.random.default_rng(0)
    paths = {np.float32: [], np.float64: []}
    for dtype, out in paths.items():
        for i, shape in enumerate([(50, 2), (2, 50), (37, 2)] * 4):
            path = str(root / f"{np.dtype(dtype).name}_{i}.npy")
            np.save(path, (rng.random(shape) * 136).astype(dtype))
            out.append(path)
        out.append(str(root / "missing.npy"))
    return paths


def _plain(path, norm):
    loaders.clear_contour_cache()
    return loaders.cached_load_articulator_array(path, norm)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_native_batch_equals_the_plain_loader_bit_for_bit(contour_files, dtype):
    paths = contour_files[dtype]
    batches = {"port": native.load_contour_batch(paths, 136.0)}
    if dtype == np.float32:
        batches["jax"] = jax_native.load_contour_batch(paths, 136.0)
    for which, (out, ok, orig) in batches.items():
        assert out.shape == (len(paths), 2, 50) and out.dtype == np.float32, which
        assert ok.tolist() == [True] * (len(paths) - 1) + [False], which
        assert orig.tolist() == [50, 50, 37] * 4 + [0], which
        for i, path in enumerate(paths[:-1]):
            if orig[i] == 50:
                np.testing.assert_array_equal(out[i].view(np.uint32),
                                              np.ascontiguousarray(_plain(path, 136.0).T)
                                              .view(np.uint32), err_msg=f"{which} {path}")


def test_prefetch_primes_the_cache_with_the_plain_arrays(contour_files):
    paths = contour_files[np.float64] + contour_files[np.float32]
    loaders.clear_contour_cache()
    assert loaders.prefetch_contours(paths, 136.0) == 16
    assert loaders.prefetch_contours(paths, 136.0) == 0  # all cached or not 50 points
    primed = dict(loaders._CONTOUR_CACHE)
    assert len(primed) == 16
    for (path, norm), array in primed.items():
        assert array.shape == (50, 2)
        np.testing.assert_array_equal(array.view(np.uint32),
                                      np.ascontiguousarray(_plain(path, norm)).view(np.uint32))
    loaders.clear_contour_cache()


def test_vocal_tract_loader_is_the_same_with_the_prefetch(tmp_path, monkeypatch):
    corpus = tmp_path / "corpus"
    make_synthetic_corpus(str(corpus), sequences=("S01",), n_sentences=1, frames_per_sentence=5)
    arts = ["lower-lip", "tongue", "upper-lip"]
    frames = [f"{t:04d}" for t in range(5)]
    loader = loaders.VocalTractShapeLoader(str(corpus), arts, 50, DATASET_CONFIG["gottingen"])
    loaders.clear_contour_cache()
    with_prefetch = loader.load_vocal_tract_shapes("s1", "S01", frames)
    assert len(loaders._CONTOUR_CACHE) > 5 * len(arts)  # the tail-clip references too
    loaders.clear_contour_cache()
    monkeypatch.setattr(loaders, "prefetch_contours", lambda *a, **k: 0)
    without = loader.load_vocal_tract_shapes("s1", "S01", frames)
    loaders.clear_contour_cache()
    assert with_prefetch[2] == without[2] == 5
    for a, b in zip(with_prefetch[:2], without[:2]):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


def test_a_failed_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    source = tmp_path / "contour_loader.cpp"
    source.write_text("int broken( {\n")
    monkeypatch.setattr(native, "SOURCE", str(source))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for contour_loader.cpp") as err:
        native.load_contour_batch([], 1.0)
    assert "error" in str(err.value)
    assert os.listdir(tmp_path / "_build") == []
    first = native.library_path()
    source.write_text("int fixed();\n")
    assert native.library_path() != first
