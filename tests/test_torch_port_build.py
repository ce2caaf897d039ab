"""The port's kernel builds track every source they compile, on the CPU.

``_build.library_path`` names a kernel library by a hash of its
``csrc/<name>.cu``, of every ``csrc`` header that file reaches through
``#include "…"`` and of the nvcc flags, so that a library built from an
older header is never loaded. These tests run over a temporary ``CSRC_DIR``
(nothing is compiled: no nvcc is needed) and over the real sources, where
the GRU and LSTM forward kernels share ``rnn_fwd_step.cuh``, the GRU and
LSTM backward kernels ``rnn_bwd_step.cuh``, and both steps and the decode
kernel ``dsmem.cuh``.
"""

import os

from artspeech_tpu_torch.ops import _build


def _write(path, text):
    with open(path, "w") as f:
        f.write(text)


def _csrc(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    monkeypatch.setattr(_build, "CSRC_DIR", str(csrc))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    _write(csrc / "k.cu", '#include <cuda_runtime.h>\n#include "step.cuh"\nint k() { return 1; }\n')
    _write(csrc / "step.cuh", '#pragma once\n#include "inner.cuh"\n')
    _write(csrc / "inner.cuh", "#pragma once\nconstexpr int STEP = 1;\n")
    _write(csrc / "other.cuh", "#pragma once\n")
    return csrc


def test_editing_an_included_header_changes_the_library(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("k")
    assert os.path.dirname(before) == str(tmp_path / "_build")
    assert _build.library_path("k") == before  # stable while nothing changes
    _write(csrc / "step.cuh", '#pragma once\n#include "inner.cuh"\n// edited\n')
    after_header = _build.library_path("k")
    assert after_header != before
    _write(csrc / "inner.cuh", "#pragma once\nconstexpr int STEP = 2;\n")  # included by the header
    assert _build.library_path("k") not in (before, after_header)


def test_unrelated_files_do_not_change_the_library(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("k")
    _write(csrc / "other.cuh", "#pragma once\n// not included by k.cu\n")
    _write(csrc / "j.cu", '#include "step.cuh"\n')
    assert _build.library_path("k") == before
    assert _build.sources("k") == [str(csrc / n) for n in ("k.cu", "step.cuh", "inner.cuh")]


def test_editing_the_source_or_the_flags_changes_the_library(tmp_path, monkeypatch):
    csrc = _csrc(tmp_path, monkeypatch)
    before = _build.library_path("k")
    _write(csrc / "k.cu", '#include "step.cuh"\nint k() { return 2; }\n')
    edited = _build.library_path("k")
    assert edited != before
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ["-lineinfo"])
    assert _build.library_path("k") != edited
    assert _build.ptxas_report("k") == ""  # nothing was built


def test_the_gru_forward_kernels_share_their_step():
    """gru_fwd, gru_seq and lstm_fwd include the forward's cluster step,
    gru_bwd and lstm_bwd the backward's, and all five and flash_decode the
    helpers header the two steps share, so an edit of that header changes
    every one of their libraries."""
    csrc = _build.CSRC_DIR
    helpers = os.path.join(csrc, "dsmem.cuh")
    step = os.path.join(csrc, "rnn_fwd_step.cuh")
    bwd_step = os.path.join(csrc, "rnn_bwd_step.cuh")
    for name in ("gru_fwd", "gru_seq", "lstm_fwd"):
        assert _build.sources(name) == [os.path.join(csrc, f"{name}.cu"), step, helpers]
    for name in ("gru_bwd", "lstm_bwd"):
        assert _build.sources(name) == [os.path.join(csrc, f"{name}.cu"), bwd_step, helpers]
    assert _build.sources("flash_decode") == [os.path.join(csrc, "flash_decode.cu"), helpers]
    assert step not in _build.sources("gru_bwd")
    assert bwd_step not in _build.sources("lstm_fwd")
    assert _build._libraries.get("gru_fwd") is None  # nothing was built or loaded
