"""ctypes bindings for the native (C++) batch contour loader (counterpart of
artspeech_tpu/data/native.py).

``data/csrc/contour_loader.cpp`` loads, scales and resamples a whole batch of
.npy contour files on a thread pool in one call: the data layer's IO-bound
hot path. At first use it is built with ``g++ -O3 -std=c++17 -fPIC -pthread
-shared`` into ``artspeech_tpu_torch/_build/libcontour_loader-<hash>.so``
(git-ignored), the hash covering the source and the flags, as the kernels'
libraries are (ops/_build.py). A failed build raises with the compiler's
message: unlike the JAX package, the port has no path where the native
loader is silently unavailable.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from artspeech_tpu_torch.ops._build import BUILD_DIR

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "contour_loader.cpp")
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-Wall", "-pthread", "-shared"]
_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"libcontour_loader-{digest.hexdigest()[:12]}.so")


def build() -> str:
    """Compile the loader unless its library is already built; returns its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"g++ failed for contour_loader.cpp (rc={proc.returncode}):\n"
                           f"{proc.stderr}")
    os.replace(tmp, path)
    return path


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            lib.load_contours_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int64,
                ctypes.c_int64,
                ctypes.c_float,
                ctypes.POINTER(ctypes.c_float),
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int32,
                ctypes.POINTER(ctypes.c_int64),
            ]
            lib.load_contours_batch.restype = None
            _lib = lib
        return _lib


def load_contour_batch(
    paths: Sequence[str],
    norm_value: float,
    n_samples: int = 50,
    n_threads: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a batch of contour npys natively.

    Returns:
        (contours, ok, orig_lengths): (len(paths), 2, n_samples) float32
        scaled by 1/norm_value, a boolean success mask (False for a missing
        or unreadable file), and each file's original point count.
    """
    lib = _library()
    n = len(paths)
    out = np.empty((n, 2, n_samples), np.float32)
    ok = np.zeros((n,), np.uint8)
    orig = np.zeros((n,), np.int64)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.load_contours_batch(
        c_paths,
        n,
        n_samples,
        ctypes.c_float(norm_value),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        ok.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads,
        orig.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
    )
    return out, ok.astype(bool), orig
