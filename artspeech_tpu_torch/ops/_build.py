"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``artspeech_tpu_torch/_build/lib<name>-<hash>.so`` (git-ignored). The
file name carries a hash of the source, of every ``csrc/*.cuh`` it includes
with ``#include "…"`` (and those headers' own includes) and of the flags, so
a library always matches the sources in the checkout. ``-Xptxas -v``'s
report of each kernel's registers, shared memory and spills goes beside the
library, into ``lib<name>-<hash>.log``. Nothing here runs at import time.
"""

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
from typing import Dict

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "ops", "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

_libraries: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is")


def sources(name: str) -> list:
    """``csrc/<name>.cu`` and every ``csrc`` header it reaches through
    ``#include "…"``, in the order first reached."""
    found, todo = [], [f"{name}.cu"]
    while todo:
        path = os.path.join(CSRC_DIR, todo.pop(0))
        if path in found or not os.path.exists(path):
            continue
        found.append(path)
        with open(path, "rb") as f:
            todo.extend(m.decode() for m in _INCLUDE.findall(f.read()))
    return found


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources(name):
        with open(path, "rb") as f:
            digest.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def ptxas_report(name: str) -> str:
    """What ``-Xptxas -v`` said when the library of ``csrc/<name>.cu`` was
    built ("" if it was built elsewhere)."""
    log = library_path(name)[:-len(".so")] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def build(name: str) -> str:
    """Compile ``csrc/<name>.cu`` unless its library is already built; returns
    the library path."""
    path = library_path(name)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    with open(path[:-len(".so")] + ".log", "w") as f:
        f.write(proc.stderr)
    os.replace(tmp, path)
    return path


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _libraries[name] = lib
        return lib
