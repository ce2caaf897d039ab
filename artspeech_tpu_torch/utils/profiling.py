"""Profiling and step-time instrumentation (counterpart of
artspeech_tpu/utils/profiling.py).

The reference has no tracing/profiling (SURVEY.md §5 — tqdm postfixes only).
Here: ``torch.profiler`` traces written as Chrome traces (viewable in
Perfetto or chrome://tracing), named regions, and a step timer that waits
for the result's CUDA device before it reads the clock.
"""

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


def _synchronize(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result`` (a tensor
    or a nest of tuples, lists and dicts)."""
    devices = set()

    def visit(x):
        if isinstance(x, torch.Tensor):
            if x.device.type == "cuda":
                devices.add(x.device)
        elif isinstance(x, dict):
            for v in x.values():
                visit(v)
        elif isinstance(x, (list, tuple)):
            for v in x:
                visit(v)

    visit(result)
    for device in devices:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the enclosed block (CPU, and CUDA where there is a device) and
    write ``<logdir>/trace.json``, a Chrome trace. Yields the profiler."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def annotate(name: str):
    """Named region that shows up in profiler traces."""
    return torch.profiler.record_function(name)


@dataclass
class StepTimer:
    """Synchronized step timing with running statistics."""

    sync: bool = True
    times_ms: List[float] = field(default_factory=list)
    _t0: Optional[float] = None

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result=None):
        if result is not None and self.sync:
            _synchronize(result)
        if self._t0 is not None:
            self.times_ms.append((time.perf_counter() - self._t0) * 1e3)
            self._t0 = None

    @contextlib.contextmanager
    def step(self):
        self.start()
        out = {}
        try:
            yield out
        finally:
            self.stop(out.get("result"))

    def summary(self) -> Dict[str, float]:
        if not self.times_ms:
            return {}
        arr = np.asarray(self.times_ms)
        return {
            "steps": int(arr.size),
            "mean_ms": float(arr.mean()),
            "median_ms": float(np.median(arr)),
            "p90_ms": float(np.percentile(arr, 90)),
            "min_ms": float(arr.min()),
        }


def log_compile_time(fn, *args, label: str = "fn"):
    """Run ``fn`` twice, reporting the first call's seconds (on the card,
    with the kernels' build and load) and the second's. Returns
    (output, first_s, steady_s)."""
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = fn(*args)
    _synchronize(out)
    steady_s = time.perf_counter() - t0
    print(f"[{label}] first call {first_s:.2f}s, steady {steady_s * 1e3:.2f}ms")
    return out, first_s, steady_s
