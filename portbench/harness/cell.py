"""What a driver is handed (``Cell``) and what it hands back (``Outcome``)."""

import functools
import time
from dataclasses import dataclass, field
from typing import Any, Optional

from portbench.harness import manifest
from portbench.harness.roofline import PEAK_F32


@dataclass
class Cell:
    """One run of one workload."""

    workload: str
    config: str
    cfg: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    started: float = field(default_factory=time.perf_counter)  # the process's start
    setup_s: Optional[float] = None
    marks: dict = field(default_factory=dict)  # set-up phase -> seconds since the start

    @functools.cached_property
    def model(self):
        """The configuration's module: how the program and the reference are built."""
        return manifest.config_module(self.config)

    def mark(self, phase: str) -> None:
        """Note when a phase of set-up ended (printed, not a metric)."""
        self.marks[phase] = round(time.perf_counter() - self.started, 4)

    def window_opens(self) -> None:
        """Set-up ends here: loading, building, the first steps and warm-up."""
        self.setup_s = time.perf_counter() - self.started
        self.marks["window"] = round(self.setup_s, 4)


@dataclass
class Reading:
    """What a per-layer metric's reader reads: the device slice (``view``),
    how many steps or requests it held, their valid frames and model FLOPs,
    each kernel's least time a call at the cell's shapes; the slice traced
    with the host and the benchmark's spans (``spans_view``, over
    ``spans_units``); the host milliseconds of each untraced call into the
    program in the window."""

    view: Any
    units: int
    valid_frames: int
    model_flops: float
    bounds: dict
    spans_view: Any = None
    spans_units: int = 0
    host_ms: list = field(default_factory=list)
    peak_flops: float = PEAK_F32


@dataclass
class Outcome:
    metrics: dict  # end-to-end metric -> value
    attempted: int
    failed: int
    numbers: dict  # the numbers compared for ``correct``
    memory_peak_bytes: int
    info: dict = field(default_factory=dict)  # printed, not compared
    reading: Optional[Reading] = None
