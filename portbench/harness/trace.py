"""Spans and the device trace of a traced slice.

A traced run profiles a steady slice of its window with ``torch.profiler``
(CPU and CUDA activities), inside a ``portbench.slice`` span that opens and
closes on a synchronised device, and reads the profiler's events in memory:
nothing is written to disk. The benchmark's own spans (``portbench.*``,
``record_function`` around its calls into each layer of the program) are
the program spans; the device operations (kernels, copies, sets) and the
host call that launched each are the device trace.

``TraceView`` answers what the per-layer readers ask: device operations by
kind and name, which span launched each, the device's busy time as the
union of its operations' intervals, and the idle gaps with what the host
was doing meanwhile.
"""

import contextlib
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

SLICE = "portbench.slice"


@dataclass
class DeviceOp:
    name: str
    kind: str  # "kernel", "memcpy_dtoh", "memcpy_htod", "memcpy", "memset"
    start: int  # ns
    end: int
    launched: Optional[int]  # host ns of the launching call, if known


@dataclass
class Span:
    name: str
    start: int
    end: int


def _kind(name: str) -> str:
    low = name.lower()
    if low.startswith("memcpy"):
        if "dtoh" in low:
            return "memcpy_dtoh"
        if "htod" in low:
            return "memcpy_htod"
        return "memcpy"
    if low.startswith("memset"):
        return "memset"
    return "kernel"


def _is_runtime(name: str) -> bool:
    return name.startswith("cuda") or name.startswith("cu") and name[2:3].isupper()


@dataclass
class TraceView:
    ops: List[DeviceOp]
    spans: List[Span]
    host: List[Span]  # every host-side event, for labelling idle gaps
    slice_start: int
    slice_end: int
    wall_s: Optional[float] = None  # the slice's length by the host clock
    notes: dict = field(default_factory=dict)

    @property
    def window_s(self) -> float:
        """The slice's length: between its two synchronisations."""
        return self.wall_s if self.wall_s is not None else (self.slice_end - self.slice_start) / 1e9

    def in_slice(self) -> List[DeviceOp]:
        return [o for o in self.ops if o.end > self.slice_start and o.start < self.slice_end]

    def kernels(self, *substrings: str) -> List[DeviceOp]:
        """Kernels of the slice whose name holds any of ``substrings`` (all
        kernels without any)."""
        return [o for o in self.in_slice() if o.kind == "kernel"
                and (not substrings or any(s in o.name for s in substrings))]

    def of_kind(self, kind: str) -> List[DeviceOp]:
        return [o for o in self.in_slice() if o.kind == kind]

    def spans_named(self, name: str) -> List[Span]:
        return [s for s in self.spans if s.name == name
                and s.end > self.slice_start and s.start < self.slice_end]

    def launched_in(self, name: str) -> List[DeviceOp]:
        """Device operations launched while a span ``name`` was open."""
        spans = [(s.start, s.end) for s in self.spans_named(name)]
        return [o for o in self.in_slice() if o.launched is not None
                and any(a <= o.launched <= b for a, b in spans)]

    def busy_intervals(self):
        """The union of the slice's device operations, clipped to it."""
        merged = []
        for o in sorted(self.in_slice(), key=lambda o: o.start):
            a, b = max(o.start, self.slice_start), min(o.end, self.slice_end)
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    @property
    def busy_s(self) -> float:
        """Seconds in which an operation ran on the device."""
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def top_ops(self, n: int = 10):
        """[[name, seconds]] of the device operations that took most time."""
        totals = {}
        for o in self.in_slice():
            key = _short(o.name)
            totals[key] = totals.get(key, 0) + (o.end - o.start)
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k, v / 1e9] for k, v in ranked]

    def idle_gaps(self, n: int = 10, longest: int = 500):
        """[[what the host was doing, seconds]]: the ``longest`` idle gaps of
        the slice, their time summed by the innermost host event open at
        each gap's middle (a benchmark span, a program op or a runtime
        call: of those open, the one that started last)."""
        busy = self.busy_intervals()
        edges = [self.slice_start] + [x for ab in busy for x in ab] + [self.slice_end]
        gaps = sorted(((b - a, a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a),
                      reverse=True)[:longest]
        starts = np.array([s.start for s in self.host], dtype=np.int64)
        ends = np.array([s.end for s in self.host], dtype=np.int64)
        totals = {}
        for width, a, b in gaps:
            mid = (a + b) // 2
            open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
            label = ("no host event" if open_.size == 0
                     else self.host[int(open_[np.argmax(starts[open_])])].name)
            totals[label] = totals.get(label, 0) + width
        ranked = sorted(totals.items(), key=lambda kv: -kv[1])[:n]
        return [[k[:120], v / 1e9] for k, v in ranked]


def _synchronize():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


def span(name: str, on: bool):
    """A ``record_function`` span when tracing, else nothing."""
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


class TracedSlice:
    """``with TracedSlice(host) as s: ...`` profiles the body between two
    synchronisations; ``s.view`` is the TraceView afterwards.

    ``host=False`` records the device alone (kernels, copies, sets and the
    runtime calls that launched them), which adds little host time, so the
    device's busy and idle time are those of an untraced run; the slice's
    length is then the host clock's between the synchronisations. With
    ``host=True`` the host's ops and the benchmark's spans are recorded
    too, which slows the host (a host-paced step's idle time grows), for
    what launched each device operation.
    """

    def __init__(self, host: bool):
        self.host = host
        self.view = None
        self._prof = self._span = None
        self._t0 = 0.0

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU] if self.host else []
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        else:  # a test on the CPU: the host alone
            acts = [torch.profiler.ProfilerActivity.CPU]
        self._prof = torch.profiler.profile(activities=acts)
        _synchronize()
        self._prof.__enter__()
        self._span = torch.profiler.record_function(SLICE)
        self._span.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _synchronize()
        wall = time.perf_counter() - self._t0
        self._span.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self.view = read_profile(self._prof, None if self.host else wall)
        return False


def _short(name: str) -> str:
    """A kernel's name without its parameter list, at most 120 characters."""
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i] if i else name
                break
    return name.strip()[:120]


def read_profile(prof, wall_s: Optional[float] = None) -> TraceView:
    events = prof.profiler.kineto_results.events()
    gpu, host, runtime, cpu_ops, annotations = [], [], {}, {}, set()
    for e in events:
        name = e.name()
        if "CUDA" in str(e.device_type()):
            gpu.append(e)
            continue
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        if _is_runtime(name):
            runtime[e.correlation_id()] = start
        else:
            cpu_ops[e.correlation_id()] = start
        if e.is_user_annotation():
            annotations.add(name)
        host.append(Span(name, start, end))
    device_ops = []
    for e in gpu:
        name = e.name()
        # The device timeline mirrors each record_function range as an
        # annotation: a range, not an operation.
        if e.is_user_annotation() or name in annotations or name.startswith("portbench."):
            continue
        launched = runtime.get(e.correlation_id())
        if launched is None:
            launched = cpu_ops.get(e.linked_correlation_id())
        device_ops.append(DeviceOp(name, _kind(name), e.start_ns(), e.start_ns() + e.duration_ns(),
                                   launched))
    spans = [s for s in host if s.name.startswith("portbench.")]
    slices = [s for s in spans if s.name == SLICE]
    notes = {"unlinked_ops": sum(o.launched is None for o in device_ops),
             "device_ops": len(device_ops), "host_events": len(host)}
    if wall_s is not None:  # the device alone: every operation is the slice's
        start = min((o.start for o in device_ops), default=0)
        end = max((o.end for o in device_ops), default=0)
        return TraceView(device_ops, spans, host, start, end, wall_s, notes)
    if not slices:
        raise RuntimeError("the profile holds no slice span")
    return TraceView(device_ops, spans, host, slices[0].start, slices[0].end, None, notes)
