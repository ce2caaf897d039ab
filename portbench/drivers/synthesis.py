"""Corpus-synthesis traffic: one client, closed loop. Each request hands the
program a batch of sentences as host token arrays (padded to the bucket)
and their lengths, runs its synthesis step (the model in eval mode,
B-spline smoothing, the canonical incisor, the tube walls) and the area
function on the semipolar grid, and copies every output to the host as the
program's corpus writer (``synthesize_corpus``) does, by ``.cpu()`` into
fresh pageable memory; the next request starts when the last output is
there, as that writer waits for each batch.

A sample of the window's requests, drawn from the seed, keeps its answers;
after the window the plain reference checks each: the contours against its
own forward, the walls against its tube of the program's contours, the area
function against its area function of the program's walls.

Traffic keys: ``batch``, ``bucket``, ``length_min``, ``length_max``,
``pool`` (distinct requests, cycled), ``warmup_requests``, ``sample``
(requests checked), ``trace_start``, ``trace_requests`` and
``trace_host_requests`` (the traced slices: the device alone, then with
the host).
"""

import statistics
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from portbench.harness import compare, inputs
from portbench.harness.cell import Outcome, Reading
from portbench.harness.trace import TracedSlice, span
from portbench.reference import geometry
from portbench.reference.common import precision
from portbench.reference.grid import synthesis_grid


@dataclass
class Setup:
    weights: dict
    model: torch.nn.Module
    request: object  # (tokens, lengths host arrays) -> host outputs
    pool: list  # (tokens, lengths) host arrays
    frames: list
    grid: torch.Tensor


def request_pool(cell, seed: int) -> list:
    """The distinct requests: (tokens (B, T) int32, lengths (B,) int32) host
    arrays, made on the device from the seed and copied to the host once."""
    lengths = torch.as_tensor(inputs.pool_lengths(cell.traffic, seed), device=cell.device)
    gen = torch.Generator(device=cell.device).manual_seed(seed)
    tok = inputs.tokens(lengths.reshape(-1), cell.traffic["bucket"], cell.cfg["vocab_size"], gen)
    tok = tok.reshape(*lengths.shape, -1).cpu().numpy()
    lengths = lengths.cpu().numpy().astype(np.int32)
    return [(tok[i], lengths[i]) for i in range(len(lengths))]


def setup(cell, tracing: bool = False) -> Setup:
    cfg, m, dev = cell.cfg, cell.model, cell.device
    seeds = inputs.child_seeds(cell.seed)
    weights = inputs.draw_weights(m.reference.param_spec(cfg), seeds[inputs.WEIGHTS], dev)
    model = m.build_model(cfg, dev)
    inputs.load_weights(model, weights)
    model.eval()

    def forward(tokens, lengths):
        with span("portbench.model", tracing):
            return model(tokens, lengths)

    step = m.synthesis_step(cfg, forward, dev)
    area_function = m.area_function()
    grid = torch.as_tensor(synthesis_grid(), device=dev)

    def request(tokens, lengths):
        out = step(tokens, lengths)
        with span("portbench.area", tracing), torch.inference_mode():
            out["area"] = area_function(out["internal_wall"], out["external_wall"], grid)
        with span("portbench.copy", tracing):
            return {k: v.cpu() for k, v in out.items()}

    pool = request_pool(cell, seeds[inputs.DATA])
    return Setup(weights, model, request, pool, [int(l.sum()) for _, l in pool], grid)


def reference_gaps(cell, weights, grid, tokens, lengths, answer) -> dict:
    """One answer checked by the plain reference, each stage on the
    program's output of the stage before: ``contours`` against the
    reference's forward, ``walls``
    against its tube of the answer's contours, ``area`` against its area
    function of the answer's walls. Widest gaps over the valid frames."""
    m, dev = cell.model, cell.device
    tok = torch.as_tensor(tokens, device=dev).long()
    lens = torch.as_tensor(lengths, device=dev).long()
    valid = torch.arange(tok.shape[1], device=dev)[None, :] < lens[:, None]
    got = {k: v.to(dev) for k, v in answer.items()}
    with torch.no_grad():
        with precision(False):
            contours, arts = geometry.with_incisor(
                geometry.smoothed(m.reference.forward(cell.cfg, weights, tok, lens)),
                cell.cfg["articulators"])
        internal, external = geometry.generate_vocal_tract_tube_batch(got["contours"], arts)
        area = geometry.tube_area_function(got["internal_wall"], got["external_wall"], grid)
    return {"contours": compare.widest_gap(got["contours"], contours, valid),
            "walls": max(compare.widest_gap(got["internal_wall"], internal, valid),
                         compare.widest_gap(got["external_wall"], external, valid)),
            "area": compare.widest_gap(got["area"], area, valid)}


def control_answer(cell, weights, grid, tokens, lengths) -> dict:
    """The control put in the program's place: the plain reference with
    TF32 products, through the reference geometry."""
    m, dev = cell.model, cell.device
    tok = torch.as_tensor(tokens, device=dev).long()
    lens = torch.as_tensor(lengths, device=dev).long()
    with torch.no_grad(), precision(True):
        contours, arts = geometry.with_incisor(
            geometry.smoothed(m.reference.forward(cell.cfg, weights, tok, lens)),
            cell.cfg["articulators"])
        internal, external = geometry.generate_vocal_tract_tube_batch(contours, arts)
        area = geometry.tube_area_function(internal, external, grid)
    return {"contours": contours, "internal_wall": internal, "external_wall": external,
            "area": area}


def run(cell) -> Outcome:
    tr, dev = cell.traffic, cell.device
    cell.mark("imports")
    s = setup(cell, tracing=cell.trace)
    cell.mark("built")
    n_pool = len(s.pool)
    for i in range(tr["warmup_requests"]):
        s.request(*s.pool[i % n_pool])
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cell.window_opens()

    rng = np.random.default_rng(inputs.child_seeds(cell.seed)[inputs.SAMPLE])
    sample, latencies, frames = [], [], 0
    views, traced = {}, []
    i = 0
    t0 = time.perf_counter()
    while True:
        if cell.trace and i == tr["trace_start"] and not views:
            # A device slice, then a short slice with the host's ops and spans.
            for host, n in ((False, tr["trace_requests"]), (True, tr["trace_host_requests"])):
                with TracedSlice(host) as sl:
                    for j in range(n):
                        with span("portbench.request", host):
                            s.request(*s.pool[(i + j) % n_pool])
                        if not host:
                            traced.append((i + j) % n_pool)
                views[host] = sl.view
        r0 = time.perf_counter()
        answer = s.request(*s.pool[i % n_pool])
        latencies.append(time.perf_counter() - r0)
        frames += s.frames[i % n_pool]
        # Reservoir sampling: every request of the window equally likely kept.
        if len(sample) < tr["sample"]:
            sample.append((i % n_pool, answer))
        else:
            j = int(rng.integers(0, i + 1))
            if j < tr["sample"]:
                sample[j] = (i % n_pool, answer)
        i += 1
        if time.perf_counter() - t0 >= cell.seconds and (not cell.trace or views):
            break
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    n_requests = len(latencies)

    reading = None
    if views:
        m = cell.model
        reading = Reading(views[False], len(traced), sum(s.frames[j] for j in traced),
                          sum(m.reference.forward_flops(cell.cfg, s.pool[j][1]) for j in traced),
                          m.kernel_bounds(cell.cfg, tr), views[True], tr["trace_host_requests"],
                          [1e3 * x for x in latencies])

    weights, grid, pool = s.weights, s.grid, s.pool
    del s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    parts = {"contours": 0.0, "walls": 0.0, "area": 0.0}
    for j, answer in sample:
        gaps = reference_gaps(cell, weights, grid, *pool[j], answer)
        parts = {k: max(parts[k], gaps[k]) for k in parts}
    print(f"[synthesis] requests={n_requests} sample={len(sample)} "
          f"request_ms_median={1e3 * statistics.median(latencies):.4f} "
          f"request_ms_p95={1e3 * np.percentile(latencies, 95):.4f}", file=sys.stderr)
    metrics = {"infer_frames_per_s": frames / elapsed}
    info = {"requests": n_requests, "gap_parts": parts, "setup_marks": cell.marks}
    return Outcome(metrics, n_requests, 0, {"output_gap": max(parts.values())}, peak, info,
                   reading)

