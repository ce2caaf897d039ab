"""Training traffic: the program's train step over a pool of distinct
batches made on the device, one step a batch in turn, the host running
ahead of the device as the program's epoch loop lets it (no
synchronisation between steps).

Set-up builds one train state (the program's model loaded with the
benchmark's weights, its AdamW), drives it from the seed through its first
steps on pool batches 0, 1, 2, keeps what those steps left (each loss, the
first gradient as the optimizer holds it, the parameters after the third),
warms up, and hands the same state to the window. After the window the plain
reference works the same three steps out again from the same weights,
batches and dropout seed, and the gaps decide ``correct``.

Traffic keys: ``batch``, ``bucket`` (the padded length), ``length_min``,
``length_max``, ``pool`` (distinct batches), ``warmup_steps``,
``trace_start``, ``trace_steps`` and ``trace_host_steps`` (the traced
slices, counted in window steps: the device alone, then with the host).
"""

import time
from dataclasses import dataclass

import torch

from portbench.harness import compare, inputs
from portbench.harness.cell import Outcome, Reading
from portbench.harness.trace import TracedSlice, span

#: Steps the reference follows.
CHECKED_STEPS = 3


@dataclass
class Setup:
    weights: dict
    model: torch.nn.Module
    state: object
    step: object
    pool: list
    frames: list  # valid frames of each pool batch
    generator: torch.Generator
    dropout_seed: int


def setup(cell) -> Setup:
    """The program's train state, loaded with the benchmark's weights, and
    the pool of batches, all from the seed."""
    cfg, m, dev = cell.cfg, cell.model, cell.device
    seeds = inputs.child_seeds(cell.seed)
    weights = inputs.draw_weights(m.reference.param_spec(cfg), seeds[inputs.WEIGHTS], dev)
    cell.mark("weights")
    model = m.build_model(cfg, dev)
    inputs.load_weights(model, weights)
    cell.mark("model")
    pool = inputs.train_pool(cell.traffic, cfg, seeds[inputs.DATA], dev)
    frames = [int(b["lengths"].sum()) for b in pool]
    cell.mark("pool")
    gen = torch.Generator(device=dev).manual_seed(seeds[inputs.DROPOUT])
    state = m.train_state(cfg, model)
    cell.mark("train_state")
    step = m.train_step(cfg, dev)
    cell.mark("train_step")
    return Setup(weights, model, state, step, pool, frames, gen, seeds[inputs.DROPOUT])


def first_steps(s: Setup, n: int = CHECKED_STEPS) -> dict:
    """The program's first ``n`` steps on pool batches 0 .. n-1: each loss,
    the first gradient as AdamW holds it after step 1 (its first moment over
    1 - beta1), the parameters after step n."""
    named = list(s.model.named_parameters())
    losses, grads = [], None
    for i in range(n):
        losses.append(s.step(s.state, s.pool[i], s.generator)["loss"].detach().clone())
        if i == 0:
            opt = s.state.optimizer
            beta1 = opt.param_groups[0]["betas"][0]
            grads = {k: (opt.state[p]["exp_avg"] / (1.0 - beta1)).detach().clone()
                     if "exp_avg" in opt.state.get(p, {}) else torch.zeros_like(p)
                     for k, p in named}
    params = {k: p.detach().clone() for k, p in named}
    return {"losses": [float(x) for x in losses], "grads": grads, "params": params}


def reference_steps(cell, weights, batches, dropout_seed, tf32: bool = False) -> dict:
    """The plain reference's first steps from the same weights, batches and
    dropout seed (TF32 products for the control)."""
    from portbench.reference.common import precision
    with precision(tf32):
        losses, grads, params = cell.model.reference.reference_train_steps(
            cell.cfg, weights, batches, dropout_seed, len(batches))
    return {"losses": losses, "grads": grads, "params": params}


def run(cell) -> Outcome:
    tr, dev = cell.traffic, cell.device
    cell.mark("imports")
    s = setup(cell)
    cell.mark("built")
    program = first_steps(s)
    cell.mark("first_steps")
    n_pool = len(s.pool)
    k = CHECKED_STEPS
    for _ in range(tr["warmup_steps"]):
        s.step(s.state, s.pool[k % n_pool], s.generator)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    cell.window_opens()

    steps = frames = 0
    host_ms, traced = [], []
    views = {}
    t0 = time.perf_counter()
    while True:
        if cell.trace and steps == tr["trace_start"]:
            # A device slice, then a short slice with the host's ops and spans.
            for host, n in ((False, tr["trace_steps"]), (True, tr["trace_host_steps"])):
                with TracedSlice(host) as sl:
                    for _ in range(n):
                        with span("portbench.step", host):
                            s.step(s.state, s.pool[k % n_pool], s.generator)
                        frames += s.frames[k % n_pool]
                        if not host:
                            traced.append(k % n_pool)
                        k += 1
                        steps += 1
                views[host] = sl.view
        else:
            h0 = time.perf_counter()
            s.step(s.state, s.pool[k % n_pool], s.generator)
            host_ms.append(1e3 * (time.perf_counter() - h0))
            frames += s.frames[k % n_pool]
            k += 1
            steps += 1
        if time.perf_counter() - t0 >= cell.seconds and (not cell.trace or views):
            break
    if dev.type == "cuda":
        torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    reading = None
    if views:
        m = cell.model
        flops = 3.0 * sum(m.reference.forward_flops(cell.cfg, s.pool[i]["lengths"].tolist())
                          for i in traced)
        reading = Reading(views[False], len(traced), sum(s.frames[i] for i in traced), flops,
                          m.kernel_bounds(cell.cfg, tr), views[True], tr["trace_host_steps"],
                          host_ms)

    checked = [{key: v.clone() for key, v in b.items()} for b in s.pool[:CHECKED_STEPS]]
    weights, dropout_seed = s.weights, s.dropout_seed
    del s
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    reference = reference_steps(cell, weights, checked, dropout_seed)
    numbers = compare.train_gaps(program, reference, weights)
    info = {"leaves_left_out": numbers.pop("leaves_left_out"), "window_steps": steps,
            "setup_marks": cell.marks,
            "program_losses": program["losses"], "reference_losses": reference["losses"]}
    return Outcome({"train_frames_per_s": frames / elapsed}, steps, 0, numbers, peak, info,
                   reading)
