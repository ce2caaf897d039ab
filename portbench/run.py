"""The port's benchmark: one run of one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The run makes its weights and traffic from the seed on the card, warms
up the cell's own shapes (set-up, ``setup_s``), measures for ``--seconds``,
checks what the timed path produced against the plain reference in
``portbench/reference/``, and prints one JSON line last on standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer metrics, read from a profiled
slice of the window), ``device`` (and ``breakdown`` when traced), then each
compared number beside its limit under ``checks``, which also end standard
error.

It exits non-zero and prints no result without enough CUDA cards, or when
``jax``, ``jaxlib``, ``flax`` or the JAX package ``artspeech_tpu`` is loaded
once the window has closed.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: Top-level module names no run may hold: JAX and the JAX package.
FORBIDDEN = ("jax", "jaxlib", "flax", "artspeech_tpu")
#: Build and kernel caches, at fixed paths inside the checkout.
CACHE_DIR = os.path.join(ROOT, ".portbench_cache")
#: Python's bytecode of the modules a run imports (torch's among them),
#: compiled on a checkout's first run and read by the later ones, also
#: where the environment forbids writing it beside the sources.
PYCACHE_DIR = os.path.join(CACHE_DIR, "pycache")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(FORBIDDEN))


def power_limit():
    """The card's name and power limit as nvidia-smi reads them, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.splitlines()[0] if out else None


def result_line(cell, entry, manifest_, outcome, torch):
    """The run's result as the JSON object printed last."""
    from portbench.harness import compare, manifest
    if cell.trace:
        metrics = {}
        for m in manifest.per_layer_metrics(manifest_, cell.workload):
            value = manifest.metric_module(m["name"]).read(outcome.reading)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": float(cell.setup_s if m["name"] == "setup_s"
                                              else outcome.metrics[m["name"]]),
                               "unit": m["unit"]}
                   for m in manifest.end_to_end_metrics(manifest_, cell.workload)}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": entry["chips"],
              "memory_peak_bytes": int(outcome.memory_peak_bytes)}
    line = {"attempted": outcome.attempted, "failed": outcome.failed, "metrics": metrics,
            "device": device}
    if cell.trace:
        view, host = outcome.reading.view, outcome.reading.spans_view or outcome.reading.view
        device["busy_s"], device["window_s"] = view.busy_s, view.window_s
        line["breakdown"] = {"device_ops": view.top_ops(), "idle_gaps": host.idle_gaps()}
    line["card"] = {"name_and_power_limit": power_limit()}
    checks = compare.judge(outcome.numbers, cell.limits)
    for c in checks.values():  # a gap that is no number fails as the largest one
        c["value"] = c["value"] if math.isfinite(c["value"]) else sys.float_info.max
    line["correct"] = bool(checks) and compare.all_within(checks)
    line["checks"] = checks
    return line


def main(argv=None) -> int:
    args = parse(argv)
    if sys.path and os.path.abspath(sys.path[0]) == os.path.join(ROOT, "portbench"):
        sys.path[0] = ROOT
    else:
        sys.path.insert(0, ROOT)
    sys.pycache_prefix, sys.dont_write_bytecode = PYCACHE_DIR, False
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE_DIR, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE_DIR, "triton")

    from portbench.harness import manifest
    from portbench.harness.cell import Cell
    manifest_ = manifest.load_manifest()
    entry = manifest.workload(manifest_, args.workload)
    config = manifest.config_entry(manifest_, entry["config"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"portbench: {args.workload} needs {entry['chips']} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    traffic = manifest.load_traffic(entry["traffic"])
    try:
        limits = manifest.load_limits(args.workload)
    except FileNotFoundError:
        limits = {}
    cell = Cell(args.workload, entry["config"], manifest.load_config(config), traffic, limits,
                args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                started=STARTED)
    outcome = manifest.driver_module(traffic["driver"]).run(cell)

    leaked = forbidden_modules()
    if leaked:
        print(f"portbench: the run loaded {', '.join(leaked)}", file=sys.stderr)
        return 3
    line = result_line(cell, entry, manifest_, outcome, torch)
    print(f"[{args.workload}] seed={args.seed} setup_s={cell.setup_s!r} "
          f"info={json.dumps(outcome.info)}", file=sys.stderr)
    if outcome.reading is not None:
        r = outcome.reading
        print(f"[{args.workload}] traced units={r.units} notes={json.dumps(r.view.notes)} "
              f"with the host: units={r.spans_units} busy_s={r.spans_view.busy_s!r} "
              f"window_s={r.spans_view.window_s!r} notes={json.dumps(r.spans_view.notes)}",
              file=sys.stderr)
    for name, c in line["checks"].items():
        verdict = "ok" if c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    if not line["checks"]:
        print(f"check none: no limits for {args.workload}; numbers "
              f"{json.dumps(outcome.numbers)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
