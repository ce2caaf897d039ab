"""Readings that the correctness limits are set from, on the card.

    python3 portbench/calibrate.py --workload <name> --seeds 1 2 3 ... [--faults 3]

For each seed, in one process: the program's numbers (its first train steps,
or the answers of as many requests as a run checks, at the cell's own
sizes) against the plain reference; the control's (the reference computed
with TF32 products, put in the program's place); and, on the first
``--faults`` seeds, each planted fault's (``harness/faults.py``). Prints one
JSON line a seed. Training readings need no measured window; a served
cell's come from requests run one after another, as its closed loop runs
them. The benchmark's own runs do not run this.
"""

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def make_cell(workload: str, seed: int, device, traffic=None):
    from portbench.harness import manifest
    from portbench.harness.cell import Cell
    m = manifest.load_manifest()
    entry = manifest.workload(m, workload)
    cfg = manifest.load_config(manifest.config_entry(m, entry["config"]))
    tr = dict(manifest.load_traffic(entry["traffic"]))
    tr.update(traffic or {})
    return Cell(workload, entry["config"], cfg, tr, {}, seed, 0.0, False, device)


def train_readings(cell, faults: tuple) -> dict:
    import torch
    from portbench.harness import compare, manifest
    from portbench.harness.faults import planted
    drv = manifest.driver_module("train")
    s = drv.setup(cell)
    program = drv.first_steps(s)
    batches = [{k: v.clone() for k, v in b.items()} for b in s.pool[:drv.CHECKED_STEPS]]
    weights, dropout_seed = s.weights, s.dropout_seed
    del s
    out = {}
    for name in faults:
        with planted(drv, "train", name):
            s = drv.setup(cell)
            out[name] = drv.first_steps(s)
            del s
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()
    reference = drv.reference_steps(cell, weights, batches, dropout_seed)
    control = drv.reference_steps(cell, weights, batches, dropout_seed, tf32=True)
    return {"program": compare.train_gaps(program, reference, weights),
            "control": compare.train_gaps(control, reference, weights),
            "faults": {k: compare.train_gaps(v, reference, weights) for k, v in out.items()}}


def synthesis_readings(cell, faults: tuple) -> dict:
    import torch
    from portbench.harness import manifest
    from portbench.harness.faults import planted
    drv = manifest.driver_module("synthesis")
    tr = cell.traffic

    def answers():
        s = drv.setup(cell)
        n = len(s.pool)
        for i in range(tr["warmup_requests"]):
            s.request(*s.pool[i % n])
        got = [(i % n, s.request(*s.pool[i % n])) for i in range(tr["sample"])]
        return s, got

    s, program = answers()
    weights, grid, pool = s.weights, s.grid, s.pool
    del s
    broken = {}
    for name in faults:
        with planted(drv, "synthesis", name):
            s, broken[name] = answers()
            del s
    if cell.device.type == "cuda":
        torch.cuda.empty_cache()

    def gaps(got):
        parts = {"contours": 0.0, "walls": 0.0, "area": 0.0}
        for j, answer in got:
            g = drv.reference_gaps(cell, weights, grid, *pool[j], answer)
            parts = {k: max(parts[k], g[k]) for k in parts}
        return {"output_gap": max(parts.values()), **parts}

    control = [(j, drv.control_answer(cell, weights, grid, *pool[j])) for j, _ in program]
    return {"program": gaps(program), "control": gaps(control),
            "faults": {k: gaps(v) for k, v in broken.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--faults", type=int, default=0, help="plant the faults on this many seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    from portbench.harness.faults import NAMES
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    for i, seed in enumerate(args.seeds):
        cell = make_cell(args.workload, seed, device)
        kind = cell.traffic["driver"]
        readings = {"train": train_readings, "synthesis": synthesis_readings}[kind]
        out = readings(cell, NAMES if i < args.faults else ())
        print(json.dumps({"workload": args.workload, "seed": seed, **out,
                          "card": torch.cuda.get_device_name(0)}), flush=True)
    from portbench.run import forbidden_modules
    leaked = forbidden_modules()
    if leaked:
        print(f"calibrate: loaded {leaked}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main())
