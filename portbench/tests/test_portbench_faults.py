"""A run with the timed path broken underneath comes out not correct: each
fault of ``harness/faults.py`` planted in each cell, the rest of the run
driven on the CPU (the look for a card skipped) at a tiny size, judged by
the cell's own limits. A sound run of the same size comes out correct."""

import pytest
import torch

from portbench.harness import compare, manifest
from portbench.harness.cell import Cell
from portbench.harness.faults import NAMES, planted

M = manifest.load_manifest()
TINY = {
    "train": {"batch": 4, "bucket": 16, "length_min": 9, "length_max": 16, "pool": 4,
              "warmup_steps": 1},
    "synthesis": {"batch": 4, "bucket": 16, "length_min": 9, "length_max": 16, "pool": 2,
                  "warmup_requests": 2, "sample": 2},
}
#: The transformer is the costliest on the CPU: two sentences a batch. (The
#: two warm-up requests end on the pool's second request, so a stale answer
#: to the window's first differs from it.)
SMALLER = {"transformer_train_b128": {"batch": 2, "length_min": 13}}
CELLS = [w["name"] for w in M["workloads"]]


def tiny_cell(workload, seed=2**31 + 3):
    w = manifest.workload(M, workload)
    tr = dict(manifest.load_traffic(w["traffic"]))
    tr.update(TINY[tr["driver"]])
    tr.update(SMALLER.get(workload, {}))
    cfg = manifest.load_config(manifest.config_entry(M, w["config"]))
    return Cell(workload, w["config"], cfg, tr, manifest.load_limits(workload), seed, 0.2, False,
                torch.device("cpu"))


def judged(c, out):
    return compare.all_within(compare.judge(out.numbers, c.limits))


@pytest.mark.parametrize("workload,fault", [(w, f) for w in CELLS for f in NAMES])
def test_planted_fault_is_not_correct(workload, fault):
    c = tiny_cell(workload)
    driver = manifest.driver_module(c.traffic["driver"])
    with planted(driver, c.traffic["driver"], fault):
        out = driver.run(c)
    assert not judged(c, out), out.numbers


@pytest.mark.parametrize("workload", [w for w in CELLS if w != "transformer_train_b128"])
def test_sound_run_is_correct(workload):
    c = tiny_cell(workload)
    out = manifest.driver_module(c.traffic["driver"]).run(c)
    assert judged(c, out), out.numbers
