"""On the card, at each cell's own size: the program's readings lie within
the cell's limits and the control's (the plain reference in TF32 products,
put in the program's place) do not. Run with
``python -m pytest portbench/tests/test_portbench_control.py`` on a machine
with an H100; skipped without a card."""

import pytest

from portbench import calibrate
from portbench.harness import compare, manifest

CELLS = [w["name"] for w in manifest.load_manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_and_program_passes(card, workload):
    cell = calibrate.make_cell(workload, 2**31 + 101, card)
    read = {"train": calibrate.train_readings,
            "synthesis": calibrate.synthesis_readings}[cell.traffic["driver"]]
    readings = read(cell, ())
    limits = manifest.load_limits(workload)
    assert compare.all_within(compare.judge(readings["program"], limits)), readings["program"]
    assert not compare.all_within(compare.judge(readings["control"], limits)), readings["control"]
