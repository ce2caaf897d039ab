"""BENCHMARK.json keeps to the contract's names and limits, and every file a
cell needs is found by its name."""

import json
import os
import re

import pytest

from portbench.harness import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def _text(value):
    return isinstance(value, str) and 1 <= len(value) <= 200 and "\n" not in value \
        and "\t" not in value


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    with open(os.path.join(manifest.ROOT, "BENCHMARK.json"), "rb") as f:
        assert len(f.read()) <= 64 * 1024
    assert 1 <= M["run_seconds"] <= 51 and isinstance(M["run_seconds"], int)
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) for p in M["paths"])
    assert len(M["command"]) <= 32 and all(_text(w) for w in M["command"])
    assert not any(w.startswith("/") or ".." in w.split("/") for w in M["command"])


def test_names_units_and_texts():
    names = []
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and _text(w["why"])
        assert w["chips"] in (1, 4) and w["config"] in names
    metric_names = []
    for m in M["end_to_end"] + M["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        assert all(cell in CELLS for cell in m.get("workloads", []))
        metric_names.append(m["name"])
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _text(m["layer"]) and m["moves"] in {e["name"] for e in M["end_to_end"]}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for group in (names, CELLS, metric_names):
        assert len(group) == len(set(group))
    assert "setup_s" in {m["name"] for m in M["end_to_end"]}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    w = manifest.workload(M, cell)
    entry = manifest.config_entry(M, w["config"])
    cfg = manifest.load_config(entry)
    module = manifest.config_module(w["config"])
    assert cfg["name"] == w["config"] and module.reference.param_spec(cfg)
    traffic = manifest.load_traffic(w["traffic"])
    assert os.path.exists(os.path.join(manifest.BENCH_DIR, "drivers", f"{traffic['driver']}.py"))
    assert manifest.load_limits(cell)
    e2e = manifest.end_to_end_metrics(M, cell)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    layer = manifest.per_layer_metrics(M, cell)
    assert layer
    for m in layer:
        reader = manifest.metric_module(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (m["layer"], m["unit"], m["moves"])
        assert m["moves"] in {e["name"] for e in e2e}


def test_every_metric_and_config_file_is_used():
    used = {m["name"] for m in M["per_layer"]}
    files = {f[:-3] for f in os.listdir(os.path.join(manifest.BENCH_DIR, "metrics"))
             if f.endswith(".py")}
    assert files == used
    assert {manifest.workload(M, c)["config"] for c in CELLS} == {c["name"] for c in M["configs"]}


def test_traffic_pools_are_fixed_multisets():
    from portbench.harness import inputs
    for cell in CELLS:
        traffic = manifest.load_traffic(manifest.workload(M, cell)["traffic"])
        a, b = inputs.pool_lengths(traffic, 1), inputs.pool_lengths(traffic, 2**31 + 7)
        assert sorted(a.ravel()) == sorted(b.ravel())
        assert a.min() == traffic["length_min"] and a.max() == traffic["length_max"]
        assert a.max() <= traffic["bucket"]
        json.dumps(traffic)
