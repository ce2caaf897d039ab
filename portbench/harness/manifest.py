"""BENCHMARK.json and the files it names, found by name.

A configuration is ``configs/<config>.json`` (its sizes, as run) beside
``configs/<config>.py`` (how the program and the plain reference are built
from them); a traffic mix is ``traffic/<traffic>.json``, read by the driver
it names under ``drivers/``; a per-layer metric is ``metrics/<metric>.py``;
a cell's correctness limits are ``limits/<workload>.json``. Adding any of
them takes new files and entries only.
"""

import importlib.util
import json
import os

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


def _json(path):
    with open(path) as f:
        return json.load(f)


def load_manifest(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(manifest: dict, name: str) -> dict:
    for cell in manifest["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no workload named {name!r} in BENCHMARK.json")


def config_entry(manifest: dict, name: str) -> dict:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            return entry
    raise KeyError(f"no configuration named {name!r} in BENCHMARK.json")


def load_config(entry: dict, root: str = ROOT) -> dict:
    return _json(os.path.join(root, entry["file"]))


def load_traffic(name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "traffic", f"{name}.json"))


def load_limits(workload_name: str) -> dict:
    return _json(os.path.join(BENCH_DIR, "limits", f"{workload_name}.json"))


def load_file_module(path: str, prefix: str):
    """Import a module from a file whose name may hold dots or dashes."""
    stem = os.path.basename(path)[:-len(".py")]
    name = prefix + "".join(ch if ch.isalnum() else "_" for ch in stem)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def config_module(name: str):
    return load_file_module(os.path.join(BENCH_DIR, "configs", f"{name}.py"), "portbench_config_")


def metric_module(name: str):
    return load_file_module(os.path.join(BENCH_DIR, "metrics", f"{name}.py"), "portbench_metric_")


def driver_module(name: str):
    return load_file_module(os.path.join(BENCH_DIR, "drivers", f"{name}.py"), "portbench_driver_")


def end_to_end_metrics(manifest: dict, workload_name: str) -> list:
    """The end-to-end metric entries a cell reports."""
    return [m for m in manifest["end_to_end"]
            if "workloads" not in m or workload_name in m["workloads"]]


def per_layer_metrics(manifest: dict, workload_name: str) -> list:
    """The per-layer metric entries a cell reports in its traced run: those
    that list it, and those without a list whose end-to-end metric it
    reports."""
    e2e = {m["name"] for m in end_to_end_metrics(manifest, workload_name)}
    return [m for m in manifest["per_layer"]
            if (workload_name in m["workloads"] if "workloads" in m else m["moves"] in e2e)]
