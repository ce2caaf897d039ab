"""The benchmark imports neither JAX nor the JAX package; its plain
references import nothing of the program either; nothing of it reads the
JAX package's bench.py or benchmarks/. Top-level module names are compared
whole: the program's name, artspeech_tpu_torch, begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

import pytest

from portbench.harness import manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "artspeech_tpu"}
SOURCES = sorted(os.path.join(d, f) for d, _, fs in os.walk(manifest.BENCH_DIR)
                 for f in fs if f.endswith(".py"))


def imported(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_no_jax_import(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in SOURCES if os.sep + "reference" + os.sep in p],
                         ids=os.path.basename)
def test_references_import_nothing_of_the_program(path):
    assert "artspeech_tpu_torch" not in imported(path)
    assert imported(path) <= {"contextlib", "functools", "math", "typing", "numpy", "torch",
                              "portbench"}


def code_strings(path):
    """String constants of a module other than its docstrings."""
    with open(path) as f:
        tree = ast.parse(f.read())
    docs = {id(n.body[0].value) for n in ast.walk(tree)
            if isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and n.body
            and isinstance(n.body[0], ast.Expr) and isinstance(n.body[0].value, ast.Constant)}
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docs]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: os.path.relpath(p, manifest.BENCH_DIR))
def test_reads_nothing_of_the_jax_benchmark(path):
    names = ("bench" + ".py", "bench" + "marks")
    assert not any(n in s for s in code_strings(path) for n in names)


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import portbench.run, portbench.calibrate;"
            "from portbench.harness import manifest;"
            "[manifest.config_module(c['name']) for c in manifest.load_manifest()['configs']];"
            "[manifest.driver_module(d) for d in ('train', 'synthesis')];"
            "import artspeech_tpu_torch.train.step, artspeech_tpu_torch.synth.pipeline;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (manifest.ROOT, FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={**os.environ, "USE_FLAX": "0"}, cwd=manifest.ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_without_a_card_no_result(tmp_path):
    out = subprocess.run([sys.executable, os.path.join(manifest.BENCH_DIR, "run.py"),
                          "--workload", "artspeech_train_b256", "--seed", "2147483659",
                          "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=manifest.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
