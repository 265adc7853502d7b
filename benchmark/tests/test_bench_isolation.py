"""Nothing the benchmark runs imports JAX or the JAX package (module names
compared by their whole top-level name: the port's name begins with the JAX
package's), the reference and the work counters import nothing of the port,
and no file reads the JAX package's benchmark outputs."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "multi_car_racing_tpu"}
PORT = "multi_car_racing_tpu_torch"
FILES = sorted(p for p in BENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", [p for p in FILES if p.parts[len(BENCH.parts)] in
                                  ("reference", "counts")],
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_and_counts_import_nothing_of_the_port(path):
    assert PORT not in _imports(path)
    assert PORT not in path.read_text().replace(f"Frozen copy of {PORT}", "").replace(
        f"``{PORT}/", "").replace(f"of ``{PORT}", "")


def test_no_file_reads_the_jax_benchmark_outputs():
    for path in BENCH.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json") and path != Path(__file__):
            text = path.read_text()
            assert "BENCH_r" not in text and "MULTICHIP_" not in text, path
            assert "bench.py" not in text.replace("benchmark", ""), path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, '.'); "
            "from benchmark.harness import cell, check, rollout, trace; "
            "from multi_car_racing_tpu_torch import env, obs; "
            "print(cell.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True,
                         text=True)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
