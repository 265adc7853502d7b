"""Without a CUDA device the benchmark prints no result and exits non-zero
with a message that says why; it never falls back to the CPU. So does a
checkout that holds only BENCHMARK.json and the benchmark's own files."""

import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent.parent
ARGS = ["--workload", "mcr2-state-lanes", "--seed", str(2 ** 31 + 3), "--seconds", "1",
        "--trace", "0"]


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_run_without_a_card_exits_nonzero():
    _no_card()
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert "no CUDA device" in out.stderr
    assert out.stdout.strip() == ""


def test_a_checkout_of_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "benchmark/run.py", *ARGS], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
