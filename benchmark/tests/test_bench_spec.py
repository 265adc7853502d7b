"""BENCHMARK.json against the benchmark's contract and its files: names,
units and text fields in their alphabets, every ``moves`` target reported
in each of its metric's cells, and each configuration, cell, traffic mix,
policy, metric and work counter found by name; a new cell, traffic mix and
metric are picked up from new files alone."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from benchmark.harness import loader

ROOT = loader.ROOT
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"] and all(PATH.match(p) for p in SPEC["paths"])
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024


def test_names_units_and_text_fields():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in SPEC[group]]
        assert len(names) == len(set(names)), group
        for e in SPEC[group]:
            assert NAME.match(e["name"]), e["name"]
    for e in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(e["unit"]), e["unit"]
        assert e["better"] in ("lower", "higher")
    for e in SPEC["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert _text(e["source"]) and _text(e["why"]) and len(e["reduced"]) <= 16
        assert all(NAME.match(k) for k in e["reduced"])
    for e in SPEC["workloads"]:
        assert set(e) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(e["config"]) and NAME.match(e["traffic"]) and _text(e["why"])
        assert e["chips"] in (1, 4)
    for e in SPEC["end_to_end"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in SPEC["per_layer"]:
        assert set(e) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert e["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _text(e["layer"])
        if e["name"].endswith("_roofline_pct") or "mfu" in e["name"]:
            assert e["unit"] == "%"


def test_every_moves_target_is_reported_in_each_cell_of_its_metric():
    cells = [w["name"] for w in SPEC["workloads"]]
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}

    def cells_of(m):
        return m.get("workloads", cells)

    assert "setup_s" in e2e
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert set(cells_of(m)) <= set(cells)
        assert set(cells_of(m)) <= set(cells_of(e2e[m["moves"]])), m["name"]
    for c in cells:
        reported = [m for m in SPEC["end_to_end"] if c in cells_of(m)]
        assert "setup_s" in [m["name"] for m in reported] and len(reported) >= 2
        assert any(c in cells_of(m) for m in SPEC["per_layer"])


def test_each_part_is_found_by_name():
    for e in SPEC["configs"]:
        assert (ROOT / e["file"]).is_file() and e["file"].startswith("benchmark/")
        assert loader.config(e["name"])["source"] == e["source"]
    for e in SPEC["workloads"]:
        wl = loader.workload(e["name"])
        assert {k: wl[k] for k in ("config", "traffic", "chips", "why")} == \
            {k: e[k] for k in ("config", "traffic", "chips", "why")}
        cell = loader.cell(e["name"], SPEC)
        assert cell.traffic["policy"]["name"]
        assert callable(loader.module("traffic", cell.traffic["policy"]["name"]).make)
        assert set(wl["limits"]) >= {"state_gap", "reward_gap", "flag_share", "exact_mismatch"}
        assert set(wl.get("floors", {})) <= {"contact_env_steps"}
        if cell.config["env"]["num_agents"] > 1:      # the contact solve is compared
            assert wl["floors"]["contact_env_steps"] >= 1
    for m in SPEC["per_layer"]:
        mod = loader.module("metrics", m["name"])
        assert callable(mod.read)
        for c in mod.COUNTS:
            count = loader.module("counts", c)
            assert count.WHEN in ("step", "obs") and count.KERNELS and callable(count.work)
    with pytest.raises(FileNotFoundError):
        loader.workload("no-such-cell")


NEW_METRIC = '''"""A metric that a later change adds as a file of its own."""

COUNTS = ()


def read(ctx):
    return ctx.per_call_ms("policy")
'''


def test_new_cell_traffic_and_metric_are_new_files_only(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads(json.dumps(SPEC))
    before = {p: p.read_bytes() for p in (root / "benchmark").rglob("*") if p.is_file()}
    # The new files: a traffic mix, a cell, a metric; and entries in BENCHMARK.json.
    mix = dict(loader.traffic("state.lanes.e16384"), envs=8192)
    (root / "benchmark/traffic/state.lanes.e8192.json").write_text(json.dumps(mix))
    wl = dict(loader.workload("mcr2-state-lanes"), traffic="state.lanes.e8192",
              why="a smaller batch")
    (root / "benchmark/workloads/mcr2-state-lanes-e8192.json").write_text(json.dumps(wl))
    (root / "benchmark/metrics/policy.device_ms.py").write_text(NEW_METRIC)
    spec["workloads"].append({"name": "mcr2-state-lanes-e8192", "config": wl["config"],
                              "traffic": wl["traffic"], "chips": 1, "why": wl["why"]})
    spec["per_layer"].append({"name": "policy.device_ms", "unit": "ms", "better": "lower",
                              "source": "device_trace", "layer": "policy stand-in",
                              "moves": "env_steps_per_s"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("from benchmark.harness import loader; c = loader.cell('mcr2-state-lanes-e8192'); "
            "print(c.traffic['envs'], c.per_layer[-1]['name'], "
            "loader.module('metrics', 'policy.device_ms').read.__name__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, env={"PYTHONPATH": str(root), "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["8192", "policy.device_ms", "read"]
    after = {p: p.read_bytes() for p in before}
    assert after == before                      # no file that was there changed
