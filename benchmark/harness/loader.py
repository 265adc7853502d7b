"""Find the benchmark's parts by name: one file per configuration, traffic
mix, cell, policy stand-in, per-layer metric and kernel work counter.

- ``configs/<name>.json``: the environment's settings as run (``env``),
  beside its ``source``;
- ``traffic/<name>.json``: a traffic mix -- envs, action repeat, chunk
  length, the track pool's seeds, observation, the policy stand-in and its
  parameters,
  and what the correctness check samples -- read by the one generator in
  ``harness/rollout.py``; ``traffic/<policy>.py``: a policy stand-in;
- ``workloads/<cell>.json``: a cell -- its configuration, traffic mix, chips,
  why, the limits of its correctness check, and the least compared work
  (``floors``) its sample must reach;
- ``metrics/<name>.py``: a per-layer metric, a reader of the traced run;
- ``counts/<kernel>.py``: a kernel's work counter.

Adding any of these means adding a file; ``BENCHMARK.json`` at the root of
the checkout lists the cells and the metrics each reports.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
SPEC_FILE = ROOT / "BENCHMARK.json"


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def spec() -> dict:
    return read_json(SPEC_FILE)


def _file(kind: str, name: str, suffix: str) -> Path:
    path = BENCH_DIR / kind / f"{name}{suffix}"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named "
                                f"{name!r}: {path.relative_to(ROOT)} is missing")
    return path


def config(name: str) -> dict:
    return read_json(_file("configs", name, ".json"))


def traffic(name: str) -> dict:
    return read_json(_file("traffic", name, ".json"))


def workload(name: str) -> dict:
    return read_json(_file("workloads", name, ".json"))


def module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (a metric's name may hold
    dots, so the module is imported as ``benchmark.<kind>`` plus its file)."""
    path = _file(kind, name, ".py")
    mod_name = f"benchmark.{kind}._{name.replace('.', '_').replace('-', '_')}"
    spec_ = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    """One cell, with everything its files say."""

    name: str
    workload: dict
    config: dict
    traffic: dict
    end_to_end: list          # BENCHMARK.json entries this cell reports
    per_layer: list

    @property
    def chips(self) -> int:
        return int(self.workload["chips"])


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name``: its workload file, configuration, traffic mix and
    the metrics that ``BENCHMARK.json`` (or ``bench``) gives it."""
    bench = spec() if bench is None else bench
    wl = workload(name)
    return Cell(name=name, workload=wl, config=config(wl["config"]),
                traffic=traffic(wl["traffic"]),
                end_to_end=[m for m in bench["end_to_end"] if _reports(m, name)],
                per_layer=[m for m in bench["per_layer"] if _reports(m, name)])
