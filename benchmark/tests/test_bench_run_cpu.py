"""A whole run of a cell on the CPU at a tiny size (``bench_helpers``),
without the look for a card: the port's plain paths against the reference
come out correct; the reference's bfloat16 control, and a timed path
broken underneath in each way a cell can break, come out not correct."""

import dataclasses
import time

import pytest
import torch

from bench_helpers import DECISIONS, tiny_cell
from benchmark.harness import cell as hc

CELLS = ("mcr2-state-lanes", "cr1-state", "pixels", "shared")


def _run(name, seed=2 ** 31 + 17, control=False):
    res = hc.run(tiny_cell(name), seed, 0.0, False, torch.device("cpu"),
                 time.perf_counter(), control=control, min_decisions=DECISIONS)
    res.pop("_lines")
    return res


@pytest.mark.parametrize("name", CELLS)
def test_plain_paths_are_correct(name):
    res = _run(name)
    assert res["correct"], res["check"]
    assert res["attempted"] >= DECISIONS and res["failed"] == 0
    assert list(res)[-1] == "check"
    assert all(v["value"] == 0 for v in res["check"].values()), res["check"]


@pytest.mark.parametrize("name", ("mcr2-state-lanes", "pixels"))
def test_bfloat16_control_is_not_correct(name):
    res = _run(name, control=True)
    assert not res["correct"]
    assert res["check"]["state_gap"]["value"] > res["check"]["state_gap"]["limit"]


def _unchanged(cfg, state, action):
    """A step that returns its state unchanged."""
    zero = torch.zeros_like(state.reward)
    return state, zero, state.done


def _half(step):
    """A step that leaves half of the batch out (those envs keep their
    state)."""
    def broken(cfg, state, action):
        new, reward, done = step(cfg, state, action)
        keep = torch.arange(state.steps.shape[0]) % 2 == 1

        def pick(a, b):
            return torch.where(keep.view((-1,) + (1,) * (a.dim() - 1)), b, a)

        from multi_car_racing_tpu_torch.util import tree_map
        return tree_map(pick, new, state), reward, done
    return broken


def _altered(step):
    """A step whose answer is altered where it is produced: car 0's hull
    moved by a centimetre in every env."""
    def broken(cfg, state, action):
        new, reward, done = step(cfg, state, action)
        hull_c = new.cars.hull_c.clone()
        hull_c[:, 0, 0] += 0.01
        return new.replace(cars=new.cars.replace(hull_c=hull_c)), reward, done
    return broken


@pytest.mark.parametrize("fault", ("unchanged", "half", "altered"))
def test_broken_timed_path_is_not_correct(monkeypatch, fault):
    from multi_car_racing_tpu_torch import env as penv

    step = penv.step
    broken = {"unchanged": lambda s: _unchanged, "half": _half, "altered": _altered}[fault]
    monkeypatch.setattr(penv, "step", broken(step))
    res = _run("shared", seed=5)
    assert not res["correct"], res["check"]


def test_sample_without_enough_contact_is_not_correct():
    """A cell whose floor of sampled env-steps with live car-car contact the
    sample does not reach: not correct, whatever the compared numbers say."""
    cell = tiny_cell("shared")
    cell = dataclasses.replace(cell, workload=dict(cell.workload,
                                                   floors={"contact_env_steps": 10 ** 6}))
    res = hc.run(cell, 5, 0.0, False, torch.device("cpu"), time.perf_counter(),
                 min_decisions=DECISIONS)
    res.pop("_lines")
    assert not res["correct"]
    assert all(v["value"] <= v["limit"] for k, v in res["check"].items() if "limit" in v)
    assert res["check"]["contact_env_steps"]["floor"] == 10 ** 6


def test_traced_run_replays_the_traced_chunks():
    """A ``--trace 1`` run: both profiled stretches, the replay that counts
    the kernels' work (no card here, so no device metric is read), and the
    check, correct as in an untraced run."""
    res = hc.run(tiny_cell("mcr2-state-lanes"), 11, 0.0, True, torch.device("cpu"),
                 time.perf_counter())
    lines = res.pop("_lines")
    assert "replay of the traced chunks equals the traced run: True" in lines
    assert res["correct"] and res["metrics"] == {}
    assert {"busy_s", "window_s"} <= set(res["device"]) and list(res)[-1] == "check"
