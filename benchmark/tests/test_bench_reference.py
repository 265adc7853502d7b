"""The benchmark's plain reference against the port's plain paths on the
CPU at a tiny size: the tracks (the reference's Python walk against the
port's native one), the autoreset draws, a step with car-car contact, the
spawn tick, and both observations agree bit for bit."""

import dataclasses

import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig
from multi_car_racing_tpu_torch import env as penv
from multi_car_racing_tpu_torch import obs as pobs

from benchmark.reference import config as RC
from benchmark.reference import env as renv
from benchmark.reference import obs as robs
from benchmark.reference import state_io
from benchmark.harness.check import reference_pool

SEEDS = [7, 2 ** 32 - 5, 123456789]
ITERS = dict(velocity_iters=30, position_iters=12)


def _equal_trees(a, b):
    ta, tb = state_io.tree(a), state_io.tree(b)
    flat_a = dict(_flat(ta))
    for k, v in _flat(tb):
        assert torch.equal(flat_a[k], v), k


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


@pytest.fixture(scope="module")
def pools():
    cfg = EnvConfig(num_agents=2, **ITERS)
    return cfg, penv.make_host_track_pool(cfg, SEEDS, device="cpu"), reference_pool(
        RC.EnvConfig(num_agents=2, **ITERS), SEEDS)


def test_tracks_equal(pools):
    _, port, ref = pools
    for f in dataclasses.fields(port):
        assert torch.equal(getattr(port, f.name), getattr(ref, f.name)), f.name


def _fresh(pools, n_envs=3, seed=11):
    cfg, port_pool, ref_pool = pools
    rcfg = RC.EnvConfig(num_agents=2, **ITERS)
    g1, g2 = torch.Generator().manual_seed(seed), torch.Generator().manual_seed(seed)
    draws = penv.draw_episodes(cfg, n_envs, len(SEEDS), g1)
    rdraws = renv.draw_episodes(rcfg, n_envs, len(SEEDS), g2)
    assert all(torch.equal(a, b) for a, b in zip(draws, rdraws))
    port = penv.episodes_from_pool(cfg, port_pool, *draws)
    idx, orders, dirs = rdraws
    tracks = ref_pool.__class__(**{f.name: getattr(ref_pool, f.name)[idx]
                                   for f in dataclasses.fields(ref_pool)})
    ref = renv.reset_from_parts(rcfg, tracks, orders, dirs)
    return cfg, rcfg, port, ref


def test_spawn_tick_equal(pools):
    _, _, port, ref = _fresh(pools)
    _equal_trees(ref, port)


def _rear_end(state):
    """Car 1 moved 4.9 m behind car 0 along its heading: the hulls overlap."""
    cars = state.cars
    a = cars.hull_a[:, 0]
    back = torch.stack([torch.sin(a), -torch.cos(a)], dim=-1) * 4.9
    shift = cars.hull_c[:, 0] + back - cars.hull_c[:, 1]
    new = {}
    for name in ("hull_c", "wheel_c"):
        x = getattr(cars, name).clone()
        x[:, 1] += shift if name == "hull_c" else shift[:, None]
        new[name] = x
    ang = cars.hull_a.clone()
    ang[:, 1] = ang[:, 0]
    wa = cars.wheel_a.clone()
    wa[:, 1] = wa[:, 0]
    return state.replace(cars=cars.replace(hull_a=ang, wheel_a=wa, **new))


def test_step_with_contact_and_state_observation_equal(pools):
    cfg, rcfg, port, ref = _fresh(pools)
    port = _rear_end(port)
    ref = state_io.env_state(state_io.tree(_rear_end(ref)))
    action = torch.tensor([[0.1, 0.6, 0.0], [-0.3, 1.0, 0.0]]).expand(3, 2, 3).contiguous()
    for _ in range(2):
        port, pr, pd = penv.step(cfg, port, action)
        ref, rr, rd = renv.step(rcfg, ref, action)
        assert torch.equal(pr, rr) and torch.equal(pd, rd)
        _equal_trees(ref, port)
    assert float(port.contacts.normal_imp.abs().max()) > 0
    assert torch.equal(pobs.state_observation(port), robs.state_observation(ref))


def test_pixel_observation_equal(pools):
    cfg, rcfg, port, ref = _fresh(pools, n_envs=1)
    got = pobs.pixel_observation_batched(cfg, port)
    assert got.shape == (1, 2, 96, 96, 3)
    assert torch.equal(got, robs.pixel_observation(rcfg, ref))
