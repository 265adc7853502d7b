"""The port's episode drills (``oracle/episodes.py``) against the JAX
package's ``oracle/episodes.py``, on the CPU.

- ``lane_offsets`` and the per-car ``follower_action`` equal JAX's on the
  same states; the batched ``follower_actions`` (float64 tensors over
  (E, N)) equals the per-car one on an (E = 4, N = 3) batch, in the
  follower's lanes and on one shared line.
- ``nudge`` moves car 0's hull x by 1e-4 m (a float32 add) and nothing else.
- A 60-step N = 1 open-loop replay through the plain port
  (``run_episodes_open``) against JAX's ``run_engine_episode`` on the same
  actions: rewards within 2e-5 per step, the same tiles and done step.
- The closed loop records the actions that it stepped with, and replaying
  them gives its rewards bit for bit.
"""

import jax
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import env as jenv
from multi_car_racing_tpu.oracle import episodes as jep
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.oracle import episodes as ep

from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

RESETS = [(100, 200, "CCW"), (101, 201, "CW"), (102, 202, "CW"), (103, 203, "CCW")]


@pytest.fixture(scope="module")
def moved():
    """Four N = 3 envs, both directions, after 3 steps of random actions."""
    cfg = EnvConfig(num_agents=3)
    state = ep.reset_episodes(cfg, RESETS, device="cpu")
    rng = np.random.RandomState(0)
    for _ in range(3):
        a = torch.tensor(rng.uniform([-1, 0, 0], [1, 1, 0.3], (4, 3, 3)), dtype=torch.float32)
        state, _, _ = penv.step(cfg, state, a)
    return state


def _per_car(state, e, lanes, fn):
    nt = int(state.track.n_tiles[e])
    hulls = [(state.cars.hull_c[e, i].double().numpy(), state.cars.hull_v[e, i].double().numpy(),
              float(state.cars.hull_a[e, i])) for i in range(state.cars.hull_a.shape[1])]
    return fn(state.track.xy[e, :nt].double().numpy(), state.track.beta[e, :nt].double().numpy(),
              bool(state.direction_cw[e]), hulls, lanes=lanes)


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_lane_offsets_match_jax(n):
    np.testing.assert_array_equal(ep.lane_offsets(n), jep.lane_offsets(n))


@pytest.mark.parametrize("lanes", [None, "shared"])
def test_follower_matches_jax_and_the_batched_follower(moved, lanes):
    lanes = np.zeros(3) if lanes == "shared" else None
    batched = ep.follower_actions(moved.track, moved, lanes).numpy()
    assert batched.shape == (4, 3, 3) and batched.dtype == np.float64
    for e in range(4):
        mine = _per_car(moved, e, lanes, ep.follower_action)
        np.testing.assert_array_equal(mine, _per_car(moved, e, lanes, jep.follower_action))
        np.testing.assert_array_equal(batched[e], mine)
    assert len({bool(moved.direction_cw[e]) for e in range(4)}) == 2


def test_nudge_moves_one_hull(moved):
    out = ep.nudge(moved, car=0, dx=1e-4)
    x = moved.cars.hull_c[:, 0, 0].numpy()
    np.testing.assert_array_equal(out.cars.hull_c[:, 0, 0].numpy(), x + np.float32(1e-4))
    np.testing.assert_allclose(out.cars.hull_c[:, 0, 0].numpy().astype(np.float64) - x,
                               1e-4, rtol=0, atol=2 ** -17)   # an ulp of x ~ 200 m
    assert torch.equal(out.cars.hull_c[:, 1:], moved.cars.hull_c[:, 1:])
    assert torch.equal(out.cars.hull_c[:, 0, 1], moved.cars.hull_c[:, 0, 1])
    for f in ("hull_a", "hull_v", "wheel_c", "wheel_a"):
        assert torch.equal(getattr(out.cars, f), getattr(moved.cars, f)), f


def test_open_replay_matches_jax_engine_episode(monkeypatch):
    # JAX's host_reset takes its track from the native generator; the Python
    # walk gives the same track without building into the JAX package. Its
    # spawn tick runs eagerly there (~10 s of op-by-op dispatch); jitted, it
    # compiles in a few.
    monkeypatch.setattr(jhost, "generate_track_fast", jhost.generate_track)
    monkeypatch.setattr(jenv, "reset_from_parts", jax.jit(jenv.reset_from_parts,
                                                          static_argnums=0))
    steps = 60
    rng = np.random.RandomState(3)
    actions = np.stack([rng.uniform(-0.4, 0.4, steps), np.full(steps, 0.6),
                        np.where(np.arange(steps) % 20 == 19, 0.5, 0.0)], -1).astype(np.float32)
    ref = jep.run_engine_episode(1, 104, 204, actions[:, None], "CW", max_steps=steps)
    out = ep.run_episodes_open(EnvConfig(num_agents=1), [(104, 204, "CW")],
                               actions[:, None, None], device="cpu")
    np.testing.assert_allclose(out["rewards"][:, 0], ref["rewards"], rtol=0, atol=2e-5)
    assert out["tiles"][0].tolist() == ref["tiles"] and ref["tiles"][0] > 0
    assert int(out["done_step"][0]) == ref["done_step"] == steps
    assert int(out["n_tiles"][0]) == ref["n_tiles"]
    assert out["near"].tolist() == [0] * steps and out["contact_step"].tolist() == [-1]


def test_closed_loop_replays_bit_for_bit():
    cfg = EnvConfig(num_agents=2)
    resets = RESETS[:2]
    closed = ep.run_episodes_closed(cfg, resets, max_steps=2, device="cpu")
    assert closed["actions"].shape == (2, 2, 2, 3) and closed["actions"].dtype == np.float32
    assert (closed["actions"][:, :, :, 1] > 0).any()           # the follower drives
    again = ep.run_episodes_open(cfg, resets, closed["actions"], device="cpu")
    for k in ("rewards", "done_step", "tiles", "near", "contact_step"):
        np.testing.assert_array_equal(again[k], closed[k], k)
    if not torch.cuda.is_available():           # the runners default to the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ep.run_episodes_closed(cfg, resets, max_steps=1)
