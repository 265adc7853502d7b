"""The port's batched facade ``VectorMultiCarRacing`` on the CPU.

- The shape, autoreset and time-limit semantics of the JAX package's
  (tests/test_aux.py::test_vector_env_facade) at E = 4, N = 2: state
  observations (E, N, 38), rewards (E, N), dones (E,); after 14 steps under a
  12-step limit every env has been reset; pixel observations (E, N, 96, 96,
  3) uint8; obs="none" returns None.
- The facade layer against the JAX package's ``VectorMultiCarRacing`` from
  one common start state: both facades' reset state and pool replaced by
  the same host-track state (the port's ``reset_batch``), then 3 steps of
  the same actions. Observations within 5e-4 * max(1, |x|) and rewards
  within 2e-5 (tests/test_torch_env.py's per-step bars), dones equal.
  Tracks are not compared here: JAX draws them with threefry
  (tests/test_torch_track_device.py holds the generators).
- The ``device`` keyword: CUDA by default, which raises without a card;
  ``device="cpu"`` runs the plain path.
"""

import jax
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import gym_api as jgym

import multi_car_racing_tpu_torch as mcr
from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv, obs as pobs
from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

E, N = 4, 2
FAST = dict(velocity_iters=8, position_iters=3)
OBS_TOL, REWARD_TOL = 5e-4, 2e-5
PARITY_STEPS = 3


def test_vector_env_facade():
    venv = mcr.VectorMultiCarRacing(E, num_agents=N, obs="state", seed=3, pool_size=2,
                                    max_episode_steps=12, device="cpu", **FAST)
    obs = venv.reset()
    assert obs.shape == (E, N, pobs.STATE_OBS_DIM) and obs.dtype == np.float32
    assert venv.observation_space.shape == obs.shape
    assert venv.action_space.shape == (E, N, 3)
    a = np.tile([0.0, 0.7, 0.0], (E, N, 1))
    limited = False
    for t in range(14):
        obs, r, d, info = venv.step(a)
        assert obs.shape == (E, N, pobs.STATE_OBS_DIM) and r.shape == (E, N) and d.shape == (E,)
        assert np.isfinite(obs).all() and np.isfinite(r).all() and info == {}
        steps = venv.state.steps.numpy()
        assert (d == (venv.state.done.numpy() | (steps >= 12))).all()
        limited |= bool(d.all()) and t == 10       # the spawn tick is step 1: 12 at t = 10
    assert limited
    # The time limit is 12 and the spawn tick is step 1: every env reached
    # it at t = 10, was reset at the start of t = 11 (step counter 1 after
    # the fresh spawn tick), so its counter is 4 after 14 steps, and its
    # fresh track is a pool track.
    steps = venv.state.steps.numpy()
    assert (steps == 4).all(), steps
    pool_xy = venv._pool.xy[:, :4].reshape(2, -1)
    assert all(any(torch.equal(venv.state.track.xy[e, :4].reshape(-1), p) for p in pool_xy)
               for e in range(E))
    venv.close()
    assert venv.state is None
    with pytest.raises(RuntimeError, match="reset"):
        venv.step(a)


def test_vector_env_pixels_and_none():
    venv = mcr.VectorMultiCarRacing(2, num_agents=2, obs="pixels", seed=0, pool_size=2,
                                    device="cpu", **FAST)
    obs = venv.reset()
    assert obs.shape == (2, 2, 96, 96, 3) and obs.dtype == np.uint8
    obs, r, d, _ = venv.step(np.zeros((2, 2, 3)))
    assert obs.shape == (2, 2, 96, 96, 3) and r.shape == (2, 2)
    venv = mcr.VectorMultiCarRacing(2, num_agents=1, obs="none", seed=0, pool_size=1,
                                    device="cpu", **FAST)
    assert venv.reset() is None and venv.observation_space is None
    obs, r, d, _ = venv.step(np.zeros(6))           # any shape: reshaped to (E, N, 3)
    assert obs is None and r.shape == (2, 1) and d.shape == (2,)
    with pytest.raises(ValueError):
        mcr.VectorMultiCarRacing(2, obs="rgb", device="cpu")


def test_vector_env_device_keyword():
    with pytest.raises(RuntimeError, match="CUDA"):
        mcr.VectorMultiCarRacing(2)
    venv = mcr.VectorMultiCarRacing(2, device="cpu")
    assert venv.device == torch.device("cpu") and venv._generator.device.type == "cpu"


def test_vector_env_matches_the_jax_facade():
    cfg = EnvConfig(num_agents=N, use_random_direction=False, **FAST)
    start = penv.reset_batch(cfg, range(E), E, device="cpu")
    host = convert.env_state_to_numpy(start)
    pv = mcr.VectorMultiCarRacing(E, num_agents=N, obs="state", device="cpu",
                                  use_random_direction=False, **FAST)
    jv = jgym.VectorMultiCarRacing(E, num_agents=N, obs="state", use_random_direction=False,
                                   solver="xla", **FAST)
    pv._state, pv._pool = start, start.track
    jstart = jax_state(host)
    jv._state, jv._pool = jstart, jstart.track
    rng = np.random.RandomState(5)
    for _ in range(PARITY_STEPS):
        a = rng.uniform([-1, 0, 0], [1, 1, 0.2], (E, N, 3)).astype(np.float32)
        po, pr, pd, pinfo = pv.step(a)
        jo, jr, jd, jinfo = jv.step(a)
        jo, jr, jd = (np.asarray(x) for x in jax.device_get((jo, jr, jd)))
        assert po.shape == jo.shape and pr.shape == jr.shape and pd.shape == jd.shape
        np.testing.assert_array_less(np.abs(po - jo), OBS_TOL * np.maximum(1.0, np.abs(jo)) + 1e-12)
        np.testing.assert_allclose(pr, jr, rtol=0, atol=REWARD_TOL)
        assert np.array_equal(pd, jd) and pinfo == jinfo == {}
