"""The port's Gym facade against the JAX package's, on the CPU: both seeded
alike, reset, then a few steps of the same flat actions (each facade
reshapes them to (N, 3)); what the facade layer returns at its numpy
boundary must agree: the observation, the reward, ``done``, and the
per-agent properties. The batched cores are held against each other in
tests/test_torch_env.py; this test holds the layer above them (the E = 1
squeeze, the reshape, the reward and ``done`` handed back).

Both facades keep their default solver iterations: the JAX facade jits its
step from the config it is built with, and tests/test_api_polish.py builds
the same MultiCarRacing-v0 config, so the JAX compilation cache can serve
both files. One JAX compile of reset, step and the 96x96 painter (~45 s
cold) is this file's cost.
"""

import numpy as np

from multi_car_racing_tpu import gym_api as jgym

from multi_car_racing_tpu_torch import gym_api
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

STEPS = 3
REWARD_TOL = 2e-5      # as tests/test_torch_env.py's per-step reward bar


def _agree(jenv, penv):
    assert penv.track_length == jenv.track_length
    assert penv.tile_visited_count == [int(x) for x in jenv.tile_visited_count]
    for prop in ("driving_backward", "driving_on_grass"):
        j, p = getattr(jenv, prop), getattr(penv, prop)
        assert p.shape == j.shape and np.array_equal(p, j), prop
    assert penv.reward.shape == jenv.reward.shape
    np.testing.assert_allclose(penv.reward, jenv.reward, rtol=0, atol=REWARD_TOL)


def test_facade_matches_the_jax_facade():
    kw = dict(num_agents=2, verbose=0, global_seed=4)
    jenv = jgym.make("MultiCarRacing-v0", **kw)
    penv = gym_api.make("MultiCarRacing-v0", device="cpu", **kw)
    assert jenv.seed(7) == penv.seed(7) == [7]
    jo, po = jenv.reset(), penv.reset()
    assert po.shape == jo.shape == (2, 96, 96, 3) and po.dtype == jo.dtype
    assert np.array_equal(po, jo)
    _agree(jenv, penv)
    rng = np.random.default_rng(0)
    for _ in range(STEPS):
        # Per-agent actions, flat: a reshape to (3, 2) or an agent swap shows.
        a = rng.uniform([-1.0, 0.0, 0.0], [1.0, 1.0, 0.5], (2, 3)).astype(np.float32)
        jo, jr, jd, jinfo = jenv.step(a.reshape(-1))
        po, pr, pd, pinfo = penv.step(a.reshape(-1))
        assert np.array_equal(po, jo)
        assert pr.shape == jr.shape == (2,)
        np.testing.assert_allclose(pr, jr, rtol=0, atol=REWARD_TOL)
        assert type(pd) is type(jd) is bool and pd == jd
        assert pinfo == jinfo == {}
        _agree(jenv, penv)
