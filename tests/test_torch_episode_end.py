"""The post-step analysis of the port (stage 4 of a step: step cost, the
backward penalty, off-playfield and all-tiles-visited termination) against
the JAX package's, at one and at two cars per env, on paths a plain driven
trajectory does not reach.

From one JAX reset of 4 envs, each env is set up for one path, then both
packages step the same states with the same actions:
  env 0: the clockwise episode direction (spawned facing CW);
  env 1: a CCW spawn whose direction flag says CW, so every car drives
         against the track and the backward branch fires (its penalty
         weight K_BACKWARD is the reference's 0.0, mcr:78, so it is the
         flag that shows it);
  env 2: car 0 moved 700 m east, past PLAYFIELD: reward -100 and done;
  env 3: car 0's visited-tile count at the track's tile count: done.
Bars: rewards within 2e-5, done / backward / grass flags and every other
mask equal, at each of 3 steps; the cars within 5e-4 * max(1, max|jax|) at
the end."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv

from test_torch_multicar import REWARD_TOL, cmp_cars, cmp_masks, jax_reset
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 1, 2, 3)
STEPS = 3


def _setup(n):
    cw = JC.EnvConfig(num_agents=n, use_random_direction=False, direction="CW", solver="xla")
    ccw = JC.EnvConfig(num_agents=n, use_random_direction=False, solver="xla")
    a, b = jax_reset(cw, SEEDS), jax_reset(ccw, SEEDS)
    st = jax.tree_util.tree_map(lambda x, y: x.at[0].set(y[0]), b, a)
    st = st.replace(direction_cw=jnp.asarray([True, True, False, False]))
    shift = jnp.asarray([700.0, 0.0], jnp.float32)
    cars = st.cars.replace(hull_c=st.cars.hull_c.at[2, 0].add(shift),
                           wheel_c=st.cars.wheel_c.at[2, 0].add(shift))
    count = st.tile_visited_count.at[3, 0].set(st.track.n_tiles[3])
    return ccw, st.replace(cars=cars, tile_visited_count=count)


@pytest.mark.parametrize("n", [1, 2])
def test_episode_end_paths_match_jax(n):
    jcfg, jst = _setup(n)
    pcfg = EnvConfig(num_agents=n, use_random_direction=False)
    pst = convert.env_state_from_numpy(jax.device_get(jst), device="cpu")
    step = jax.jit(jax.vmap(partial(jenv.step, jcfg)))
    actions = np.random.RandomState(n).uniform(
        [-0.2, 0.3, 0], [0.2, 1, 0.1], size=(STEPS, len(SEEDS), n, 3)).astype(np.float32)
    for t in range(STEPS):
        jst, jr, jd = step(jst, jnp.asarray(actions[t]))
        pst, pr, pd = penv.step(pcfg, pst, torch.from_numpy(actions[t]))
        jr = np.asarray(jr)
        np.testing.assert_allclose(pr.numpy(), jr, rtol=0, atol=REWARD_TOL)
        assert np.array_equal(pd.numpy(), np.asarray(jd))
        cmp_masks(jst, pst)
        np.testing.assert_allclose(pst.reward.numpy(), np.asarray(jst.reward), atol=REWARD_TOL)
        # Each env is on the path it was set up for.
        back = np.asarray(jst.driving_backward)
        assert bool(jst.direction_cw[0]) and not back[0].any()
        assert back[1].all()
        assert jr[2, 0] == -100.0 and bool(jd[2]) and bool(jd[3]) and not bool(jd[0] | jd[1])
    cmp_cars(jst.cars, pst.cars)
