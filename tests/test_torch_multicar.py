"""The PyTorch port's batched env at MultiCarRacing-v0 (two cars per env)
against the JAX package's on the CPU: the reset and a short trajectory before
any car-car contact.

- Reset: 4 seeds reset in both packages. The spawn tick pays each car's
  spawn-tile bonuses; both cars of an env stand on one tile line, so the
  second visitor of a tile is paid (1 - 1/2) of the bonus — the
  ``rank > 0`` / ``factor < 1`` path of the visit rewards, which one car
  per env never runs. Rewards equal, cars within 5e-4 * max(1, max|jax|),
  masks and the (empty) contact carry equal.
- Trajectory: 20 steps of one fixed numpy action sequence on each
  package's own state, with no car-car contact in either (checked): per step
  rewards within 2e-5 and masks equal, hull positions within 1e-3 m at the
  end — the bars tests/test_torch_env.py holds one car per env to."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N = 2
SEEDS = (0, 1, 2, 3)
STEPS = 20
REWARD_TOL = 2e-5
CAR_TOL = 5e-4
JCFG = JC.EnvConfig(num_agents=N, use_random_direction=False, solver="xla")
PCFG = EnvConfig(num_agents=N, use_random_direction=False)
ACTIONS = np.random.RandomState(1).uniform(
    [-0.3, 0, 0], [0.3, 1, 0.2], size=(STEPS, len(SEEDS), N, 3)).astype(np.float32)
MASKS = ("done", "visited", "tile_touched", "wheel_on_road", "driving_on_grass",
         "driving_backward", "tile_visited_count", "steps")


def jax_reset(cfg, seeds):
    """bench.py's reset: host tracks, then one jitted vmap(reset_from_parts)."""
    tracks, orders = [], []
    for s in seeds:
        orders.append(np.asarray(jseed.GlobalStream(s).car_order(cfg.num_agents)))
        pts, border, _ = jhost.generate_track(jseed.np_random(s)[0])
        tracks.append(jenv.pack_track(pts, border, max_tiles=cfg.max_tiles))
    stack = jax.tree_util.tree_map(lambda *l: jnp.stack(l), *tracks)
    return jax.jit(jax.vmap(partial(jenv.reset_from_parts, cfg)))(
        stack, jnp.asarray(np.stack(orders), jnp.int32),
        jnp.asarray([cfg.direction == "CW"] * len(seeds)))


def cmp_cars(jcars, pcars, tol=CAR_TOL):
    for f in ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a", "wheel_v",
              "wheel_w", "joint_impulse", "motor_impulse", "spin", "phase", "fuel_spent"):
        a, b = np.asarray(getattr(jcars, f)), getattr(pcars, f).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        assert float(np.abs(a - b).max()) <= tol * scale, f
    assert np.array_equal(np.asarray(jcars.limit_state), pcars.limit_state.numpy())


def cmp_masks(jst, pst):
    for f in MASKS:
        assert np.array_equal(np.asarray(getattr(jst, f)), getattr(pst, f).numpy()), f


@pytest.fixture(scope="module")
def jax_reset_state():
    return jax_reset(JCFG, SEEDS)


def test_reset_at_two_cars_matches_jax(jax_reset_state):
    jst = jax_reset_state
    pst = penv.reset_batch(PCFG, SEEDS, len(SEEDS), device="cpu")
    cmp_cars(jst.cars, pst.cars)
    cmp_masks(jst, pst)
    jr = np.asarray(jst.reward)
    assert np.array_equal(pst.reward.numpy(), jr)
    # Each env's second visitor of its spawn tiles is paid a fraction.
    bonus = 1000.0 / np.asarray(jst.track.n_tiles, np.float64)
    assert (np.abs(jr.min(1) - jr.max(1) / 2) < 1e-4).all() and (jr.min(1) > 0).all()
    assert (jr.max(1) < 2.5 * bonus).all()
    for f in ("normal_imp", "tangent_imp", "ids"):
        assert np.array_equal(np.asarray(getattr(jst.contacts, f)),
                              getattr(pst.contacts, f).numpy()), f
    assert pst.contacts.ids.shape == (len(SEEDS), 48)


def test_pre_contact_trajectory_at_two_cars(jax_reset_state):
    step = jax.jit(jax.vmap(partial(jenv.step, JCFG)))
    jst = jax_reset_state
    pst = penv.reset_batch(PCFG, SEEDS, len(SEEDS), device="cpu")
    j_ret = np.zeros((len(SEEDS), N))
    p_ret = np.zeros((len(SEEDS), N))
    for t in range(STEPS):
        jst, jr, _ = step(jst, jnp.asarray(ACTIONS[t]))
        pst, pr, _ = penv.step(PCFG, pst, torch.from_numpy(ACTIONS[t]))
        assert int(np.asarray(jst.contacts.ids).max()) == -1, f"contact at step {t}"
        assert int(pst.contacts.ids.max()) == -1, f"port contact at step {t}"
        np.testing.assert_allclose(pr.numpy(), np.asarray(jr), rtol=0, atol=REWARD_TOL)
        cmp_masks(jst, pst)
        j_ret += np.asarray(jr)
        p_ret += pr.numpy()
    pos_dev = float(np.abs(np.asarray(jst.cars.hull_c) - pst.cars.hull_c.numpy()).max())
    print(f"{STEPS}-step parity at N=2: |return diff| {np.abs(j_ret - p_ret).max():.3g}, "
          f"|hull position diff| {pos_dev:.3g} m")
    assert pos_dev <= 1e-3
    cmp_cars(jst.cars, pst.cars)
