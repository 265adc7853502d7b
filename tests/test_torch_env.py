"""The PyTorch port's batched env against the JAX package's, at CarRacing-v0
(one car per env) on the CPU: the reset, single steps from identical states,
and the slice as a whole — 4 seeds reset in both packages, then 100 steps of
one fixed numpy action sequence.

Bars: per step, rewards within 2e-5 (tests/test_track_engine.py's bar) and
done / visited / tile_touched / wheel_on_road equal; over 100 steps (the
single-car system is non-chaotic, docs/PARITY.md §2) the return within 0.05
and hull positions within 1e-3 m."""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv, seeding as pseed
from multi_car_racing_tpu_torch.util import tree_leaves
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 1, 2, 3)
STEPS = 100
CAR_TOL = 5e-4
REWARD_TOL = 2e-5
JCFG = JC.EnvConfig(num_agents=1, use_random_direction=False, backwards_flag=False,
                    solver="xla")
PCFG = EnvConfig(num_agents=1, use_random_direction=False)
ACTIONS = np.random.RandomState(0).uniform(
    [-1, 0, 0], [1, 1, 0.2], size=(STEPS, len(SEEDS), 1, 3)).astype(np.float32)
MASKS = ("done", "visited", "tile_touched", "wheel_on_road", "driving_on_grass",
         "driving_backward", "tile_visited_count", "steps")


def _jax_reset(seeds):
    """bench.py's reset: host tracks, then one jitted vmap(reset_from_parts)."""
    tracks, orders, dirs = [], [], []
    for s in seeds:
        gs = jseed.GlobalStream(s)
        orders.append(np.asarray(gs.car_order(1)))
        pts, border, _ = jhost.generate_track(jseed.np_random(s)[0])
        tracks.append(jenv.pack_track(pts, border, max_tiles=JCFG.max_tiles))
        dirs.append(JCFG.direction == "CW")
    stack = jax.tree_util.tree_map(lambda *l: jnp.stack(l), *tracks)
    return jax.jit(jax.vmap(partial(jenv.reset_from_parts, JCFG)))(
        stack, jnp.asarray(np.stack(orders), jnp.int32), jnp.asarray(dirs))


@pytest.fixture(scope="module")
def jax_run():
    """JAX reset + trajectory: (states after 0..STEPS steps, rewards (STEPS,E,1))."""
    step = jax.jit(jax.vmap(partial(jenv.step, JCFG)))
    st = _jax_reset(SEEDS)
    states, rewards = [jax.device_get(st)], []
    for t in range(STEPS):
        st, r, _ = step(st, jnp.asarray(ACTIONS[t]))
        states.append(jax.device_get(st))
        rewards.append(np.asarray(r))
    return states, np.stack(rewards), step


def _cmp_cars(jcars, pcars, tol=CAR_TOL):
    for f in ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a",
              "wheel_v", "wheel_w", "joint_impulse", "motor_impulse", "spin",
              "phase", "fuel_spent", "gas", "brake", "steer"):
        a, b = np.asarray(getattr(jcars, f)), getattr(pcars, f).numpy()
        scale = max(1.0, float(np.abs(a).max()))
        assert float(np.abs(a - b).max()) <= tol * scale, f
    assert np.array_equal(np.asarray(jcars.limit_state), pcars.limit_state.numpy())


def _cmp_masks(jst, pst):
    for f in MASKS:
        assert np.array_equal(np.asarray(getattr(jst, f)), getattr(pst, f).numpy()), f


def test_reset_matches(jax_run):
    jst = jax_run[0][0]
    pst = penv.reset_batch(PCFG, SEEDS, len(SEEDS), device="cpu")
    for f in ("n_tiles", "valid", "xy", "beta", "quad", "quad_T", "quad_ax_T",
              "quad_lo", "quad_hi", "curb_quad_T", "has_curb", "curb_red", "color0"):
        assert np.array_equal(np.asarray(getattr(jst.track, f)),
                              getattr(pst.track, f).numpy()), f
    _cmp_cars(jst.cars, pst.cars)
    _cmp_masks(jst, pst)
    np.testing.assert_allclose(pst.reward.numpy(), np.asarray(jst.reward), atol=REWARD_TOL)
    assert np.array_equal(np.asarray(jst.direction_cw), pst.direction_cw.numpy())


def test_convert_roundtrip_keeps_values_and_dtypes(jax_run):
    jst = jax_run[0][5]
    back = convert.env_state_to_numpy(convert.env_state_from_numpy(jst, device="cpu"))

    def walk(j, p, path):
        if isinstance(p, dict):
            for k, v in p.items():
                walk(getattr(j, k), v, path + "." + k)
            return
        a = np.asarray(j)
        assert a.dtype == p.dtype and a.shape == p.shape, path
        assert np.array_equal(a, p), path

    walk(jst, back, "state")
    n_leaves = len(jax.tree_util.tree_leaves(jst))
    assert n_leaves == len(jax.tree_util.tree_leaves(back))
    assert back["cars"]["limit_state"].dtype == np.int32
    assert back["steps"].dtype == np.int32 and back["done"].dtype == np.bool_


@pytest.mark.parametrize("t", [0, 1, 30, 77])
def test_one_step_from_identical_states(jax_run, t):
    states, rewards, _ = jax_run
    pst = convert.env_state_from_numpy(states[t], device="cpu")
    pst, r, done = penv.step(PCFG, pst, torch.from_numpy(ACTIONS[t]))
    jst = states[t + 1]
    np.testing.assert_allclose(r.numpy(), rewards[t], rtol=0, atol=REWARD_TOL)
    _cmp_masks(jst, pst)
    assert np.array_equal(done.numpy(), np.asarray(jst.done))
    _cmp_cars(jst.cars, pst.cars)
    np.testing.assert_allclose(pst.reward.numpy(), np.asarray(jst.reward), atol=REWARD_TOL)


def test_trajectory_100_steps_matches(jax_run):
    """The slice as a whole: both packages reset the same 4 seeds and replay
    the same 100 actions on their own states."""
    states, rewards, _ = jax_run
    pst = penv.reset_batch(PCFG, SEEDS, len(SEEDS), device="cpu")
    p_ret = np.zeros((len(SEEDS), 1))
    pos_dev = 0.0
    for t in range(STEPS):
        pst, r, _ = penv.step(PCFG, pst, torch.from_numpy(ACTIONS[t]))
        p_ret += r.numpy()
        pos_dev = max(pos_dev, float(np.abs(
            np.asarray(states[t + 1].cars.hull_c) - pst.cars.hull_c.numpy()).max()))
    j_ret = rewards.sum(0)
    ret_dev = float(np.abs(j_ret - p_ret).max())
    print(f"100-step parity: max |return diff| {ret_dev:.3g}, "
          f"max |hull position diff| {pos_dev:.3g} m, returns {p_ret.ravel()}")
    assert ret_dev <= 0.05
    assert pos_dev <= 1e-3
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(pst) if x.is_floating_point())


def test_reset_batch_tiles_seeds_and_host_reset_agrees():
    st = penv.reset_batch(PCFG, (4, 9), 5, device="cpu")
    assert st.reward.shape == (5, 1) and st.cars.hull_c.shape == (5, 1, 2)
    for e in range(5):
        assert torch.equal(st.track.xy[e], st.track.xy[e % 2])
        assert torch.equal(st.cars.hull_c[e], st.cars.hull_c[e % 2])
    one, info = penv.host_reset(PCFG, seed=9, global_stream=pseed.GlobalStream(9),
                                device="cpu")
    assert info["n_tiles"] == int(st.track.n_tiles[1])
    assert torch.equal(one.cars.hull_c[0], st.cars.hull_c[1])
    assert torch.equal(one.reward[0], st.reward[1])


def test_contact_slice_is_refused():
    """Two cars per env now step; what stays refused is a state stepped under
    another car count than its own, instead of a silently wrong broadcast."""
    cfg2 = EnvConfig(num_agents=2)
    st2 = penv.reset_batch(cfg2, (0,), 1, device="cpu")
    assert st2.cars.hull_c.shape == (1, 2, 2) and st2.contacts.ids.shape == (1, 48)
    st = penv.reset_batch(PCFG, (0,), 1, device="cpu")
    with pytest.raises(ValueError, match="num_agents=2"):
        penv.step(cfg2, st, torch.zeros((1, 2, 3)))
    with pytest.raises(ValueError, match="expected actions"):
        penv.step(cfg2, st2, torch.zeros((1, 1, 3)))


@pytest.mark.parametrize("knob", ["track_skid", "exact_hull_touch"])
def test_render_knobs_are_refused(knob):
    """The render knobs were refused until the rgb_array painter was ported;
    now each is read, and never silently: with the knob off the state is
    what it was; with it on, ``track_skid`` grows the skid ring (the rear
    wheels spin at launch) and ``exact_hull_touch`` ORs the hull fixtures'
    SAT on the pre-solve pose into the touched flag
    (``tests/test_torch_raster.py`` holds both against JAX)."""
    from multi_car_racing_tpu_torch.physics.overlap import hull_tile_overlap

    base = EnvConfig(num_agents=1, use_random_direction=False, velocity_iters=8,
                     position_iters=3)
    cfg = dataclasses.replace(base, **{knob: True})
    st_on = penv.reset_batch(cfg, (0,), 1, device="cpu")
    st_off = penv.reset_batch(base, (0,), 1, device="cpu")
    gas = torch.tensor([[[0.0, 1.0, 0.0]]])
    ahead = False             # the bumper reached a tile before the wheels did
    for _ in range(20):
        pre, touched_before = st_on.cars, st_on.tile_touched
        st_on, _, _ = penv.step(cfg, st_on, gas)
        st_off, _, _ = penv.step(base, st_off, gas)
        if knob == "exact_hull_touch":
            want = st_off.tile_touched | hull_tile_overlap(pre, st_on.track) | touched_before
            assert torch.equal(st_on.tile_touched, want)
            ahead |= bool((st_on.tile_touched & ~st_off.tile_touched).any())
    assert int(st_off.skid.valid.sum()) == 0
    if knob == "track_skid":
        assert int(st_on.skid.valid.sum()) > 0
    else:
        assert ahead and int(st_on.skid.valid.sum()) == 0


@pytest.mark.parametrize("field", ["auto_reset", "dtype", "obs_type"])
def test_config_has_no_field_the_port_does_not_read(field):
    """A JAX-package knob that no module of the port reads is not a field of
    the port's config, so setting it fails instead of being ignored."""
    assert field in {f.name for f in dataclasses.fields(JC.EnvConfig)}
    with pytest.raises(TypeError):
        EnvConfig(**{field: getattr(JC.EnvConfig(), field)})


@pytest.mark.parametrize("field", ["max_track_points", "max_track_retries"])
def test_config_track_generator_bounds_carry_jax_defaults(field):
    """The on-device generator's bounds are fields of the port's config with
    the JAX package's defaults (env.device_reset and the pools read them)."""
    assert getattr(EnvConfig(), field) == getattr(JC.EnvConfig(), field)
    assert getattr(EnvConfig(**{field: 7}), field) == 7


def test_max_episode_steps_is_read_by_reset_done_envs():
    """``max_episode_steps`` is a field of the port's config, with the JAX
    package's default, and ``env.reset_done_envs`` resets at that limit: a
    fresh state (steps == 1) is reset at a limit of 1 and kept at 2."""
    assert EnvConfig().max_episode_steps == JC.EnvConfig().max_episode_steps
    pool = penv.make_host_track_pool(PCFG, (5,), device="cpu")
    for limit, reset in ((1, True), (2, False)):
        cfg = dataclasses.replace(PCFG, max_episode_steps=limit)
        st = penv.reset_batch(cfg, (0,), 1, device="cpu")     # steps == 1
        out = penv.reset_done_envs(cfg, st, pool, torch.Generator().manual_seed(0))
        assert torch.equal(out.track.xy, (pool if reset else st.track).xy)
