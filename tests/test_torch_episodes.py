"""Episode management of the port (env.make_host_track_pool, draw_episodes,
reset_envs_from_pool, reset_done_envs) against the JAX package's, on the CPU.

- ``reset_envs_from_pool`` with given pool indices, car orders and
  directions, against JAX ``jax.vmap(reset_from_parts)`` on the same pool
  tracks plus JAX ``reset_done_envs``'s selection (``done | steps >=
  max_episode_steps``), at N = 1 and 2 over E = 4 envs of which two need a
  reset (one done, one at the time limit) and two do not (one a step short
  of the limit). Fresh envs are held to the reset bars of
  tests/test_torch_multicar.py (cars within 5e-4 * max(1, |x|), limit
  states, masks and rewards equal); the other envs are bit-identical to
  their input.
- ``draw_episodes`` is reproducible from a seeded generator, its indices
  fall in the pool, its orders are permutations, and its directions follow
  ``use_random_direction``.
- ``make_host_track_pool`` is bit-equal to ``track_from_arrays`` of the same
  seeds and to the JAX package's packing of its host tracks.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
from multi_car_racing_tpu.track import common as jcommon, host as jhost

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv, seeding as pseed
from multi_car_racing_tpu_torch.track import host as phost
from multi_car_racing_tpu_torch.track.common import pack_track_arrays, track_from_arrays
from multi_car_racing_tpu_torch.util import tree_leaves, tree_map

from test_torch_multicar import cmp_cars, cmp_masks
from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 1, 2, 3)
POOL_SEEDS = (10, 11, 12)
IDX = (2, 0, 1, 2)
DONE = (True, False, False, False)
STEPS = (5, 1000, 3, 999)          # with DONE: envs 0 and 1 need a reset


def _jax_track(track, idx) -> jcommon.Track:
    """Pool entries ``idx`` of a port Track as a JAX Track."""
    return jcommon.Track(**{f.name: jnp.asarray(getattr(track, f.name)[list(idx)].numpy())
                            for f in dataclasses.fields(jcommon.Track)})


@pytest.mark.parametrize("n", [1, 2])
def test_reset_envs_from_pool_matches_jax(n):
    cfg = EnvConfig(num_agents=n, use_random_direction=False)
    jcfg = JC.EnvConfig(num_agents=n, use_random_direction=False, backwards_flag=False,
                        solver="xla")
    pool = penv.make_host_track_pool(cfg, POOL_SEEDS, device="cpu")
    state = penv.reset_batch(cfg, SEEDS, len(SEEDS), device="cpu")
    state = state.replace(done=torch.tensor(DONE),
                          steps=torch.tensor(STEPS, dtype=torch.int32))
    rng = np.random.RandomState(n)
    orders = np.stack([rng.permutation(n) for _ in SEEDS]).astype(np.int32)
    dirs = np.array([True, False, True, False])
    out = penv.reset_envs_from_pool(cfg, state, pool, torch.tensor(IDX),
                                    torch.from_numpy(orders), torch.from_numpy(dirs))

    fresh = jax.jit(jax.vmap(partial(jenv.reset_from_parts, jcfg)))(
        _jax_track(pool, IDX), jnp.asarray(orders), jnp.asarray(dirs))
    needs = np.array(DONE) | (np.array(STEPS) >= cfg.max_episode_steps)
    assert needs.tolist() == [True, True, False, False]
    # JAX reset_done_envs's selection, leaf by leaf, on the same input state.
    ref = jax.tree_util.tree_map(
        lambda new, old: np.where(needs.reshape((-1,) + (1,) * (new.ndim - 1)), new,
                                  np.asarray(old)),
        jax.device_get(fresh), jax_state(convert.env_state_to_numpy(state)))
    cmp_cars(ref.cars, out.cars)
    cmp_masks(ref, out)
    for f in ("reward", "prev_reward", "direction_cw", "t"):
        np.testing.assert_array_equal(getattr(out, f).numpy(), np.asarray(getattr(ref, f)), f)
    for f in dataclasses.fields(jcommon.Track):
        np.testing.assert_array_equal(getattr(out.track, f.name).numpy(),
                                      np.asarray(getattr(ref.track, f.name)), f.name)
    assert out.steps.tolist() == [1, 1, 3, 999]
    keep = np.flatnonzero(~needs)
    for a, b in zip(tree_leaves(tree_map(lambda t: t[keep], out)),
                    tree_leaves(tree_map(lambda t: t[keep], state))):
        assert torch.equal(a, b) and a.dtype == b.dtype

    # reset_done_envs = draw_episodes + reset_envs_from_pool from one generator.
    g1, g2 = torch.Generator().manual_seed(3), torch.Generator().manual_seed(3)
    via = penv.reset_done_envs(cfg, state, pool, g1)
    direct = penv.reset_envs_from_pool(cfg, state, pool,
                                       *penv.draw_episodes(cfg, len(SEEDS), len(POOL_SEEDS), g2))
    for a, b in zip(tree_leaves(via), tree_leaves(direct)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("random_direction", [True, False])
def test_draw_episodes(random_direction):
    n, E, P = 3, 4096, 32
    cfg = EnvConfig(num_agents=n, use_random_direction=random_direction, direction="CW")
    a = penv.draw_episodes(cfg, E, P, torch.Generator().manual_seed(7))
    b = penv.draw_episodes(cfg, E, P, torch.Generator().manual_seed(7))
    c = penv.draw_episodes(cfg, E, P, torch.Generator().manual_seed(8))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    idx, orders, dirs = a
    assert idx.shape == (E,) and int(idx.min()) >= 0 and int(idx.max()) < P
    assert len(torch.unique(idx)) == P
    assert orders.shape == (E, n) and orders.dtype == torch.int32
    assert torch.equal(torch.sort(orders, dim=1).values,
                       torch.arange(n, dtype=torch.int32).expand(E, n))
    assert len(torch.unique(orders, dim=0)) == 6        # all 3! orders drawn
    assert dirs.dtype == torch.bool and dirs.shape == (E,)
    if random_direction:
        assert 0.45 < float(dirs.float().mean()) < 0.55
    else:
        assert bool(dirs.all())


def test_make_track_pool_is_the_host_tracks():
    cfg = EnvConfig(num_agents=2)
    pool = penv.make_host_track_pool(cfg, POOL_SEEDS, device="cpu")
    arrays = [pack_track_arrays(*phost.generate_track(pseed.np_random(s)[0])[:2],
                                cfg.max_tiles) for s in POOL_SEEDS]
    same = track_from_arrays(arrays, "cpu")
    jtracks = []
    for s in POOL_SEEDS:
        pts, border, _ = jhost.generate_track(jseed.np_random(s)[0])
        jtracks.append(jenv.pack_track(pts, border, max_tiles=cfg.max_tiles))
    for f in dataclasses.fields(pool):
        got = getattr(pool, f.name)
        assert torch.equal(got, getattr(same, f.name)) and got.is_contiguous(), f.name
        ref = np.stack([np.asarray(getattr(t, f.name)) for t in jtracks])
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=f.name)
    with pytest.raises(ValueError):
        penv.make_host_track_pool(cfg, (), device="cpu")
