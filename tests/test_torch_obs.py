"""The port's state observation (obs.state_observation) against the JAX
package's ``jax.vmap(obs.state_observation)`` on the same states, on the CPU.

States: one port reset of 4 host tracks (seeds 0-3) at N = 1 and N = 2,
then every input the observation reads set from a numpy seed — hull poses
moved along and across the track (two cars next to the wrap of the tile
index, so the direction-signed lookahead indices wrap modulo n_tiles), hull
and wheel velocities, joint angles, controls, the grass and backward flags
— and the episode direction all CCW or all CW. The same numpy state goes
to both packages.

Bars: the nearest tile index equal; every feature within
1e-5 * max(1, |x|) of JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_car_racing_tpu import env as jenv, obs as jobs
from multi_car_racing_tpu.physics import collide as jcollide, state as jstate
from multi_car_racing_tpu.render import particles as jparticles
from multi_car_racing_tpu.track import common as jcommon

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv, obs as pobs
from multi_car_racing_tpu_torch.physics.track_engine import nearest_tile
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 1, 2, 3)
TOL = 1e-5
_JAX_TYPES = {"cars": jstate.CarState, "track": jcommon.Track,
              "contacts": jcollide.ContactState, "skid": jparticles.SkidState}


def jax_state(tree: dict):
    """A batched JAX EnvState from the port's numpy tree (same field names)."""
    kw = {}
    for k, v in tree.items():
        if k in _JAX_TYPES:
            kw[k] = _JAX_TYPES[k](**{f: jnp.asarray(x) for f, x in v.items()})
        else:
            kw[k] = jnp.asarray(v)
    return jenv.EnvState(**kw)


_RESETS = {}


def _reset(n):
    if n not in _RESETS:
        cfg = EnvConfig(num_agents=n, use_random_direction=False)
        _RESETS[n] = convert.env_state_to_numpy(
            penv.reset_batch(cfg, SEEDS, len(SEEDS), device="cpu"))
    return _RESETS[n]


def make_state(n: int, cw: bool, seed: int = 0) -> dict:
    """A numpy state tree: the port's reset with every observed input drawn
    from ``seed``."""
    tree = {k: (dict(v) if isinstance(v, dict) else v) for k, v in _reset(n).items()}
    cars, tr = tree["cars"], tree["track"]
    rng = np.random.RandomState(seed + 10 * n + int(cw))
    E = len(SEEDS)
    f32 = np.float32
    hull_c = np.zeros((E, n, 2))
    for e in range(E):
        T = int(tr["n_tiles"][e])
        tiles = rng.randint(0, T, n)
        if e == 0:
            tiles[0] = T - 2                  # waypoints past the last tile
        if e == 1 and n > 1:
            tiles[1] = 1                      # and before the first
        beta = tr["beta"][e, tiles]
        radial = np.stack([np.cos(beta), np.sin(beta)], -1)
        hull_c[e] = tr["xy"][e, tiles] + rng.uniform(-8, 8, (n, 1)) * radial \
            + rng.normal(0, 1.0, (n, 2))
    hull_a = rng.uniform(-4, 4, (E, n))
    cars.update(
        hull_c=hull_c.astype(f32), hull_a=hull_a.astype(f32),
        hull_v=rng.normal(0, 15, (E, n, 2)).astype(f32),
        hull_w=rng.normal(0, 1, (E, n)).astype(f32),
        wheel_a=(hull_a[..., None] + rng.uniform(-0.4, 0.4, (E, n, 4))).astype(f32),
        spin=rng.normal(0, 60, (E, n, 4)).astype(f32),
        steer=rng.uniform(-1, 1, (E, n, 4)).astype(f32),
        gas=rng.uniform(0, 1, (E, n, 4)).astype(f32),
        brake=rng.uniform(0, 1, (E, n, 4)).astype(f32),
    )
    tree["driving_on_grass"] = rng.rand(E, n) < 0.5
    tree["driving_backward"] = rng.rand(E, n) < 0.5
    tree["direction_cw"] = np.full((E,), cw)
    return tree


_JAX_OBS = jax.jit(jax.vmap(jobs.state_observation))


@jax.jit
def _jax_nearest(state):
    d2 = jnp.sum(jnp.square(state.cars.hull_origin[:, :, None, :]
                            - state.track.xy[:, None]), axis=-1)
    return jnp.argmin(jnp.where(state.track.valid[:, None], d2, jnp.inf), axis=2)


@pytest.mark.parametrize("n", [1, 2])
@pytest.mark.parametrize("cw", [False, True], ids=["ccw", "cw"])
def test_state_observation_matches_jax(n, cw):
    tree = make_state(n, cw)
    js = jax_state(tree)
    ps = convert.env_state_from_numpy(tree, device="cpu")
    ref = np.asarray(_JAX_OBS(js))
    got = pobs.state_observation(ps).numpy()
    assert got.shape == (len(SEEDS), n, pobs.STATE_OBS_DIM) == ref.shape
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_array_equal(nearest_tile(ps.track, ps.cars.hull_origin).numpy(),
                                  np.asarray(_jax_nearest(js)))
    err = np.abs(got - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() <= TOL, (np.unravel_index(err.argmax(), err.shape), err.max())


def test_lookahead_constants_match_jax():
    assert pobs.STATE_OBS_DIM == jobs.STATE_OBS_DIM
    assert pobs.LOOKAHEAD_OFFSETS == jobs.LOOKAHEAD_OFFSETS
