"""The port's track stage (physics/track_engine.py) against the JAX package's
three versions of it, on the CPU: the Pallas kernels ``track_pass_batched``
(v1) and ``track_pass_batched_v2`` (v2), both in interpret mode as the JAX
package's own tests run them, and the XLA path ``env._make_track_pass(n,
"xla", False)`` under ``vmap``.

Inputs are synthetic, made from a seed with numpy: 4 host tracks (seeds
0-3), cars at tile centres with jitter and random headings, hulls on the
road, on a curb and on the grass, post-solve origins moved by ~0.3 m, and
random ``visited`` / ``tile_touched`` masks that include tiles other cars
have visited. At N >= 2, env 0 has cars 0 and 1 on the same unvisited tiles
(the car-id tie-break) and env 1 has car 1 on tiles only car 0 visited.

Bars (tests/test_track_engine.py's): wheel_on_road, visited, tile_touched,
on_grass and count equal; nearest_beta equal; bonus within 2e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import env as jenv
from multi_car_racing_tpu.physics import state as jstate, track_engine as jte
from multi_car_racing_tpu.track import common as jcommon

from multi_car_racing_tpu_torch import config as C, convert, seeding
from multi_car_racing_tpu_torch.physics import shapes, track_engine
from multi_car_racing_tpu_torch.track import host
from multi_car_racing_tpu_torch.track.common import pack_track_arrays, track_from_arrays
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 1, 2, 3)
MT = 384
BONUS_TOL = 2e-5
NAMES = ("wheel_on_road", "visited", "bonus", "count", "tile_touched",
         "nearest_beta", "on_grass")
CAR_FIELDS = [f.name for f in dataclasses.fields(jstate.CarState)]


def _tracks():
    arrays = []
    for s in SEEDS:
        pts, border, _ = host.generate_track(seeding.np_random(s)[0])
        arrays.append(pack_track_arrays(pts, border, MT))
    return arrays


TRACKS = _tracks()


def _rot(a, v):
    c, s = np.cos(a), np.sin(a)
    return np.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


def make_case(n: int, seed: int = 0):
    """Synthetic pre-solve cars, post-solve origins and masks on TRACKS:
    (track arrays (E, ...), car arrays (E, N, ...), post_origin, visited,
    tile_touched), all numpy."""
    rng = np.random.RandomState(seed + 17 * n)
    tr = {k: np.stack([a[k] for a in TRACKS]) for k in TRACKS[0]}
    E = len(SEEDS)
    origin = np.zeros((E, n, 2))
    hull_a = rng.uniform(-np.pi, np.pi, (E, n))
    visited = (rng.rand(E, n, MT) < 0.3) & tr["valid"][:, None]
    touched = rng.rand(E, MT) < 0.2
    for e in range(E):
        T = int(tr["n_tiles"][e])
        tiles = rng.randint(0, T, n)
        if n >= 2 and e in (0, 1):
            tiles[1] = tiles[0]
            near = np.arange(tiles[0] - 4, tiles[0] + 5) % T
            visited[e, :, near] = False
            if e == 1:
                visited[e, 0, near] = True
                tiles[0] = (tiles[0] + T // 2) % T
        for car in range(n):
            i = tiles[car]
            kind = "road" if (n >= 2 and e in (0, 1)) else ("road", "curb", "grass")[(e + car) % 3]
            if kind == "curb" and tr["has_curb"][e, :T].any():
                i = rng.choice(np.flatnonzero(tr["has_curb"][e, :T]))
                origin[e, car] = tr["curb_quad"][e, i].mean(0)
            else:
                beta = tr["beta"][e, i]
                radial = np.array([np.cos(beta), np.sin(beta)])
                lateral = rng.uniform(-3, 3) if kind == "road" else C.TRACK_WIDTH + 12.0
                origin[e, car] = tr["xy"][e, i] + lateral * radial + rng.normal(0, 0.5, 2)
            if n >= 2 and e in (0, 1) and car < 2:
                hull_a[e, car] = tr["beta"][e, i] + rng.normal(0, 0.2)
    wheel_pos = np.asarray(shapes.WHEEL_POS, np.float64)           # (4, 2) local
    steer = rng.uniform(-0.4, 0.4, (E, n))
    wheel_a = hull_a[..., None] + np.stack([steer, steer, 0 * steer, 0 * steer], -1)
    wheel_c = origin[:, :, None] + _rot(hull_a[..., None], wheel_pos) + rng.normal(0, 0.02, (E, n, 4, 2))
    hull_c = origin + _rot(hull_a, np.asarray(shapes.HULL_LOCAL_CENTER, np.float64))
    cars = {f: np.zeros((E, n) + s, np.float32) for f, s in (
        ("hull_v", (2,)), ("hull_w", ()), ("wheel_v", (4, 2)), ("wheel_w", (4,)),
        ("joint_impulse", (4, 3)), ("motor_impulse", (4,)), ("gas", (4,)), ("brake", (4,)),
        ("steer", (4,)), ("spin", (4,)), ("phase", (4,)), ("fuel_spent", ()))}
    cars.update(hull_c=hull_c.astype(np.float32), hull_a=hull_a.astype(np.float32),
                wheel_c=wheel_c.astype(np.float32), wheel_a=wheel_a.astype(np.float32),
                limit_state=np.zeros((E, n, 4), np.int32))
    post = (origin + rng.normal(0, 0.3, origin.shape)).astype(np.float32)
    return tr, cars, post, visited, touched


def port_inputs(case, device="cpu"):
    tr, cars, post, visited, touched = case
    track = track_from_arrays([{k: v[e] for k, v in tr.items()} for e in range(len(SEEDS))],
                              device)
    return (track, convert.cars_from_numpy(cars, device), torch.from_numpy(post).to(device),
            torch.from_numpy(visited).to(device), torch.from_numpy(touched).to(device))


def jax_outputs(case, n: int):
    """{"v1", "v2", "xla"} -> the seven outputs as numpy."""
    tr, cars, post, visited, touched = case
    jtr = jcommon.Track(**{f.name: jnp.asarray(tr[f.name])
                           for f in dataclasses.fields(jcommon.Track)})
    jcars = jstate.CarState(**{f: jnp.asarray(cars[f]) for f in CAR_FIELDS})
    forw, side, origin = jax.jit(
        lambda c: jstate.wheel_forward_side(c) + (c.hull_origin,))(jcars)
    args = (jtr.quad_T, jtr.quad_ax_T, jtr.quad_lo, jtr.quad_hi, jtr.curb_quad_T, jtr.xy,
            jtr.beta, jtr.valid, jtr.n_tiles, jcars.wheel_c, forw, side, origin,
            jnp.asarray(post), jnp.asarray(visited), jnp.asarray(touched))
    xla = jax.jit(jax.vmap(jenv._make_track_pass(n, "xla", False)))(
        jtr, jcars, jnp.asarray(post), jnp.asarray(visited), jnp.asarray(touched))
    outs = {"v1": jte.track_pass_batched(*args, num_agents=n, interpret=True),
            "v2": jte.track_pass_batched_v2(*args, num_agents=n, interpret=True),
            "xla": xla}
    return {k: [np.asarray(x) for x in v] for k, v in outs.items()}


def assert_track_outputs_match(ref, got, label):
    """The bars: every mask, count and nearest_beta equal, bonus within 2e-5."""
    for name, r, g in zip(NAMES, ref, got):
        r, g = np.asarray(r), np.asarray(g)
        assert r.shape == g.shape and r.dtype == g.dtype, (label, name, r.dtype, g.dtype)
        if name == "bonus":
            np.testing.assert_allclose(g, r, rtol=0, atol=BONUS_TOL, err_msg=f"{label} {name}")
        else:
            np.testing.assert_array_equal(g, r, err_msg=f"{label} {name}")


@pytest.mark.parametrize("n", [1, 2, 4])
def test_track_pass_matches_jax_v1_v2_and_xla(n):
    case = make_case(n)
    track, cars, post, visited, touched = port_inputs(case)
    plain = [x.numpy() for x in track_engine.track_pass_plain(
        track, cars, post, visited, touched, n)]
    launches = track_engine.track_pass.launches
    wrapped = [x.numpy() for x in track_engine.track_pass(
        track, cars, post, visited, touched, n)]
    assert track_engine.track_pass.launches == launches      # CPU: the plain version
    for label, ref in jax_outputs(case, n).items():
        assert_track_outputs_match(ref, plain, f"plain vs JAX {label}")
        assert_track_outputs_match(ref, wrapped, f"track_pass (CPU) vs JAX {label}")

    won, new_vis, bonus, cnt, _, _, grass = plain
    assert won.any() and not won.all() and cnt.sum() > 0
    assert grass.any() and not grass.all()
    assert (new_vis & ~case[3]).sum() == cnt.sum()
    if n >= 2:
        tile_bonus = 1000.0 / case[0]["n_tiles"].astype(np.float64)
        # env 0: both cars newly on the same tiles; car 1 is the second visitor.
        assert cnt[0, 0] > 0 and cnt[0, 1] > 0
        assert abs(bonus[0, 0] - cnt[0, 0] * tile_bonus[0]) < 1e-3
        assert bonus[0, 1] < cnt[0, 1] * tile_bonus[0] - 1e-3
        # env 1: car 1 enters tiles car 0 already visited.
        assert cnt[1, 1] > 0 and bonus[1, 1] < cnt[1, 1] * tile_bonus[1] - 1e-3


def test_track_pass_work_counts():
    nbytes, flops = track_engine.track_pass_work(4096, 2, 384)
    per_env_tables = 384 * 35 * 4
    assert 4096 * per_env_tables < nbytes < 4096 * (per_env_tables + 384 * 8 + 1024)
    assert flops == 2 * 4096 * 384 * (4 * track_engine.FLOPS_WHEEL_TILE
                                      + track_engine.FLOPS_CAR_TILE)
    _, fewer = track_engine.track_pass_work(4096, 2, 384, valid_tiles=4096 * 300)
    assert fewer * 384 == flops * 300


def test_plain_counts_only_cuda_calls_and_wrapper_refuses_other_devices():
    case = make_case(1)
    args = port_inputs(case)
    before = track_engine.track_pass_plain.cuda_calls
    track_engine.track_pass_plain(*args, 1)
    assert track_engine.track_pass_plain.cuda_calls == before
    meta = [x.to("meta") if isinstance(x, torch.Tensor) else x for x in args[2:]]
    with pytest.raises(ValueError, match="unsupported device"):
        track_engine.track_pass(args[0], args[1], *meta, 1)
