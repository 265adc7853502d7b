"""The port's render-only parts on the CPU: the viewport painter
``render.raster.render_observation``, the skid trails
(``render.particles``) and the exact hull touch
(``physics.overlap.car_fixture_world_geometry`` / ``fixtures_vs_quads``,
``EnvConfig.exact_hull_touch``).

- The painter is byte-equal to the golden fixtures the JAX package's
  painters produced: the 600x400 ``rgb_array_skid`` frame with particles and
  the five 96x96 frames, states rebuilt from their stored leaves
  (``test_torch_render.golden``; no JAX compile). At 96x96 it also equals
  the port's K6 plain painter ``pixels.paint_views_plain`` byte for byte.
  The golden's 48 skid segments lie under the cars, so the trail pass is
  held on its own: segments moved into view, every pixel of the pass equal
  to a numpy float32 version of the JAX expression (``raster.py:252-285``)
  evaluated on every pixel against every segment.
- ``particles.update`` equals JAX's eager ``particles.update``, every
  field bit for bit, over a seeded 40-step sequence of wheel positions,
  skid flags and on-road masks whose rings wrap.
- The fixture SAT equals JAX's on seeded poses whose hull bumpers graze a
  tile's side edge at 5, 15, 25 and 100 mm (the sensor margin is 20 mm):
  world geometry within 1e-6 * max(1, |x|), overlap flags equal; then
  ``env.step`` with ``exact_hull_touch`` gives JAX's touched flags
  (``env._contact_pass(state, True)``) on the same poses, while the hull
  centre test alone misses some. The port ORs the fixture SAT into K4/K5's
  centre-based flag; that equals JAX's flag because the centre test is a
  subset of the fixture test, held on 4,000 seeded poses.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import env as jenv
from multi_car_racing_tpu.physics import overlap as joverlap
from multi_car_racing_tpu.render import particles as jparticles

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv
from multi_car_racing_tpu_torch.physics import overlap as poverlap, shapes
from multi_car_racing_tpu_torch.physics.state import create_cars
from multi_car_racing_tpu_torch.render import geometry as PG, particles, pixels, raster
from test_torch_obs import jax_state
from test_torch_render import GOLDENS, golden
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

TOL = 1e-6


def _state(name):
    kw, leaves, frame = golden(name)
    return EnvConfig(**kw), convert.env_state_from_leaves(leaves, device="cpu"), frame


def test_rgb_array_frame_is_byte_equal_to_the_golden():
    cfg, st, frame = _state("rgb_array_skid")
    assert cfg.track_skid and int(st.skid.valid.sum()) > 0
    img = raster.render_observation(cfg, st, 600, 400, draw_particles=True)
    assert img.dtype == torch.uint8 and img.shape == (1, 2, 400, 600, 3)
    bad = (img[0].numpy() != frame).any(-1)
    assert not bad.any(), (int(bad.sum()), np.argwhere(bad)[:8].tolist())


@pytest.mark.parametrize("name", GOLDENS)
def test_96x96_frames_are_byte_equal_to_the_goldens_and_k6_plain(name):
    cfg, st, frame = _state(name)
    img = raster.render_observation(cfg, st).numpy()
    assert np.array_equal(img[0], frame)
    assert np.array_equal(img, pixels.paint_views_plain(*pixels.paint_inputs(cfg, st)).numpy())


def _moved_skid(st, dx: float, dy: float):
    """The golden state with each car's stored segments moved, as one
    piece, next to that car: their mean point to the car's hull origin +
    (dx, dy) metres; every other segment flagged as on grass (mud)."""
    sk = st.skid
    seg = sk.seg.clone()
    for k in range(seg.shape[1]):
        ok = sk.valid[0, k]
        mean = seg[0, k, ok].reshape(-1, 2, 2).mean(dim=(0, 1))
        to = st.cars.hull_origin[0, k] + torch.tensor([dx, dy])
        seg[0, k] = seg[0, k] + (to - mean).repeat(2)
    grass = torch.zeros_like(sk.grass)
    grass[..., ::2] = True
    return st.replace(skid=dataclasses.replace(sk, seg=seg, grass=grass & sk.valid))


def _trail_reference(cfg, st, vp_w, vp_h):
    """(black, mud) coverage (N, vp_h, vp_w) of the JAX trail pass in numpy
    float32, one rounding per operation, every pixel against every valid
    segment."""
    f = np.float32
    zoom, ang, trans = (x.numpy() for x in PG.camera(cfg, st))
    col = (np.arange(vp_w, dtype=f) + f(0.5)) * f(1000 / vp_w)
    row = (f(vp_h - 0.5) - np.arange(vp_h, dtype=f)) * f(800 / vp_h)
    px = np.broadcast_to(col[None, :], (vp_h, vp_w)).reshape(-1)
    py = np.broadcast_to(row[:, None], (vp_h, vp_w)).reshape(-1)
    seg = st.skid.seg[0].reshape(-1, 4).numpy()
    valid = st.skid.valid[0].reshape(-1).numpy()
    grass = st.skid.grass[0].reshape(-1).numpy()[valid]
    seg = seg[valid]
    hw = f(max(1.0, 0.6 * 1000 / vp_w))
    out = []
    for v in range(cfg.num_agents):
        # world_to_window with the torch cos/sin of the view angle.
        ca = np.float32(torch.cos(torch.tensor(ang[0, v])).item())
        sa = np.float32(torch.sin(torch.tensor(ang[0, v])).item())
        z = zoom[0]

        def win(p):
            x, y = p[:, 0] * z, p[:, 1] * z
            return trans[0, v, 0] + ca * x - sa * y, trans[0, v, 1] + sa * x + ca * y

        ax, ay = win(seg[:, 0:2])
        bx, by = win(seg[:, 2:4])
        dx, dy = (bx - ax)[:, None], (by - ay)[:, None]
        len2 = dx * dx + dy * dy
        t = np.clip(((px[None] - ax[:, None]) * dx + (py[None] - ay[:, None]) * dy)
                    / np.maximum(len2, f(1e-9)), f(0), f(1))
        cx, cy = ax[:, None] + t * dx, ay[:, None] + t * dy
        d2 = (px[None] - cx) ** 2 + (py[None] - cy) ** 2
        cov = d2 <= hw * hw
        out.append(((cov & ~grass[:, None]).any(0).reshape(vp_h, vp_w),
                    (cov & grass[:, None]).any(0).reshape(vp_h, vp_w)))
    return out


@pytest.mark.parametrize("vp", [(600, 400), (96, 96)])
def test_trail_pass_matches_a_per_pixel_reference(vp, monkeypatch):
    # Four segments per chunk of a band, so a band's segments span chunks.
    monkeypatch.setattr(raster, "BAND_ELEMENTS", 4 * vp[0] * raster.BAND_ROWS)
    cfg, st, _ = _state("rgb_array_skid")
    st = _moved_skid(st, 6.0, -4.0)
    zoom, ang, trans = PG.camera(cfg, st)
    ref = _trail_reference(cfg, st, *vp)
    wx, wy = raster.pixel_window_coords(*vp)
    drawn = 0
    for v in range(cfg.num_agents):
        plane = raster._Plane(torch.zeros(vp[::-1], dtype=torch.int32), wx, wy, None, None)
        seg = st.skid.seg[0].reshape(-1, 4)
        sel = torch.nonzero(st.skid.valid[0].reshape(-1)).flatten()

        def to_win(p):
            return PG.world_to_window(p, zoom[0], ang[0, v], trans[0, v])

        raster._paint_skid(plane, to_win(seg[sel, 0:2]), to_win(seg[sel, 2:4]),
                           st.skid.grass[0].reshape(-1)[sel], max(1.0, 0.6 * 1000 / vp[0]))
        black, mud = ref[v]
        want = np.where(mud, raster.PAL_MUD, np.where(black, raster.PAL_BLACK, 0))
        assert np.array_equal(plane.idx.numpy(), want), (v, int((plane.idx.numpy() != want).sum()))
        drawn += int(black.sum()) + int(mud.sum())
    assert drawn > 0
    # In the whole frame the moved trails show, in their two colours only.
    img = raster.render_observation(cfg, st, *vp, draw_particles=True)[0].numpy()
    plain = raster.render_observation(cfg, st, *vp)[0].numpy()
    changed = (img != plain).any(-1)
    assert changed.any()
    colours = {tuple(c) for c in img[changed].tolist()}
    assert colours <= {tuple(raster.PALETTE_U8[raster.PAL_BLACK]),
                       tuple(raster.PALETTE_U8[raster.PAL_MUD])}, colours


def test_particles_update_matches_jax():
    E, N, K = 3, 2, particles.MAX_SEGMENTS
    rng = np.random.default_rng(40)
    st = particles.init(E, N, device="cpu")
    # Start near the end of the ring so that the 40 steps wrap it.
    st = dataclasses.replace(st, head=torch.tensor(rng.integers(K - 30, K, (E, N)),
                                                   dtype=torch.int32))
    jst = [jparticles.SkidState(**{f.name: jnp.asarray(getattr(st, f.name)[e].numpy())
                                   for f in dataclasses.fields(st)}) for e in range(E)]
    wrapped = False
    for _ in range(40):
        pos = rng.normal(0.0, 50.0, (E, N, 4, 2)).astype(np.float32)
        skid = rng.random((E, N, 4)) < 0.6
        road = rng.random((E, N, 4)) < 0.5
        before = st.head.clone()
        st = particles.update(st, torch.from_numpy(pos), torch.from_numpy(skid),
                              torch.from_numpy(road))
        wrapped |= bool((st.head < before).any())
        jst = [jparticles.update(j, jnp.asarray(pos[e]), jnp.asarray(skid[e]),
                                 jnp.asarray(road[e])) for e, j in enumerate(jst)]
        for f in dataclasses.fields(st):
            got = getattr(st, f.name).numpy()
            want = np.stack([np.asarray(getattr(j, f.name)) for j in jst])
            assert got.dtype == want.dtype and np.array_equal(got, want), f.name
    assert wrapped and int(st.valid.sum()) > 0


def test_segments_window_and_coverage_match_jax():
    rng = np.random.default_rng(3)
    N, K = 2, particles.MAX_SEGMENTS
    seg = rng.normal(0.0, 30.0, (1, N, K, 4)).astype(np.float32)
    grass = rng.random((1, N, K)) < 0.5
    valid = rng.random((1, N, K)) < 0.3
    st = dataclasses.replace(particles.init(1, N, device="cpu"), seg=torch.from_numpy(seg),
                             grass=torch.from_numpy(grass), valid=torch.from_numpy(valid))
    jst = jparticles.init(N)
    jst = jst.replace(seg=jnp.asarray(seg[0]), grass=jnp.asarray(grass[0]),
                      valid=jnp.asarray(valid[0]))

    def to_win(p):                 # any window transform; the same in both
        return p * 2.5 + 300.0

    got = particles.segments_window(st, to_win)
    want = jparticles.segments_window(jst, to_win)
    for g, w in zip(got, want):
        assert np.array_equal(g[0].numpy(), np.asarray(w))
    segs = got[0][0, :64]
    px = torch.from_numpy(rng.uniform(200.0, 400.0, 4096).astype(np.float32))
    py = torch.from_numpy(rng.uniform(200.0, 400.0, 4096).astype(np.float32))
    cov = particles.coverage(segs, px, py, half_width=3.0)
    jcov = jparticles.coverage(jnp.asarray(segs.numpy()), jnp.asarray(px.numpy()),
                               jnp.asarray(py.numpy()), half_width=3.0)
    assert np.array_equal(cov.numpy(), np.asarray(jcov)) and bool(cov.any())


def _grazing_state(seed: int, envs: int = 2, cars: int = 3):
    """Host-track envs whose cars each point their front bumper at the side
    edge of a random tile from outside, the bumper's nearest corner at 5,
    15, 25 or 100 mm from the edge's midpoint, headings jittered by up to
    0.5 rad; wheels placed on the rotated hull (zero velocities, fresh
    masks). Returns (cfg, state, target tiles (E, N), gaps (E, N))."""
    cfg = EnvConfig(num_agents=cars, use_random_direction=False, velocity_iters=4,
                    position_iters=2, exact_hull_touch=True)
    st = penv.reset_batch(cfg, range(seed, seed + envs), envs, device="cpu")
    rng = np.random.default_rng(seed)
    quad = st.track.quad.numpy().astype(np.float64)
    hull = np.concatenate([shapes.CAR_FIXTURE_VERTS[:4].reshape(-1, 2)])
    pos = np.zeros((envs, cars, 2))
    ang = np.zeros((envs, cars))
    gaps = np.array([0.005, 0.015, 0.025, 0.1])
    target = np.zeros((envs, cars), np.int64)
    gap = np.zeros((envs, cars))
    for e in range(envs):
        n = int(st.track.n_tiles[e])
        for k in range(cars):
            t = rng.integers(0, n)
            a, b = quad[e, t, 1], quad[e, t, 2]            # the right side edge
            mid = (a + b) / 2
            u = (b - a) / np.linalg.norm(b - a)
            nrm = np.array([u[1], -u[0]])
            if np.dot(nrm, mid - quad[e, t].mean(0)) < 0:
                nrm = -nrm                                  # outward
            fwd = -nrm
            th = np.arctan2(-fwd[0], fwd[1]) + rng.uniform(-0.5, 0.5)
            c, s = np.cos(th), np.sin(th)
            world = hull @ np.array([[c, s], [-s, c]])      # R v
            near = world[np.argmin(world @ nrm)]            # the corner nearest the edge
            gap[e, k] = gaps[(e * cars + k) % 4]
            pos[e, k] = mid + nrm * (gap[e, k] - near @ nrm) - u * (near @ u)
            ang[e, k] = th
            target[e, k] = t
    cars_ = create_cars(torch.tensor(pos, dtype=torch.float32),
                        torch.tensor(ang, dtype=torch.float32))
    a = cars_.hull_a[..., None, None]
    wp = torch.as_tensor(shapes.WHEEL_POS, dtype=torch.float32)
    rot = torch.stack([torch.cos(a) * wp[:, 0] - torch.sin(a) * wp[:, 1],
                       torch.sin(a) * wp[:, 0] + torch.cos(a) * wp[:, 1]], dim=-1)[..., 0, :, :]
    cars_ = cars_.replace(wheel_c=cars_.hull_origin[:, :, None, :] + rot,
                          wheel_a=cars_.hull_a[..., None].expand(-1, -1, 4).contiguous())
    st = st.replace(cars=cars_, tile_touched=torch.zeros_like(st.tile_touched),
                    visited=torch.zeros_like(st.visited),
                    wheel_on_road=torch.zeros_like(st.wheel_on_road))
    return cfg, st, target, gap


@pytest.fixture(scope="module")
def grazing():
    cfg, st, target, gap = _grazing_state(11)
    js = jax_state(convert.env_state_to_numpy(st))
    return cfg, st, js, target, gap


def test_fixture_sat_matches_jax(grazing):
    cfg, st, js, target, gap = grazing
    jv, jn = jax.jit(jax.vmap(joverlap.car_fixture_world_geometry))(js.cars)
    pv, pn = poverlap.car_fixture_world_geometry(st.cars)
    for name, ref, got in (("verts", jv, pv), ("normals", jn, pn)):
        ref = np.asarray(ref, np.float64)
        err = np.abs(ref - got.numpy()) / np.maximum(1.0, np.abs(ref))
        assert err.max() <= TOL, (name, float(err.max()))
    jov = np.asarray(jax.jit(jax.vmap(joverlap.fixtures_vs_quads))(jv, jn, js.track.quad))
    pov = poverlap.fixtures_vs_quads(pv, pn, st.track.quad).numpy()
    assert pov.shape == jov.shape and np.array_equal(pov, jov)
    # The target tile is touched by a hull fixture exactly when the gap is
    # under the 20 mm sensor margin.
    e, k = np.indices(target.shape)
    hull_touch = pov[:, :, 0:4].any(2)[e, k, target]
    assert np.array_equal(hull_touch, gap < 0.02), (hull_touch, gap)


def test_exact_hull_touch_step_gives_jax_touched_flags(grazing):
    cfg, st, js, _, _ = grazing
    want = np.asarray(jax.jit(jax.vmap(lambda s: jenv._contact_pass(s, True)[2]))(js))
    centre = np.asarray(jax.jit(jax.vmap(lambda s: jenv._contact_pass(s, False)[2]))(js))
    out, _, _ = penv.step(cfg, st, torch.zeros((st.t.shape[0], cfg.num_agents, 3)))
    assert np.array_equal(out.tile_touched.numpy(), want)
    assert (want & ~centre).any(), "no pose where the hull grazes a tile its centre misses"
    plain, _, _ = penv.step(dataclasses.replace(cfg, exact_hull_touch=False), st,
                            torch.zeros((st.t.shape[0], cfg.num_agents, 3)))
    assert np.array_equal(plain.tile_touched.numpy(), centre)


def test_hull_centre_touch_is_a_subset_of_the_fixture_touch():
    """The centre test (K4/K5's) implies the fixture test, so ORing the
    fixture SAT into K4/K5's flag equals JAX's ``car_tile | hull_ov``:
    4,000 hull poses with the origin within 4 m of a tile's corner, each
    tested against the 7 tiles around that one."""
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    st = penv.reset_batch(cfg, (0, 1, 2, 3), 4, device="cpu")
    rng = np.random.default_rng(7)
    E, n_pose = 4, 1000
    env = np.repeat(np.arange(E), n_pose)
    n_tiles = st.track.n_tiles.numpy()[env]
    tile = rng.integers(0, n_tiles)
    quad = st.track.quad.numpy()
    near = (tile[:, None] + np.arange(-3, 4)[None]) % n_tiles[:, None]     # (P, 7)
    quads = torch.from_numpy(quad[env[:, None], near])                      # (P, 7, 4, 2)
    corner = quad[env, tile, rng.integers(0, 4, env.size)]
    pos = corner + rng.uniform(-4.0, 4.0, (env.size, 2))
    ang = rng.uniform(-np.pi, np.pi, env.size)
    cars = create_cars(torch.tensor(pos[:, None], dtype=torch.float32),
                       torch.tensor(ang[:, None], dtype=torch.float32))
    centre = poverlap.point_in_quads_T(cars.hull_origin, quads.permute(0, 2, 3, 1))  # (P, 1, 7)
    verts, normals = poverlap.car_fixture_world_geometry(cars)
    fixt = poverlap.fixtures_vs_quads(verts[:, :, 0:4], normals[:, :, 0:4], quads).any(2)
    assert int(centre.sum()) > 500
    assert not (centre & ~fixt).any()
