"""The PyTorch port's car-car Collide pass and broadphase against the JAX
package's, and K2's constant tables against the port's own.

- ``collide``: the manifolds of every fixture pair at N = 2 and N = 4 on
  seeded random poses (cars packed within a few metres, so many pairs
  touch): ids and point_ok equal, normals, points and separations within
  5e-4 * max(1, max|jax|). tests/test_torch_contact_ram.py holds it to the
  same on the rear-end ram state.
- ``near_flags``: equal to the JAX package's ``pallas_world.near_flags`` at
  N = 2 and N = 4, including cars placed just inside and just outside the
  broadphase slack.
- K2's float and routing tables (``csrc/contact_island.cu``) hold the
  constants and rows the plain version uses, in the layout the kernel
  source declares."""

import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu.physics import (
    collide as jcollide, pallas_world, shapes as jshapes, state as jstate,
)

from multi_car_racing_tpu_torch import convert
from multi_car_racing_tpu_torch import config as PC
from multi_car_racing_tpu_torch.physics import collide as pcollide, fused_world, shapes

TOL = 5e-4
CSRC = Path(fused_world.__file__).parent.parent / "csrc"


def _np(t):
    return t.detach().cpu().numpy()


def _close(name, a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    scale = max(1.0, float(np.abs(a).max()))
    d = float(np.abs(a - b).max())
    assert d <= tol * scale, f"{name}: maxabs {d} (scale {scale})"


def _random_cars(n, num_envs, seed, spread=4.0):
    """JAX CarStates with ``n`` cars scattered within ``spread`` metres at
    random angles, wheels jittered about their anchors, and the port's copy."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-300, 300, (num_envs, 1, 2))
    pos = (base + rng.uniform(-spread, spread, (num_envs, n, 2))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (num_envs, n)).astype(np.float32)
    jc = jax.vmap(jstate.create_cars)(jnp.asarray(pos), jnp.asarray(ang))
    jc = jc.replace(
        wheel_c=jc.wheel_c + jnp.asarray(rng.uniform(-0.3, 0.3, jc.wheel_c.shape), jnp.float32),
        wheel_a=jc.wheel_a + jnp.asarray(rng.uniform(-0.4, 0.4, jc.wheel_a.shape), jnp.float32),
    )
    return jc, convert.cars_from_numpy(jax.device_get(jc), device="cpu")


def compare_manifolds(jc, pc, n):
    """JAX ``collide`` (vmapped) against the port's on the same cars; returns
    the number of rows with a live point."""
    jm = jax.vmap(lambda c: jcollide.collide(c, n))(jc)
    pm = pcollide.collide(pc, n)
    assert np.array_equal(np.asarray(jm.ids), _np(pm.ids)), "ids"
    assert np.array_equal(np.asarray(jm.point_ok), _np(pm.point_ok)), "point_ok"
    live = np.asarray(jm.point_ok)
    _close("normal", jm.normal, _np(pm.normal))
    # Points and separations are read only where a point is live.
    _close("point", np.where(live[..., None], jm.point, 0.0),
           np.where(live[..., None], _np(pm.point), 0.0))
    _close("separation", np.where(live, jm.separation, 0.0),
           np.where(live, _np(pm.separation), 0.0))
    return int(live.any(-1).sum())


@pytest.mark.parametrize("n", [2, 4])
def test_collide_matches_jax_on_random_poses(n):
    jc, pc = _random_cars(n, 6, seed=10 + n)
    live_rows = compare_manifolds(jc, pc, n)
    assert live_rows >= 10, f"setup: only {live_rows} rows in contact"


def _place_pair(jc, gap, sign=1.0):
    """Rigid-translate car 1 of every env so its world hull AABB sits ``gap``
    metres beyond car 0's along world y, x centres aligned (the placement of
    tests/test_pallas_world.py's _place_car_y)."""
    mid, half = np.asarray(fused_world.HULL_AABB_MID), np.asarray(fused_world.HULL_AABB_HALF)
    a = np.asarray(jc.hull_a)
    c, s = np.cos(a), np.sin(a)
    cx = np.asarray(jc.hull_c[..., 0]) + c * mid[0] - s * mid[1]
    cy = np.asarray(jc.hull_c[..., 1]) + s * mid[0] + c * mid[1]
    hy = np.abs(s) * half[0] + np.abs(c) * half[1]
    delta = np.stack([cx[:, 0] - cx[:, 1],
                      cy[:, 0] + sign * (hy[:, 0] + hy[:, 1] + gap) - cy[:, 1]], -1)
    delta = jnp.asarray(delta, jnp.float32)
    return jc.replace(hull_c=jc.hull_c.at[:, 1].add(delta),
                      wheel_c=jc.wheel_c.at[:, 1].add(delta[:, None, :]))


@pytest.mark.parametrize("n", [2, 4])
def test_near_flags_match_jax(n):
    # Scattered cars (wheels jittered off their anchors): both verdicts occur.
    jc, _ = _random_cars(n, 16, seed=20 + n, spread=8.0)
    flags = np.asarray(pallas_world.near_flags(jc, n))
    pc = convert.cars_from_numpy(jax.device_get(jc), device="cpu")
    assert np.array_equal(flags, _np(fused_world.near_flags(pc)))
    assert flags.any() and not flags.all()

    # Axis-aligned cars (wheels inside the hull box in y), car 1 stacked on
    # car 0 at AABB gaps just inside and just outside the 0.1 m slack, the
    # other cars far away.
    rng = np.random.RandomState(n)
    pos = np.zeros((8, n, 2), np.float32)
    pos[:, 0] = rng.uniform(-300, 300, (8, 2))
    pos[:, 1:] = 1000.0 + 300.0 * np.arange(1, n)[None, :, None]
    ang = (np.pi * rng.randint(0, 2, (8, n))).astype(np.float32)
    base = jax.vmap(jstate.create_cars)(jnp.asarray(pos), jnp.asarray(ang))
    for gap, near in ((0.095, True), (0.105, False)):
        for sign in (1.0, -1.0):
            jcar = _place_pair(base, gap, sign)
            pc = convert.cars_from_numpy(jax.device_get(jcar), device="cpu")
            want = np.asarray(pallas_world.near_flags(jcar, n))
            got = _np(fused_world.near_flags(pc))
            assert np.array_equal(want, got), (gap, sign)
            assert bool(got.all()) if near else not got.any(), (gap, sign)


def test_near_flags_constants_match_jax():
    assert fused_world.HULL_AABB_MID == pytest.approx(pallas_world._HULL_AABB_MID, abs=0)
    assert fused_world.HULL_AABB_HALF == pytest.approx(pallas_world._HULL_AABB_HALF, abs=0)
    assert fused_world.WHEEL_AABB_HALF == pytest.approx(pallas_world._WHEEL_AABB_HALF, abs=0)
    assert fused_world.BP_SLACK == pallas_world._BP_SLACK == 0.1


@pytest.mark.parametrize("n", [2, 3, 4])
def test_routing_tables_match_jax(n):
    jt, pt = jcollide.tables(n), pcollide.tables(n)
    assert jt[0] == pt[0]                                    # car pairs
    assert np.array_equal(jt[1], pt[1]) and np.array_equal(jt[2], pt[2])   # body rows
    assert np.array_equal(jt[5], pt[3]) and np.array_equal(jt[6], pt[4])   # inv mass / inertia
    assert np.array_equal(jt[7], pt[5]) and np.array_equal(jt[8], pt[6])   # fixtures
    assert pcollide.FIXTURE_PAIRS == jcollide.FIXTURE_PAIRS
    cs = pcollide.init_contact_state(3, n)
    jcs = jcollide.init_contact_state(n)
    assert tuple(cs.ids.shape) == (3,) + tuple(jcs.ids.shape)
    assert bool((cs.ids == -1).all()) and not bool(cs.normal_imp.any())


@pytest.mark.parametrize("n", [2, 4])
def test_kernel_index_table_matches_the_rows(n):
    """K2's int table: the same fixture and body rows as the plain version,
    and for each body exactly its rows (each row once per side), ascending."""
    _, rows_a, rows_b, _, _, fix_a, fix_b = pcollide.tables(n)
    mm, nb = len(rows_a), 5 * n
    t = fused_world.contact_index_table(n)
    assert t.dtype == np.int32 and len(t) == 4 * mm + nb + 1 + 2 * mm
    assert np.array_equal(t[:mm], fix_a) and np.array_equal(t[mm:2 * mm], fix_b)
    assert np.array_equal(t[2 * mm:3 * mm], rows_a) and np.array_equal(t[3 * mm:4 * mm], rows_b)
    off = t[4 * mm:4 * mm + nb + 1]
    ent = t[4 * mm + nb + 1:]
    assert off[0] == 0 and off[-1] == 2 * mm
    for b in range(nb):
        mine = ent[off[b]:off[b + 1]]
        assert np.all(np.diff(mine) > 0)
        want = sorted([2 * r for r in np.nonzero(rows_a == b)[0]]
                      + [2 * r + 1 for r in np.nonzero(rows_b == b)[0]])
        assert list(mine) == want, b
    # Pair q's first row names its two cars' hulls (the kernel's broadphase reads it).
    for q, (a, b) in enumerate(pcollide.car_pairs(n)):
        assert t[2 * mm + q * 48] == 5 * a and t[3 * mm + q * 48] == 5 * b


def test_kernel_float_table_matches_the_constants():
    v = fused_world.contact_param_values()
    names = fused_world.CPARAM_NAMES
    assert v.dtype == np.float32 and len(v) == len(names) + 2 * 128
    k = dict(zip(names, v[:len(names)].tolist()))
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    assert k["FRICTION"] == f32(PC.HULL_FRICTION)
    assert k["TOTAL_RADIUS"] == f32(2 * PC.B2_POLYGON_RADIUS)
    assert k["FLIP_BIAS"] == f32(0.1 * PC.B2_LINEAR_SLOP)
    assert k["BAUMGARTE"] == f32(PC.B2_BAUMGARTE)
    assert k["MAX_LIN_CORR"] == f32(PC.B2_MAX_LINEAR_CORRECTION)
    assert k["LINEAR_SLOP"] == f32(PC.B2_LINEAR_SLOP)
    assert (k["LC_X"], k["LC_Y"]) == tuple(f32(x) for x in jshapes.HULL_LOCAL_CENTER)
    assert k["INV_M_HULL"] == f32(jshapes.HULL_INV_MASS)
    assert k["INV_I_WHEEL"] == f32(jshapes.WHEEL_INV_I)
    assert k["BP_SLACK"] == f32(pallas_world._BP_SLACK)
    assert (k["HULL_MID_X"], k["HULL_HALF_Y"], k["WHEEL_HALF_X"]) == (
        f32(pallas_world._HULL_AABB_MID[0]), f32(pallas_world._HULL_AABB_HALF[1]),
        f32(pallas_world._WHEEL_AABB_HALF[0]))
    verts = v[len(names):len(names) + 128].reshape(8, 8, 2)
    normals = v[len(names) + 128:].reshape(8, 8, 2)
    assert np.array_equal(verts, jshapes.CAR_FIXTURE_VERTS.astype(np.float32))
    assert np.array_equal(normals, jshapes.CAR_FIXTURE_NORMALS.astype(np.float32))
    assert np.array_equal(shapes.CAR_FIXTURE_VERTS, jshapes.CAR_FIXTURE_VERTS)


def test_kernel_source_declares_the_tables_layout():
    """The enums and row offsets in csrc/contact_island.cu and the headers it
    includes are the ones the wrapper packs."""
    src = "".join((CSRC / f).read_text() for f in ("car_chain.cuh", "contact_rows.cuh",
                                                   "contact_island.cu"))
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for k, v in {**fused_world.IN_ROWS, **fused_world.OUT_ROWS}.items():
        assert consts[k] == v, k

    def enum(name):
        body = re.search(r"enum %s \{(.*?)\};" % name, src, re.S).group(1)
        return [n.strip() for n in body.replace("\n", " ").split(",") if n.strip()]

    names = enum("Param")
    assert names[-1] == "N_PARAMS" and [n[2:] for n in names[:-1]] == list(fused_world.PARAM_NAMES)
    cnames = enum("CParam")
    assert cnames[-1] == "N_CPARAMS"
    assert [n[2:] for n in cnames[:-1]] == list(fused_world.CPARAM_NAMES)
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    assert "atomicAdd" not in code                      # fixed-order sums
    assert "copysign" not in code                       # sign(0) == 0
    assert "__sinf" not in code and "__cosf" not in code and "__fdividef" not in code


def test_island_step_on_cpu_at_two_cars_is_the_plain_version():
    jc, pc = _random_cars(2, 3, seed=5, spread=3.0)
    on_road = torch.ones((3, 2, 4), dtype=torch.bool)
    cs = pcollide.init_contact_state(3, 2)
    before = (fused_world.island_step.launches, fused_world.island_step.contact_launches)
    a = fused_world.island_step(pc, on_road, cs, 6, 3)
    b = fused_world.island_step_plain(pc, on_road, cs, 6, 3)
    assert (fused_world.island_step.launches, fused_world.island_step.contact_launches) == before
    for f in ("hull_c", "wheel_v", "joint_impulse"):
        assert torch.equal(getattr(a[0], f), getattr(b[0], f)), f
    assert torch.equal(a[2].normal_imp, b[2].normal_imp) and torch.equal(a[2].ids, b[2].ids)
    assert bool((a[2].ids >= 0).any()), "setup: no contact"


def test_contact_island_counts_grow_with_the_work():
    """K2's operation count adds to K1's what near envs, live rows, live
    points and the bodies those touch need, and nothing for far envs."""
    base = fused_world.contact_island_flops(8192, 0, 2, 0, 0, 0, 0)
    assert base > fused_world.island_flops(8192, 0)
    near = fused_world.contact_island_flops(8192, 0, 2, 100, 0, 0, 0)
    rows = fused_world.contact_island_flops(8192, 0, 2, 100, 50, 0, 0)
    points = fused_world.contact_island_flops(8192, 0, 2, 100, 50, 60, 0)
    bodies = fused_world.contact_island_flops(8192, 0, 2, 100, 50, 60, 40)
    assert base < near < rows < points < bodies
    # A body touched in one sub-pass: one warm start, 2 per velocity
    # iteration and 1 per position iteration of the contact solve.
    assert bodies - points == 40 * fused_world.FLOPS_BODY_UPDATE * (1 + 2 * 180 + 60)
    assert fused_world.contact_island_bytes(8192, 2) == (
        fused_world.island_bytes(8192) + 4096 * 48 * 4 * 5 * 2)


@pytest.mark.parametrize("n", [2, 4])
def test_contact_island_work_counts_this_input(n):
    """The data-dependent counts behind K2's bound, against JAX's manifolds
    and routing tables: live rows and points only in near envs, and the
    bodies each point index's live points touch."""
    # 6 envs of packed cars and 2 of cars hundreds of metres apart.
    jc = jax.tree_util.tree_map(lambda a, b: jnp.concatenate([a, b]),
                                _random_cars(n, 6, seed=30 + n)[0],
                                _random_cars(n, 2, seed=40 + n, spread=200.0)[0])
    pc = convert.cars_from_numpy(jax.device_get(jc), device="cpu")
    work = fused_world.contact_island_work(pc)
    near = np.asarray(pallas_world.near_flags(jc, n))
    ok = np.asarray(jax.vmap(lambda c: jcollide.collide(c, n))(jc).point_ok) & near[:, None, None]
    _, rows_a, rows_b, *_ = jcollide.tables(n)
    touched = sum(len({int(b) for r in np.flatnonzero(ok[e, :, k])
                       for b in (rows_a[r], rows_b[r])})
                  for e in range(ok.shape[0]) for k in range(2))
    assert work == dict(n_near_envs=int(near.sum()), n_live_rows=int(ok.any(-1).sum()),
                        n_live_points=int(ok.sum()), n_touched_bodies=touched)
    assert work["n_live_points"] > 0 and 0 < work["n_near_envs"] <= 6, "setup"
    assert not near[6:].any(), "setup"
    assert work["n_live_rows"] <= work["n_live_points"] <= 2 * work["n_live_rows"]
