"""The PyTorch port's physics modules against the JAX package's, one module at
a time, from identical states: tire model, joint solver, world step, and the
fused island (plain version) against the JAX joints-only Pallas kernel run in
interpret mode.

States come from the JAX package (4 CarRacing-v0 envs after 12 driven steps,
some joints at their limits) and cross to the port as numpy. Bar: every
field within 5e-4 * max(1, max|jax|) — the bar tests/test_pallas_world.py
holds the TPU kernel to against XLA — and integer/bool outputs equal."""

import re
from functools import partial
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
from multi_car_racing_tpu.physics import (
    joints as jjoints, pallas_world, shapes as jshapes, state as jstate, tire as jtire,
    world as jworld,
)
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import _cuda, convert
from multi_car_racing_tpu_torch.physics import (
    collide as pcollide, fused_world, joints as pjoints, state as pstate, tire as ptire,
    world as pworld,
)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = (0, 3, 5, 8)
TOL = 5e-4
CAR_FIELDS = ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a",
              "wheel_v", "wheel_w", "joint_impulse", "motor_impulse", "spin",
              "phase", "fuel_spent", "gas", "brake", "steer")
# Per-env (steer, gas, brake): hard left/right lock the steering joints at
# their limits; one env brakes part-way.
DRIVE = np.asarray([[[1.0, 0.8, 0.0]], [[-1.0, 0.5, 0.0]],
                    [[0.3, 1.0, 0.0]], [[-0.6, 0.4, 0.5]]], np.float32)
ACTION = np.asarray([[[0.7, 0.6, 0.0]], [[-0.2, 0.0, 0.3]],
                     [[-1.0, 1.0, 0.0]], [[0.0, 0.2, 0.95]]], np.float32)


def _assert_close(name, a, b, tol=TOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (name, a.shape, b.shape)
    if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
        assert np.array_equal(a, b), name
        return
    scale = max(1.0, float(np.abs(a).max()))
    d = float(np.abs(a - b).max())
    assert d <= tol * scale, f"{name}: maxabs {d} (scale {scale})"


def _np(t):
    return t.detach().cpu().numpy()


@pytest.fixture(scope="module")
def states():
    """(JAX pre-control CarState batch, wheel_on_road, port equivalents)."""
    cfg = JC.EnvConfig(num_agents=1, use_random_direction=False,
                       backwards_flag=False, solver="xla")
    tracks = []
    for s in SEEDS:
        pts, border, _ = jhost.generate_track(jseed.np_random(s)[0])
        tracks.append(jenv.pack_track(pts, border, max_tiles=cfg.max_tiles))
    stack = jax.tree_util.tree_map(lambda *l: jnp.stack(l), *tracks)
    st = jax.jit(jax.vmap(partial(jenv.reset_from_parts, cfg)))(
        stack, jnp.zeros((len(SEEDS), 1), jnp.int32), jnp.zeros((len(SEEDS),), bool)
    )
    step = jax.jit(jax.vmap(partial(jenv.step, cfg)))
    for _ in range(12):
        st, _, _ = step(st, jnp.asarray(DRIVE))
    jcars = jax.vmap(jstate.apply_controls)(st.cars, jnp.asarray(ACTION))
    host = jax.device_get(jcars)
    pcars = convert.cars_from_numpy(host, device="cpu")
    on_road = np.asarray(st.wheel_on_road)
    return jcars, st.wheel_on_road, pcars, torch.from_numpy(on_road.copy())


def test_fixture_exercises_limits_and_grass(states):
    jcars, on_road, _, _ = states
    _, jd = jax.vmap(jjoints.init_constraints)(
        jcars, jnp.zeros_like(jcars.wheel_w))
    ls = np.asarray(jd.limit_state)
    assert (ls == 1).any() and (ls == 2).any() and (ls == 0).any()
    assert np.asarray(on_road).any()


def test_apply_controls_matches():
    rng = np.random.RandomState(3)
    cars = jax.vmap(lambda p, a: jstate.create_cars(p, a))(
        jnp.asarray(rng.uniform(-50, 50, (4, 2, 2)), jnp.float32),
        jnp.asarray(rng.uniform(-3, 3, (4, 2)), jnp.float32))
    pc = convert.cars_from_numpy(jax.device_get(cars), device="cpu")
    for _ in range(3):
        act = rng.uniform(-1.2, 1.2, (4, 2, 3)).astype(np.float32)
        cars = jax.vmap(jstate.apply_controls)(cars, jnp.asarray(act))
        pc = pstate.apply_controls(pc, torch.from_numpy(act))
        for f in ("gas", "brake", "steer"):
            assert np.array_equal(np.asarray(getattr(cars, f)), _np(getattr(pc, f))), f


def test_create_cars_matches():
    rng = np.random.RandomState(4)
    pos = rng.uniform(-300, 300, (4, 2, 2)).astype(np.float32)
    ang = rng.uniform(-4, 4, (4, 2)).astype(np.float32)
    jc = jax.vmap(jstate.create_cars)(jnp.asarray(pos), jnp.asarray(ang))
    pc = pstate.create_cars(torch.from_numpy(pos), torch.from_numpy(ang))
    for f in CAR_FIELDS + ("limit_state",):
        _assert_close(f, getattr(jc, f), _np(getattr(pc, f)), tol=1e-6)
    _assert_close("hull_origin", jax.vmap(lambda c: c.hull_origin)(jc), _np(pc.hull_origin), tol=1e-6)


def test_tire_step_matches(states):
    jcars, on_road, pcars, p_on_road = states
    j_new, j_force, j_motor, j_skid = jax.vmap(jtire.tire_step)(jcars, on_road)
    p_new, p_force, p_motor, p_skid = ptire.tire_step(pcars, p_on_road)
    for f in ("spin", "phase", "fuel_spent"):
        _assert_close(f, getattr(j_new, f), _np(getattr(p_new, f)))
    _assert_close("force", j_force, _np(p_force))
    _assert_close("motor_speed", j_motor, _np(p_motor))
    _assert_close("skid", j_skid, _np(p_skid))


def _joint_inputs(jcars, on_road, pcars, p_on_road):
    """Both sides' world_step entry: velocities after the tire forces."""
    jc, jf, jm, _ = jax.vmap(jtire.tire_step)(jcars, on_road)
    pc, pf, pm, _ = ptire.tire_step(pcars, p_on_road)
    return jc, jf, jm, pc, pf, pm


def test_joints_match(states):
    jc, jf, jm, pc, pf, pm = _joint_inputs(*states)
    dt = JC.DT
    # init_constraints
    jc2, jd = jax.vmap(jjoints.init_constraints)(jc, jm)
    pc2, pd = pjoints.init_constraints(pc, pm)
    _assert_close("limit_state", jd.limit_state, _np(pd.limit_state))
    _assert_close("joint_impulse", jc2.joint_impulse, _np(pc2.joint_impulse))
    _assert_close("r_a", jd.r_a, _np(pd.r_a))
    # warm_start
    mb = float(jshapes.WHEEL_INV_MASS)
    jv = jjoints.Velocities(jc2.hull_v, jc2.hull_w, jc2.wheel_v + dt * mb * jf, jc2.wheel_w)
    pv = pjoints.Velocities(pc2.hull_v, pc2.hull_w, pc2.wheel_v + dt * mb * pf, pc2.wheel_w)
    jv = jax.vmap(jjoints.warm_start)(jv, jd, jc2.joint_impulse, jc2.motor_impulse)
    pv = pjoints.warm_start(pv, pd, pc2.joint_impulse, pc2.motor_impulse)
    for name, a, b in zip(jv._fields, jv, pv):
        _assert_close("warm_start." + name, a, _np(b))
    # solve_velocity (a few iterations, so the limit impulses move)
    ji, jmi, pi_, pmi = jc2.joint_impulse, jc2.motor_impulse, pc2.joint_impulse, pc2.motor_impulse
    vel_j = jax.jit(jax.vmap(partial(jjoints.solve_velocity, dt=dt)))
    for _ in range(5):
        jv, ji, jmi = vel_j(jv, jd, ji, jmi)
        pv, pi_, pmi = pjoints.solve_velocity(pv, pd, pi_, pmi, dt)
    for name, a, b in zip(jv._fields, jv, pv):
        _assert_close("solve_velocity." + name, a, _np(b))
    _assert_close("solve_velocity.joint_impulse", ji, _np(pi_))
    _assert_close("solve_velocity.motor_impulse", jmi, _np(pmi))
    # solve_position, from the pre-step positions
    jp = jjoints.Positions(jc2.hull_c, jc2.hull_a, jc2.wheel_c, jc2.wheel_a)
    pp = pjoints.Positions(pc2.hull_c, pc2.hull_a, pc2.wheel_c, pc2.wheel_a)
    pos_j = jax.jit(jax.vmap(jjoints.solve_position))
    for _ in range(3):
        jp = pos_j(jp, jd)
        pp = pjoints.solve_position(pp, pd)
    for name, a, b in zip(jp._fields, jp, pp):
        _assert_close("solve_position." + name, a, _np(b))


def test_world_step_matches(states):
    jc, jf, jm, pc, pf, pm = _joint_inputs(*states)
    j_new = jax.jit(jax.vmap(jworld.world_step))(jc, jf, jm)
    p_new, p_bundle = pworld.world_step(pc, pf, pm)
    assert p_bundle is None
    for f in CAR_FIELDS + ("limit_state",):
        _assert_close(f, getattr(j_new, f), _np(getattr(p_new, f)))


def test_world_step_rejects_contacts(states):
    """Car-car contacts need two cars per env: at one, a bundle is refused."""
    _, _, _, pc, pf, pm = _joint_inputs(*states)
    with pytest.raises(ValueError, match="two or more cars"):
        pworld.world_step(pc, pf, pm, contacts=object())


def test_island_plain_matches_pallas_kernel(states):
    """island_step_plain vs the JAX joints-only mega-kernel (K1), interpreted
    on the CPU at reduced iteration counts, as tests/test_pallas_world.py
    runs it."""
    jcars, on_road, pcars, p_on_road = states
    vi, pi = 30, 12
    cs = jax.vmap(lambda _: jenv.collide.init_contact_state(1))(jnp.arange(len(SEEDS)))
    j_new, j_skid, _ = pallas_world.step_physics_batched(
        jcars, on_road, cs, 1, velocity_iters=vi, position_iters=pi,
        interpret=True, force_no_contacts=True,
    )
    p_cs = pcollide.init_contact_state(len(SEEDS), 1)
    p_new, p_skid, p_cs2 = fused_world.island_step_plain(pcars, p_on_road, p_cs, vi, pi)
    for f in CAR_FIELDS + ("limit_state",):
        _assert_close(f, getattr(j_new, f), _np(getattr(p_new, f)))
    _assert_close("skid", j_skid, _np(p_skid))
    assert p_cs2 is p_cs          # one car per env: the contact carry passes through


def test_island_step_on_cpu_is_the_plain_version(states):
    _, _, pcars, p_on_road = states
    before = fused_world.island_step.launches
    cs = pcollide.init_contact_state(len(SEEDS), 1)
    a, sa, _ = fused_world.island_step(pcars, p_on_road, cs, 20, 8)
    b, sb, _ = fused_world.island_step_plain(pcars, p_on_road, cs, 20, 8)
    assert fused_world.island_step.launches == before
    for f in CAR_FIELDS + ("limit_state",):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    assert torch.equal(sa, sb)


def _cu_source():
    """The kernel's source with the per-car chain header it includes."""
    csrc = Path(fused_world.__file__).parent.parent / "csrc"
    return (csrc / "car_chain.cuh").read_text() + (csrc / "joints_island.cu").read_text()


def test_kernel_layout_matches_wrapper():
    """The row offsets and parameter order the wrapper packs are the ones the
    kernel source declares."""
    src = _cu_source()
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for k, v in {**fused_world.IN_ROWS, **fused_world.OUT_ROWS}.items():
        assert consts[k] == v, k
    enum = re.search(r"enum Param \{(.*?)\};", src, re.S).group(1)
    names = [n.strip() for n in enum.replace("\n", " ").split(",") if n.strip()]
    assert names[-1] == "N_PARAMS"
    assert [n[2:] for n in names[:-1]] == list(fused_world.PARAM_NAMES)
    assert len(fused_world.param_values()) == len(fused_world.PARAM_NAMES)


def test_kernel_source_keeps_precision_rules():
    src = _cu_source()
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    assert "copysign" not in code           # jnp.sign(0) == 0
    assert "__sinf" not in code and "__cosf" not in code and "__fdividef" not in code
    assert "__sincosf" not in code          # the chain's sincosf is the precise one
    assert not any("fast_math" in f or "fmad" in f for f in _cuda.NVCC_FLAGS)
    assert "arch=compute_90a,code=sm_90a" in _cuda.NVCC_FLAGS


def test_pack_unpack_layout_roundtrip(states):
    """Feeding the packed input rows straight back as outputs (each state
    field to its output row) reproduces the CarState: pack and unpack agree
    on the layout the kernel reads and writes."""
    _, _, pcars, p_on_road = states
    fin, ls_in = fused_world.pack_inputs(pcars, p_on_road)
    I, O = fused_world.IN_ROWS, fused_world.OUT_ROWS
    assert fin.shape == (I["N_IN"], len(SEEDS)) and ls_in.dtype == torch.int32
    fout = torch.zeros((O["N_OUT"], fin.shape[1]))
    fout[O["OUT_HULL"]:O["OUT_HULL"] + 6] = fin[I["IN_HULL"]:I["IN_HULL"] + 6]
    fout[O["OUT_WHEEL"]:O["OUT_WHEEL"] + 24] = fin[I["IN_WHEEL"]:I["IN_WHEEL"] + 24]
    fout[O["OUT_JNT"]:O["OUT_JNT"] + 16] = fin[I["IN_JNT"]:I["IN_JNT"] + 16]
    fout[O["OUT_TIRE"]:O["OUT_TIRE"] + 8] = fin[I["IN_TIRE"] + 12:I["IN_TIRE"] + 20]
    fout[O["OUT_TIRE"] + 8:O["OUT_TIRE"] + 12] = fin[I["IN_ONROAD"]:I["IN_ONROAD"] + 4]
    fout[O["OUT_FUEL"]] = fin[I["IN_FUEL"]]
    new, skid = fused_world.unpack_outputs(pcars, fout, ls_in)
    for f in CAR_FIELDS + ("limit_state",):
        assert torch.equal(getattr(new, f), getattr(pcars, f)), f
    assert torch.equal(skid, p_on_road)


def test_island_flops_grow_with_limits():
    base = fused_world.island_flops(4096, 0)
    assert 4096 * 5e4 < base < 4096 * 6e4
    assert fused_world.island_flops(4096, 100) > base
    assert fused_world.island_bytes(4096) == 4096 * 4 * (71 + 4 + 59 + 4)
