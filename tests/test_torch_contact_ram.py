"""The port on the JAX package's rear-end ram (tests/test_pallas_world.py): 4
cars, seed 11, global stream 5, the second-row car at full gas for 110 steps
at the reduced 30/12 iteration counts that file uses, so the rammer and the
rammed car are in persistent contact with warm-started impulses.

From that state, identical on both sides:
- the Collide pass: ids and point_ok equal, geometry within the value bar;
- one physics step through the port's plain ``island_step`` against the JAX
  package's fused kernel ``step_physics_batched`` (Pallas interpreter, as
  tests/test_pallas_world.py runs it) and against its XLA pipeline: every
  CarState field and both impulses within 5e-4 * max(1, max|jax|) and within
  5e-4 * max(1e-3, max|jax - pre|) (the step's own change), ids, limit
  states and skid flags equal.

Multi-step trajectories past a car-car contact diverge chaotically even
between the JAX package's own paths (docs/PARITY.md), so parity is per step."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multi_car_racing_tpu import config as JC, env as jenv, seeding as jseed
from multi_car_racing_tpu.physics import collide as jcollide, pallas_world, tire as jtire
from multi_car_racing_tpu.physics import world as jworld

from multi_car_racing_tpu_torch import convert
from multi_car_racing_tpu_torch.physics import fused_world

from test_torch_collide import compare_manifolds
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N = 4
VI, PI = 30, 12
TOL = 5e-4
STEP_FLOOR = 1e-3
CAR_FIELDS = ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a", "wheel_v",
              "wheel_w", "joint_impulse", "motor_impulse", "spin", "phase", "fuel_spent")


def assert_both_bars(name, ref, got, pre):
    """|got - ref| within TOL * max(1, max|ref|) and within
    TOL * max(STEP_FLOOR, max|ref - pre|)."""
    ref, got, pre = (np.asarray(x, np.float64) for x in (ref, got, pre))
    d = float(np.abs(ref - got).max())
    value_bar = TOL * max(1.0, float(np.abs(ref).max()))
    step_bar = TOL * max(STEP_FLOOR, float(np.abs(ref - pre).max()))
    assert d <= value_bar and d <= step_bar, (
        f"{name}: maxabs {d:.3g}, value bar {value_bar:.3g}, step bar {step_bar:.3g}")


def assert_value_bar(name, ref, got):
    ref, got = np.asarray(ref, np.float64), np.asarray(got, np.float64)
    d = float(np.abs(ref - got).max())
    assert d <= TOL * max(1.0, float(np.abs(ref).max())), f"{name}: maxabs {d:.3g}"


def xla_pipeline(num_cars, vi, pi):
    """The JAX package's unfused physics stage, vmapped over envs."""
    def one(cars, on_road, cs):
        cars2, force, motor, skid = jtire.tire_step(cars, on_road)
        man = jcollide.collide(cars2, num_cars)
        bundle = jcollide.make_bundle(man, cs, cars2, num_cars)
        new, nb = jworld.world_step(cars2, force, motor, velocity_iters=vi,
                                    position_iters=pi, contacts=bundle)
        return new, skid, jcollide.ContactState(nb.normal_imp, nb.tangent_imp, man.ids)
    return jax.jit(jax.vmap(one))


def assert_step_matches(ref, port, pre_cars, pre_cs):
    """One physics step (cars, skid, contact state) of JAX against the port's."""
    r_cars, r_skid, r_cs = ref
    p_cars, p_skid, p_cs = port
    for f in CAR_FIELDS:
        assert_both_bars(f, getattr(r_cars, f), getattr(p_cars, f).numpy(),
                         getattr(pre_cars, f))
    assert np.array_equal(np.asarray(r_cars.limit_state), p_cars.limit_state.numpy())
    assert np.array_equal(np.asarray(r_skid), p_skid.numpy())
    assert np.array_equal(np.asarray(r_cs.ids), p_cs.ids.numpy()), "manifold ids"
    assert_both_bars("normal_imp", r_cs.normal_imp, p_cs.normal_imp.numpy(), pre_cs.normal_imp)
    assert_both_bars("tangent_imp", r_cs.tangent_imp, p_cs.tangent_imp.numpy(),
                     pre_cs.tangent_imp)


@pytest.fixture(scope="module")
def ram():
    """(JAX state batch of 2 identical envs, the port's copy)."""
    cfg = JC.EnvConfig(num_agents=N, velocity_iters=VI, position_iters=PI, solver="xla")
    state, _ = jenv.host_reset(cfg, seed=11, global_stream=jseed.GlobalStream(5))
    gs = jseed.GlobalStream(5)
    gs.direction()
    order = list(gs.car_order(N))
    acts = np.zeros((N, 3), np.float32)
    acts[order.index(2)] = [0.0, 1.0, 0.0]
    step = jax.jit(partial(jenv.step, cfg))
    for _ in range(110):
        state, _, _ = step(state, jnp.asarray(acts))
    st = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), state)
    return st, convert.env_state_from_numpy(jax.device_get(st), device="cpu")


def test_collide_matches_jax_on_the_ram_state(ram):
    st, pst = ram
    assert float(jnp.abs(st.contacts.normal_imp).max()) > 0.1, "setup: no contact"
    assert compare_manifolds(st.cars, pst.cars, N) >= 2


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
def test_one_physics_step_matches_jax_on_the_ram_state(ram, ref):
    st, pst = ram
    if ref == "xla":
        out = xla_pipeline(N, VI, PI)(st.cars, st.wheel_on_road, st.contacts)
    else:
        out = pallas_world.step_physics_batched(
            st.cars, st.wheel_on_road, st.contacts, N,
            velocity_iters=VI, position_iters=PI, interpret=True)
    port = fused_world.island_step(pst.cars, pst.wheel_on_road, pst.contacts, VI, PI)
    assert float(jnp.abs(out[2].normal_imp).max()) > 0.1, "setup: no contact impulse"
    assert_step_matches(out, port, st.cars, st.contacts)


def test_contact_solver_passes_match_jax_on_the_ram_state(ram):
    """collide.py's solver pieces one at a time from the same bundle:
    make_bundle, warm_start, three velocity_pass calls and a position_pass,
    within the value bar."""
    from multi_car_racing_tpu.physics import joints as jjoints
    from multi_car_racing_tpu_torch.physics import collide as pcollide, joints as pjoints

    st, pst = ram
    jcars, pcars = st.cars, pst.cars
    jm = jax.vmap(lambda c: jcollide.collide(c, N))(jcars)
    jb = jax.vmap(lambda m, cs, c: jcollide.make_bundle(m, cs, c, N))(jm, st.contacts, jcars)
    pb = pcollide.make_bundle(pcollide.collide(pcars, N), pst.contacts, pcars, N)
    for f in ("normal_imp", "tangent_imp", "r_a", "r_b", "normal_mass", "tangent_mass",
              "com_a0", "com_b0"):
        assert_value_bar(f, getattr(jb, f), getattr(pb, f).numpy())
    assert float(np.abs(np.asarray(jb.normal_imp)).max()) > 0.1   # warm start carried

    jv = jjoints.Velocities(jcars.hull_v, jcars.hull_w, jcars.wheel_v, jcars.wheel_w)
    pv = pjoints.Velocities(pcars.hull_v, pcars.hull_w, pcars.wheel_v, pcars.wheel_w)
    jv = jax.vmap(lambda v, b: jcollide.warm_start(v, b, N))(jv, jb)
    pv = pcollide.warm_start(pv, pb, N)
    jn, jt, pn, pt = jb.normal_imp, jb.tangent_imp, pb.normal_imp, pb.tangent_imp
    vel_pass = jax.jit(jax.vmap(lambda v, n, t, b: jcollide.velocity_pass(v, n, t, b, N)))
    for _ in range(3):
        jv, jn, jt = vel_pass(jv, jn, jt, jb)
        pv, pn, pt = pcollide.velocity_pass(pv, pn, pt, pb, N)
    for name, a, b in zip(jv._fields, jv, pv):
        assert_value_bar(name, a, b.numpy())
    assert_value_bar("normal_imp", jn, pn.numpy())
    assert_value_bar("tangent_imp", jt, pt.numpy())

    jp = jjoints.Positions(jcars.hull_c, jcars.hull_a, jcars.wheel_c, jcars.wheel_a)
    pp = pjoints.Positions(pcars.hull_c, pcars.hull_a, pcars.wheel_c, pcars.wheel_a)
    jp = jax.vmap(lambda p, b: jcollide.position_pass(p, b, N))(jp, jb)
    pp = pcollide.position_pass(pp, pb, N)
    for name, a, b in zip(jp._fields, jp, pp):
        assert_value_bar(name, a, b.numpy())


def test_convert_carries_live_contacts_both_ways(ram):
    """A JAX state with live contacts (MM = 288 rows at N = 4) crosses to the
    port and back with every value and dtype kept."""
    st, pst = ram
    assert tuple(pst.contacts.ids.shape) == (2, 288) and bool((pst.contacts.ids >= 0).any())
    back = convert.env_state_to_numpy(pst)["contacts"]
    for f in ("normal_imp", "tangent_imp", "ids"):
        a = np.asarray(getattr(st.contacts, f))
        assert back[f].dtype == a.dtype and np.array_equal(back[f], a), f
