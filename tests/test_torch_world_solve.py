"""The solve alone: the port's ``fused_world.world_step_batched`` (on CPU
tensors, ``world.world_step`` on the given bundle; on the card, K3) against
the JAX package's ``pallas_world.world_step_batched`` (the solve-only Pallas
kernel, in the interpreter) and its vmapped ``world.world_step``, at
tests/test_pallas_world.py's reduced 30/12 iterations.

Both sides solve from the same manifolds: the JAX tire model, Collide pass
and ``make_bundle`` run once, and the JAX ``ContactBundle`` crosses to the
port through ``convert.bundle_from_numpy``, so the solve is held apart from
Collide. The inputs are synthetic (no JAX physics is driven to make them):

- test_torch_contact_step's placed contacts: 3 envs of 2 cars pushed 5 cm
  into each other, a warm-start carry whose ids match in two envs and not in
  the third;
- a joints-only batch of one car per env at random placed poses (no bundle);
- the placed contacts with contact_velocity_iters=10 and
  contact_position_iters=4 of the 30/12 (the port's ``world.world_step``
  takes both counts, as the JAX one does).

Bars as tests/test_torch_contact_ram.py: every CarState field and both
impulses within 5e-4 * max(1, max|jax|) and 5e-4 * max(1e-3, max|jax - pre|),
limit states equal."""

import dataclasses
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu.physics import collide as jcollide, pallas_world
from multi_car_racing_tpu.physics import shapes as jshapes, state as jstate, tire as jtire
from multi_car_racing_tpu.physics import world as jworld

from multi_car_racing_tpu_torch import convert
from multi_car_racing_tpu_torch.physics import fused_world, world

from test_torch_contact_ram import CAR_FIELDS, PI, VI, assert_both_bars
from test_torch_contact_step import _placed_contacts

REDUCED = dict(contact_velocity_iters=10, contact_position_iters=4)


def _joints_only_cars():
    """(JAX cars, wheel_on_road) of 4 envs of one car at random placed poses,
    wheels at their rotated anchors, driven and steered."""
    rng = np.random.RandomState(3)
    E = 4
    pos = rng.uniform(-300, 300, (E, 1, 2)).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (E, 1)).astype(np.float32)
    cars = jax.vmap(jstate.create_cars)(jnp.asarray(pos), jnp.asarray(ang))
    c, s = np.cos(ang)[..., None], np.sin(ang)[..., None]
    wp = jshapes.WHEEL_POS[None, None]
    wheel_c = pos[:, :, None, :] + np.stack([c * wp[..., 0] - s * wp[..., 1],
                                             s * wp[..., 0] + c * wp[..., 1]], -1)
    hull_v = rng.uniform(-8, 8, (E, 1, 2)).astype(np.float32)
    cars = cars.replace(
        wheel_c=jnp.asarray(wheel_c, jnp.float32),
        wheel_a=cars.wheel_a + jnp.asarray(rng.uniform(-0.3, 0.3, (E, 1, 4)), jnp.float32),
        hull_v=jnp.asarray(hull_v), hull_w=jnp.asarray(rng.uniform(-1, 1, (E, 1)), jnp.float32),
        wheel_v=jnp.asarray(np.repeat(hull_v[:, :, None], 4, 2), jnp.float32),
        gas=jnp.asarray(rng.uniform(0, 1, (E, 1, 4)), jnp.float32),
        brake=jnp.asarray(rng.uniform(0, 0.3, (E, 1, 4)), jnp.float32),
        steer=jnp.asarray(rng.uniform(-0.5, 0.5, (E, 1, 4)), jnp.float32),
    )
    return cars, jnp.asarray(rng.rand(E, 1, 4) > 0.3)


def _solve_inputs(cars, on_road, cs, n):
    """The JAX tire model, and at n >= 2 the Collide pass and make_bundle:
    (post-tire cars, wheel force, motor speed, bundle or None)."""
    post, force, motor, _ = jax.vmap(jtire.tire_step)(cars, on_road)
    if n == 1:
        return post, force, motor, None
    man = jax.vmap(lambda c: jcollide.collide(c, n))(post)
    bundle = jax.vmap(lambda m, s, c: jcollide.make_bundle(m, s, c, n))(man, cs, post)
    return post, force, motor, bundle


@pytest.fixture(scope="module")
def inputs():
    cars, on_road, cs = _placed_contacts()
    jcars, jon_road = _joints_only_cars()
    return {"placed": _solve_inputs(cars, on_road, cs, 2),
            "joints_only": _solve_inputs(jcars, jon_road, None, 1)}


def _xla(n, iters):
    """The JAX package's world_step, vmapped over envs and jitted."""
    def one(c, f, m, b):
        out = jworld.world_step(c, f, m, contacts=b, **iters)
        return out if b is not None else (out, None)
    return jax.jit(jax.vmap(one))


def _reference(ref, inp, n, iters):
    post, force, motor, bundle = inp
    if ref == "xla":
        new, b = _xla(n, iters)(post, force, motor, bundle)
        return new, None if b is None else (b.normal_imp, b.tangent_imp)
    return pallas_world.world_step_batched(post, force, motor, bundle, n, interpret=True,
                                           **iters)


def _port(inp, n, iters):
    post, force, motor, bundle = (jax.device_get(x) for x in inp)
    cars = convert.cars_from_numpy(post, device="cpu")
    pb = None if bundle is None else convert.bundle_from_numpy(bundle, device="cpu")
    return fused_world.world_step_batched(cars, torch.from_numpy(np.array(force)),
                                          torch.from_numpy(np.array(motor)), pb, n, **iters)


def _assert_solve_matches(ref_out, port_out, inp):
    (r_cars, r_imp), (p_cars, p_imp) = ref_out, port_out
    post, bundle = inp[0], inp[3]
    for f in CAR_FIELDS:
        assert_both_bars(f, getattr(r_cars, f), getattr(p_cars, f).numpy(), getattr(post, f))
    assert np.array_equal(np.asarray(r_cars.limit_state), p_cars.limit_state.numpy())
    if bundle is None:
        assert r_imp is None and p_imp is None
        return
    for name, r, p, pre in zip(("normal_imp", "tangent_imp"), r_imp, p_imp,
                               (bundle.normal_imp, bundle.tangent_imp)):
        assert_both_bars(name, r, p.numpy(), pre)


@pytest.mark.parametrize("ref", ["pallas_interpret", "xla"])
@pytest.mark.parametrize("name", ["placed", "joints_only"])
def test_world_step_batched_matches_jax(inputs, name, ref):
    inp = inputs[name]
    n = 1 if name == "joints_only" else 2
    iters = dict(velocity_iters=VI, position_iters=PI)
    ref_out = _reference(ref, inp, n, iters)
    if n == 2:
        ok = np.asarray(inp[3].man.point_ok)
        assert ok.any(-1).any(-1).all(), "setup: every env in contact"
        assert float(jnp.abs(ref_out[1][0]).max()) > 0.1, "setup: no contact impulse"
    _assert_solve_matches(ref_out, _port(inp, n, iters), inp)


def test_reduced_contact_iterations_match_jax(inputs):
    """contact_velocity_iters and contact_position_iters below the solver's
    counts: the first iterations interleave contacts, the rest run joints
    only, on both sides; the result differs from the full interleave."""
    inp = inputs["placed"]
    iters = dict(velocity_iters=VI, position_iters=PI, **REDUCED)
    port_out = _port(inp, 2, iters)
    _assert_solve_matches(_reference("xla", inp, 2, iters), port_out, inp)
    full = _port(inp, 2, dict(velocity_iters=VI, position_iters=PI))
    assert not torch.equal(port_out[0].hull_c, full[0].hull_c)


def test_bundle_crosses_bit_for_bit(inputs):
    bundle = jax.device_get(inputs["placed"][3])
    pb = convert.bundle_from_numpy(bundle, device="cpu")
    for f in ("normal", "point", "separation", "point_ok", "ids"):
        a, b = getattr(bundle.man, f), getattr(pb.man, f)
        assert b.dtype == {"point_ok": torch.bool, "ids": torch.int32}.get(f, torch.float32)
        assert np.array_equal(np.asarray(a), b.numpy()), f
    for f in ("normal_imp", "tangent_imp", "r_a", "r_b", "normal_mass", "tangent_mass",
              "com_a0", "com_b0"):
        assert np.array_equal(np.asarray(getattr(bundle, f)), getattr(pb, f).numpy()), f


def test_cpu_path_is_world_step_on_the_same_bundle(inputs):
    post, force, motor, bundle = (jax.device_get(x) for x in inputs["placed"])
    cars = convert.cars_from_numpy(post, device="cpu")
    pb = convert.bundle_from_numpy(bundle, device="cpu")
    f, m = torch.from_numpy(np.array(force)), torch.from_numpy(np.array(motor))
    new, (ni, ti) = fused_world.world_step_batched(cars, f, m, pb, 2, VI, PI, **REDUCED)
    ref, rb = world.world_step(cars, f, m, velocity_iters=VI, position_iters=PI,
                               contacts=pb, **REDUCED)
    for fld in dataclasses.fields(ref):
        assert torch.equal(getattr(new, fld.name), getattr(ref, fld.name)), fld.name
    assert torch.equal(ni, rb.normal_imp) and torch.equal(ti, rb.tangent_imp)
    with pytest.raises(ValueError, match="cars per env"):
        fused_world.world_step_batched(cars, f, m, pb, 3)
    with pytest.raises(ValueError, match="expects CUDA"):
        fused_world.launch_solve(*fused_world.pack_solve_inputs(cars, f, m), pb, 2)


def test_kernel_source_declares_the_solve_layout():
    """K3's row offsets are the ones the wrapper packs, and its source keeps
    the port's precision rules (fixed-order sums, sign(0) == 0, precise math)."""
    csrc = Path(fused_world.__file__).parent.parent / "csrc"
    src = "".join((csrc / f).read_text() for f in ("car_chain.cuh", "contact_rows.cuh",
                                                   "solve_island.cu"))
    consts = {k: int(v) for k, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    for k, v in fused_world.SOLVE_IN_ROWS.items():
        assert consts[k] == v, k
    assert fused_world.N_SOLVE_OUT == consts["OUT_TIRE"]
    code = "\n".join(ln.split("//")[0] for ln in src.splitlines())
    # Fixed-order sums: the one atomic is the list pass's append to the live
    # list, on its int32 count.
    assert re.findall(r"atomicAdd\((\w+)", code) == ["live_count"]
    assert "copysign" not in code
    assert "__sinf" not in code and "__cosf" not in code and "__fdividef" not in code
