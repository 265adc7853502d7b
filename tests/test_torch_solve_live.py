"""K3's split of the envs (csrc/solve_island.cu): the live ones, listed on
the card, a warp each; the dead ones a thread per car. In its plain
version, on the CPU.

- ``fused_world.solve_live_envs`` (the list pass's test: any point_ok set in
  an env's rows) equals ``point_ok.any`` over rows and points on the Collide
  pass of seeded synthetic poses at N = 2 and N = 4, and is all False for an
  all-dead bundle and for no bundle.
- The premise of the dead cars: an env with no live point, solved by
  ``world.world_step`` with a bundle that has live envs beside it, equals
  the same env solved with ``contacts=None``, bit for bit, and its solved
  impulses are zero.
- ``solve_island_launch`` takes the 17 pointers (the live-env list and its
  count among them), 7 ints and the stream that ``fused_world._library``
  types; it launches the list pass with a bundle and the solve pass always,
  and a live warp returns past the count.

No JAX: the poses are made with numpy and ``state.create_cars``."""

import ctypes
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import _cuda
from multi_car_racing_tpu_torch.physics import collide, fused_world, tire, world
from test_torch_contact_compact import CAR_FIELDS, synthetic_cars

CSRC = Path(fused_world.__file__).parent.parent / "csrc"


def _bundle(n, num_envs, seed, spread):
    """Seeded synthetic poses through the plain tire model, Collide pass and
    make_bundle (a fresh carry): (post-tire cars, force, motor speed,
    bundle)."""
    cars = synthetic_cars(n, num_envs, seed, spread)
    rng = np.random.RandomState(seed + 100)
    gas = torch.as_tensor(rng.uniform(0, 1, (num_envs, n, 4)), dtype=torch.float32)
    cars = cars.replace(gas=gas, steer=gas * 0.3)
    on_road = torch.as_tensor(rng.uniform(size=(num_envs, n, 4)) < 0.7)
    post, force, motor, _ = tire.tire_step(cars, on_road)
    man = collide.collide(post, n)
    bundle = collide.make_bundle(man, collide.init_contact_state(num_envs, n), post, n)
    return post, force, motor, bundle


CASES = {2: (2, 48, 3, 3.0), 4: (4, 24, 4, 10.0)}
ITERS = dict(velocity_iters=30, position_iters=12)   # tests/test_pallas_world.py's


@pytest.mark.parametrize("n", sorted(CASES))
def test_solve_live_envs_is_point_ok_any(n):
    *_, bundle = _bundle(*CASES[n])
    ok = bundle.man.point_ok.numpy()
    live = fused_world.solve_live_envs(bundle, ok.shape[0])
    assert live.dtype == torch.bool and tuple(live.shape) == (ok.shape[0],)
    assert live.tolist() == [bool(env.any()) for env in ok]
    assert 0 < int(live.sum()) < ok.shape[0], "setup: want live and dead envs"


def test_solve_live_envs_is_all_false_when_dead_or_without_a_bundle():
    *_, bundle = _bundle(*CASES[2])
    man = dataclasses.replace(bundle.man, point_ok=torch.zeros_like(bundle.man.point_ok))
    dead = fused_world.solve_live_envs(dataclasses.replace(bundle, man=man), 48)
    none = fused_world.solve_live_envs(None, 48)
    for live in (dead, none):
        assert live.dtype == torch.bool and tuple(live.shape) == (48,)
        assert not bool(live.any())


@pytest.mark.parametrize("n", sorted(CASES))
def test_dead_envs_solve_as_the_joints_only_island(n):
    """K3 runs the cars of an env with no live point as the joints-only
    island: world_step with a mixed bundle equals world_step with no bundle
    on those envs, bit for bit, and their solved impulses are zero (at
    30/12 iterations: the premise holds at any count)."""
    post, force, motor, bundle = _bundle(*CASES[n])
    live = fused_world.solve_live_envs(bundle, post.hull_a.shape[0])
    assert bool(live.any()) and not bool(live.all()), "setup: want a mixed bundle"
    mixed, out = world.world_step(post, force, motor, contacts=bundle, **ITERS)
    alone, none = world.world_step(post, force, motor, contacts=None, **ITERS)
    assert none is None
    dead = ~live
    for f in CAR_FIELDS[:10] + ("limit_state",):
        a, b = getattr(mixed, f)[dead], getattr(alone, f)[dead]
        assert torch.equal(a, b), f
    assert not bool(out.normal_imp[dead].any()) and not bool(out.tangent_imp[dead].any())
    # The live envs did feel their contacts.
    assert not torch.equal(mixed.hull_v[live], alone.hull_v[live])


def test_solve_launch_signature_matches_the_wrapper(monkeypatch):
    """solve_island_launch takes 17 pointers (the live-env list and count
    among them), 7 ints and the stream, as fused_world._library types it;
    the list pass launches only with a bundle (MM != 0), the solve pass
    always, and its live warps return past the count they read on the
    card."""
    src = (CSRC / "solve_island.cu").read_text()
    sig = re.search(r"int solve_island_launch\((.*?)\)\s*\{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    pointers = [p for p in params if "*" in p and "stream" not in p]
    ints = [p for p in params if p.startswith("int ")]
    assert len(pointers) == 17 and len(ints) == 7 and params[-1] == "void* stream"
    assert [p.split("*")[-1].strip() for p in pointers[-2:]] == ["live_list", "live_count"]
    body = src[src.index("int solve_island_launch("):]
    assert body.index("if (MM != 0) {") < body.index("list_pass_kernel<<<")
    assert body.index("list_pass_kernel<<<") < body.index("solve_pass_kernel<<<")
    assert "if (w >= *live_count) return;" in src
    assert "solve_live_env(live_list[w]," in src

    class Fn:
        argtypes = restype = None

    fake = type("Lib", (), {"solve_island_launch": Fn(), "solve_island_error_string": Fn()})()
    monkeypatch.setattr(_cuda, "load", lambda name: fake)
    fused_world._library(fused_world.SOLVE_KERNEL)
    assert fake.solve_island_launch.argtypes == (
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
