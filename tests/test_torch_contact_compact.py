"""The compact lists of the contact solve (csrc/contact_rows.cuh's
``build_live_lists``, K2's near pass and K3) in their plain version,
``fused_world.live_routing``, and the far-env split of K2 (csrc/contact_island.cu:
a far env's cars run as single-car islands), on the CPU.

- The live rows are the rows with a live point, ascending; each body's live
  entries are ``contact_index_table``'s entries whose row is live, in the
  table's order, at the body's table offset. Held on the Collide pass of
  seeded synthetic poses at N = 2 and N = 4, and on four overlapping cars
  with more than 32 live rows (the near pass's path past one row per lane).
- A far env at N = 2 through ``island_step_plain`` equals the same cars as
  N = 1 envs, bit for bit (so within the value bar 5e-4 * max(1, |x|)).

No JAX: the poses are made with numpy and ``state.create_cars``."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch.physics import collide, fused_world
from multi_car_racing_tpu_torch.physics.state import create_cars
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

CSRC = Path(fused_world.__file__).parent.parent / "csrc"
TOL = 5e-4
CAR_FIELDS = ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a",
              "wheel_v", "wheel_w", "joint_impulse", "motor_impulse", "spin",
              "phase", "fuel_spent")


def synthetic_cars(n, num_envs, seed, spread):
    """``n`` cars per env scattered within ``spread`` metres at random
    angles, wheels jittered about their anchors, moving."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-300, 300, (num_envs, 1, 2))
    pos = base + rng.uniform(-spread, spread, (num_envs, n, 2))
    ang = rng.uniform(-np.pi, np.pi, (num_envs, n))
    cars = create_cars(torch.as_tensor(pos, dtype=torch.float32),
                       torch.as_tensor(ang, dtype=torch.float32))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32)  # noqa: E731
    return cars.replace(
        wheel_c=cars.wheel_c + f32(rng.uniform(-0.3, 0.3, tuple(cars.wheel_c.shape))),
        wheel_a=cars.wheel_a + f32(rng.uniform(-0.4, 0.4, tuple(cars.wheel_a.shape))),
        hull_v=f32(rng.uniform(-5, 5, tuple(cars.hull_v.shape))),
        wheel_v=f32(rng.uniform(-5, 5, tuple(cars.wheel_v.shape))),
        hull_w=f32(rng.uniform(-1, 1, tuple(cars.hull_w.shape))))


def piled_cars(num_envs, seed, step=0.3, turn=0.15):
    """Four cars per env on one pose, car c moved ``step`` m in direction
    c * 90 degrees and turned by c * ``turn`` rad: every pair overlaps, and
    an env has more than 32 live rows (chip_smoke.py's phase 7 input)."""
    rng = np.random.RandomState(seed)
    n = 4
    pos = np.repeat(rng.uniform(-300, 300, (num_envs, 1, 2)), n, 1)
    c = np.arange(n) * (np.pi / 2)
    pos = pos + step * np.stack([np.cos(c), np.sin(c)], -1)[None]
    ang = np.repeat(rng.uniform(-np.pi, np.pi, (num_envs, 1)), n, 1) + turn * np.arange(n)[None]
    return create_cars(torch.as_tensor(pos, dtype=torch.float32),
                       torch.as_tensor(ang, dtype=torch.float32))


def piled_groups(n, num_envs, seed, step=0.3, turn=0.15, gap=25.0):
    """``n`` cars per env at rest in groups of four (the last one short at
    odd n), ``gap`` m apart, each group piled as ``piled_cars`` piles its
    four: more than 32 live rows a group (chip_smoke.py's phase 30 input
    past 32 cars)."""
    rng = np.random.RandomState(seed)
    g, k = np.arange(n) // 4, np.arange(n) % 4
    c = k * (np.pi / 2)
    pos = (rng.uniform(-300, 300, (num_envs, 1, 2)) + np.stack([gap * g, 0 * g], -1)[None]
           + step * np.stack([np.cos(c), np.sin(c)], -1)[None])
    ang = rng.uniform(-np.pi, np.pi, (num_envs, int(g[-1]) + 1))[:, g] + turn * k[None]
    return create_cars(torch.as_tensor(pos, dtype=torch.float32),
                       torch.as_tensor(ang, dtype=torch.float32))


CASES = {
    "N=2 scattered": lambda: (synthetic_cars(2, 48, 3, 3.0), 2),
    "N=4 scattered": lambda: (synthetic_cars(4, 24, 4, 4.0), 4),
    "N=4 piled": lambda: (piled_cars(8, 5), 4),
}


def reference_lists(live, num_cars):
    """The lists by a loop over the routing table, one env at a time."""
    tab = fused_world.contact_index_table(num_cars)
    mm, nb = live.shape[1], 5 * num_cars
    offsets = tab[4 * mm:4 * mm + nb + 1]
    entries = tab[4 * mm + nb + 1:]
    rows, bodies = [], []
    for env in live:
        rows.append([r for r in range(mm) if env[r]])
        bodies.append([[int(e) for e in entries[offsets[b]:offsets[b + 1]] if env[e >> 1]]
                       for b in range(nb)])
    return rows, bodies, offsets


@pytest.mark.parametrize("case", sorted(CASES))
def test_live_routing_is_the_routing_table_filtered_by_the_live_bits(case):
    cars, n = CASES[case]()
    ok = collide.collide(cars, n).point_ok
    live = ok.any(-1).numpy()
    rows, n_rows, entries, counts = (x.numpy() for x in fused_world.live_routing(ok, n))
    ref_rows, ref_bodies, offsets = reference_lists(live, n)
    mm, nb = live.shape[1], 5 * n
    assert rows.shape == (len(live), mm) and entries.shape == (len(live), 2 * mm)
    assert counts.shape == (len(live), nb)
    for e in range(len(live)):
        assert n_rows[e] == len(ref_rows[e])
        assert rows[e, :n_rows[e]].tolist() == ref_rows[e]
        assert (rows[e, n_rows[e]:] == -1).all()
        for b in range(nb):
            lst = ref_bodies[e][b]
            assert counts[e, b] == len(lst)
            seg = entries[e, offsets[b]:offsets[b + 1]]
            assert seg[:len(lst)].tolist() == lst
            assert (seg[len(lst):] == -1).all()
    # Each live row is routed to its two bodies, once each.
    assert int(counts.sum()) == 2 * int(live.sum())
    assert int(n_rows.max()) > 0, "setup: no live row"
    if case == "N=4 piled":
        assert int(n_rows.max()) > 32, "setup: no env past one live row per lane"


def test_live_routing_of_an_all_dead_batch_is_empty():
    ok = torch.zeros((3, 48, 2), dtype=torch.bool)
    rows, n_rows, entries, counts = fused_world.live_routing(ok, 2)
    assert int(n_rows.sum()) == 0 and int(counts.sum()) == 0
    assert bool((rows == -1).all()) and bool((entries == -1).all())


def test_far_envs_at_two_cars_are_single_car_islands():
    """K2's far pass runs a far env's cars as K1 runs single cars: the plain
    island at N = 2 on far envs equals the same cars at N = 1, bit for bit."""
    cars = synthetic_cars(2, 6, 7, 3.0)
    hc, wc = cars.hull_c.clone(), cars.wheel_c.clone()
    hc[:, 1, 0] += 500.0
    wc[:, 1, :, 0] += 500.0
    cars = cars.replace(hull_c=hc, wheel_c=wc)
    assert not bool(fused_world.near_flags(cars).any())
    rng = np.random.RandomState(8)
    on_road = torch.as_tensor(rng.uniform(size=(6, 2, 4)) < 0.7)
    gas = torch.as_tensor(rng.uniform(0, 1, (6, 2, 4)), dtype=torch.float32)
    cars = cars.replace(gas=gas, steer=gas * 0.3)
    cs = collide.init_contact_state(6, 2)
    two, skid2, cs2 = fused_world.island_step_plain(cars, on_road, cs)

    def alone(x):                                   # (E, 2, ...) -> (2E, 1, ...)
        return x.reshape(x.shape[0] * 2, 1, *x.shape[2:])

    single = cars.replace(**{f.name: alone(getattr(cars, f.name))
                             for f in dataclasses.fields(cars)})
    one, skid1, _ = fused_world.island_step_plain(
        single, alone(on_road), collide.init_contact_state(12, 1))
    for f in CAR_FIELDS + ("limit_state",):
        a = getattr(two, f)
        b = getattr(one, f).reshape(a.shape)
        assert float((a.double() - b.double()).abs().max()) <= TOL * max(
            1.0, float(a.abs().max())), f
        assert torch.equal(a, b), f
    assert torch.equal(skid2, skid1.reshape(skid2.shape))
    assert bool((cs2.ids == -1).all()) and not bool(cs2.normal_imp.any())
    assert not bool(cs2.tangent_imp.any())


def test_contact_launch_signature_matches_the_wrapper():
    """contact_island_launch takes the 15 pointers and 7 ints, then the
    scratch buffer and its slots (and the stream) that fused_world._library
    types, the near list and its count among them; the near pass reads the
    count on the card, in its shared-memory and its scratch builds (one car a
    lane, and several past 32 cars)."""
    src = (CSRC / "contact_island.cu").read_text()
    sig = re.search(r"int contact_island_launch\((.*?)\)\s*\{", src, re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    pointers = [p for p in params if "*" in p and "stream" not in p]
    ints = [p for p in params if p.startswith("int ")]
    assert len(pointers) == 16 and len(ints) == 8 and params[-1] == "void* stream"
    assert params[-3:-1] == ["float* scratch", "int scratch_warps"]
    assert any("near_list" in p for p in pointers)
    assert any("near_count" in p for p in pointers)
    assert "far_pass_kernel<<<" in src
    assert "near_pass_kernel<false, false><<<" in src and "near_pass_kernel<true, false><<<" in src
    assert "near_pass_kernel<true, true><<<" in src          # past 32 cars: a lane carries several
    assert "if (w >= *near_count) return;" in src and "i < count; i += stride" in src
