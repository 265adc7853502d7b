"""The port's plain stages past 32 cars an env, where the card's kernels K2,
K3 (a lane carries several cars), K4/K5 and K6 take any number of cars: held
against the JAX package on the CPU at N = 33 and, where cheap, N = 64, with
the bars of the narrower tests.

- ``contact_index_table``: its rows' fixtures and body slots equal JAX's
  ``collide.tables``, and each body's entries are the rows of its column in
  JAX's incidence matrices (``collide.tables`` in the port's body order,
  ``pallas_world._contact_tables`` in the TPU kernel's), side A then B.
- The Collide pass and ``live_routing`` at N = 33 on seeded synthetic poses
  (cars packed close, so many pairs touch; more than 32 live rows an env):
  ids and point_ok equal to JAX's ``collide.collide``, and the compact lists
  equal to the routing table filtered by JAX's live bits.
- ``track_pass_plain`` against JAX's XLA track pass at N = 33 and 64 on
  synthetic poses over host tracks: masks, counts and nearest_beta equal,
  bonus within 2e-5.

The painter's stage at N = 33 is tests/test_torch_wide_pixels.py.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import env as jenv
from multi_car_racing_tpu.physics import collide as jcollide, pallas_world, state as jstate
from multi_car_racing_tpu.track import common as jcommon

from multi_car_racing_tpu_torch.physics import collide, fused_world, track_engine
from multi_car_racing_tpu_torch.physics.state import create_cars
from test_torch_contact_compact import reference_lists
from test_torch_track_engine import (assert_track_outputs_match, make_case, port_inputs,
                                     CAR_FIELDS)
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

WIDE = (33, 64)


def _routing(num_cars):
    """(offsets (NB + 1), entries (2 MM)) of the port's routing table."""
    tab = fused_world.contact_index_table(num_cars)
    mm, nb = len(collide.car_pairs(num_cars)) * collide.M_PER_PAIR, 5 * num_cars
    return tab, tab[4 * mm:4 * mm + nb + 1], tab[4 * mm + nb + 1:]


def _entries_of(wa, wb, body):
    """Body's routing entries from incidence columns: row*2 (A), row*2 + 1 (B)."""
    rows_a = np.flatnonzero(wa[:, body])
    rows_b = np.flatnonzero(wb[:, body])
    return sorted([2 * int(r) for r in rows_a] + [2 * int(r) + 1 for r in rows_b])


@pytest.mark.parametrize("n", WIDE)
def test_contact_index_table_is_jax_collide_tables(n):
    pairs, rows_a, rows_b, wa, wb, _, _, fix_a, fix_b = jcollide.tables(n)
    tab, offsets, entries = _routing(n)
    mm, nb = len(pairs) * jcollide.M_PER_PAIR, 5 * n
    assert tab.dtype == np.int32 and tab.shape == (4 * mm + nb + 1 + 2 * mm,)
    for k, ref in enumerate((fix_a, fix_b, rows_a, rows_b)):
        np.testing.assert_array_equal(tab[k * mm:(k + 1) * mm], ref)
    assert offsets[0] == 0 and offsets[-1] == 2 * mm
    # Every body against its incidence columns; hulls and wheels of the first,
    # last and a middle car (all 5N bodies at N = 33).
    cars = range(n) if n == 33 else (0, n // 2, n - 1)
    bodies = [b for c in cars for b in range(5 * c, 5 * c + 5)]
    for b in bodies:
        assert entries[offsets[b]:offsets[b + 1]].tolist() == _entries_of(wa, wb, b), b


def test_contact_index_table_is_the_tpu_kernels_incidence_at_33():
    """The TPU kernel orders bodies as the N hulls, then wheel k of every car
    (``row(car, fixture)``); the port's body car*5 + j is its column
    ``car`` (j = 0) or ``n + (j - 1) n + car``."""
    n = 33
    wa, wb, wd, _, _ = pallas_world._contact_tables(n)
    _, offsets, entries = _routing(n)
    for car in range(n):
        for j in range(5):
            col = car if j == 0 else n + (j - 1) * n + car
            assert entries[offsets[5 * car + j]:offsets[5 * car + j + 1]].tolist() == \
                _entries_of(wa, wb, col), (car, j)
    np.testing.assert_array_equal(wd, wb - wa)


def _packed_cars(n, num_envs, seed, spread):
    """``n`` cars per env within ``spread`` metres at random angles, wheels
    jittered about their anchors: (port CarState, JAX CarState)."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-300, 300, (num_envs, 1, 2))
    pos = (base + rng.uniform(-spread, spread, (num_envs, n, 2))).astype(np.float32)
    ang = rng.uniform(-np.pi, np.pi, (num_envs, n)).astype(np.float32)
    cars = create_cars(torch.as_tensor(pos), torch.as_tensor(ang))
    cars = cars.replace(
        wheel_c=cars.wheel_c + torch.as_tensor(rng.uniform(-0.3, 0.3, tuple(cars.wheel_c.shape)),
                                               dtype=torch.float32),
        wheel_a=cars.wheel_a + torch.as_tensor(rng.uniform(-0.4, 0.4, tuple(cars.wheel_a.shape)),
                                               dtype=torch.float32))
    jc = jstate.CarState(**{f: jnp.asarray(getattr(cars, f).numpy()) for f in CAR_FIELDS})
    return cars, jc


def test_collide_and_live_routing_at_33_match_jax():
    n = 33
    cars, jc = _packed_cars(n, 2, 33, 12.0)
    man = collide.collide(cars, n)
    jman = jax.jit(jax.vmap(partial(jcollide.collide, num_cars=n)))(jc)
    np.testing.assert_array_equal(man.ids.numpy(), np.asarray(jman.ids))
    np.testing.assert_array_equal(man.point_ok.numpy(), np.asarray(jman.point_ok))
    live = np.asarray(jman.point_ok).any(-1)
    rows, n_rows, entries, counts = (x.numpy() for x in fused_world.live_routing(man.point_ok, n))
    ref_rows, ref_bodies, offsets = reference_lists(live, n)
    assert int(n_rows.min()) > 32, "setup: an env within one live row a lane"
    for e in range(len(live)):
        assert rows[e, :n_rows[e]].tolist() == ref_rows[e]
        assert (rows[e, n_rows[e]:] == -1).all()
        for b in range(5 * n):
            lst = ref_bodies[e][b]
            assert counts[e, b] == len(lst)
            assert entries[e, offsets[b]:offsets[b] + len(lst)].tolist() == lst
    assert int(counts.sum()) == 2 * int(live.sum())


@pytest.mark.parametrize("n", WIDE)
def test_track_pass_at_wide_n_matches_jax_xla(n):
    case = make_case(n)
    tr, cars, post, visited, touched = case
    plain = [x.numpy() for x in track_engine.track_pass_plain(*port_inputs(case), n)]
    jtr = jcommon.Track(**{f.name: jnp.asarray(tr[f.name])
                           for f in dataclasses.fields(jcommon.Track)})
    jcars = jstate.CarState(**{f: jnp.asarray(cars[f]) for f in CAR_FIELDS})
    ref = jax.jit(jax.vmap(jenv._make_track_pass(n, "xla", False)))(
        jtr, jcars, jnp.asarray(post), jnp.asarray(visited), jnp.asarray(touched))
    assert_track_outputs_match([np.asarray(x) for x in ref], plain, f"plain vs JAX xla, N={n}")
    won, _, bonus, cnt, *_ = plain
    assert won.any() and cnt.sum() > 0
    # Car 1 of env 0 is the second visitor of car 0's fresh tiles.
    assert bonus[0, 1] < cnt[0, 1] * 1000.0 / tr["n_tiles"][0] - 1e-3
