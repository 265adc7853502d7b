"""K4/K5's cull (csrc/track_pass.cu, pass A) in plain torch, on the CPU:
``track_engine.track_candidates`` must keep every tile that the plain track
pass marks for a car, so that the kernel's pass B, which visits the
candidates only, gives the plain pass's outputs.

Inputs: host tracks of seeds 0-7 (one env each), the spawn poses of N = 1,
2 and 4 cars, and ``track_cases.cull_cases`` (from a numpy seed): hull
origins on the road and up to 1 m past the kerb, across the start seam, on
a kerb quad, 30 m off the road, where the loop comes nearest to itself, and
wheels on the road with both origins 1 km away. ``track_cases.cull_probes``
(centreline points moved off the quads) show that the card's comparison
with ``track_pass_culled_plain`` would see a cull radius other than the
plain predicate's. Bars (tests/test_track_engine.py's): masks, counts and
nearest_beta equal, bonus within 2e-5. No JAX."""

import math

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, config as C, env as penv, seeding
from multi_car_racing_tpu_torch.physics import track_cases, track_engine
from multi_car_racing_tpu_torch.track import host
from multi_car_racing_tpu_torch.track.common import pack_track_arrays, track_from_arrays
from multi_car_racing_tpu_torch.util import tree_map
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEEDS = tuple(range(8))
MT = 384
BONUS_TOL = 2e-5


def _arrays():
    out = []
    for s in SEEDS:
        pts, border, _ = host.generate_track(seeding.np_random(s)[0])
        out.append(pack_track_arrays(pts, border, MT))
    return out


ARRAYS = _arrays()
TRACK = track_from_arrays(ARRAYS, "cpu")


def _spawn(n: int):
    """The spawn tick's cars of n per env on TRACK (one env per seed)."""
    cfg = EnvConfig(num_agents=n)
    _, orders, dirs = penv.draw_episodes(cfg, len(SEEDS), len(SEEDS),
                                         torch.Generator().manual_seed(n))
    sp = penv.spawn_state(cfg, TRACK, orders, dirs)
    rng = np.random.RandomState(n)
    visited = torch.as_tensor(rng.rand(len(SEEDS), n, MT) < 0.3) & TRACK.valid[:, None]
    touched = torch.as_tensor(rng.rand(len(SEEDS), MT) < 0.2)
    post = sp.cars.hull_origin + torch.as_tensor(rng.normal(0, 0.3, (len(SEEDS), n, 2)),
                                                 dtype=torch.float32)
    return sp.cars, post, visited, touched


def _cases():
    """(label, (pre-solve cars, post-solve origin, visited, tile_touched), n)."""
    out = []
    for n in (1, 2, 4):
        out.append((f"spawn, N={n}", _spawn(n), n))
        out += [(f"{name}, N={n}", args, n)
                for name, args in track_cases.cull_cases(TRACK, n).items()]
    return out


CASES = _cases()
IDS = [c[0] for c in CASES]


@pytest.mark.parametrize("seed", SEEDS)
def test_every_vertex_lies_within_reach(seed):
    """Every road vertex, and every curb vertex of a tile with a curb, lies
    within reach_t of xy_t, tile 0 (which spans the last point and the
    first) included; padding tiles have reach 0 and all their vertices at
    xy_t."""
    a = ARRAYS[seed]
    T = int(a["n_tiles"])
    reach = track_engine.tile_reach(TRACK)[seed].double().numpy()
    xy = a["xy"].astype(np.float64)
    road = np.linalg.norm(a["quad"].astype(np.float64) - xy[:, None], axis=-1)   # (MT, 4)
    curb = np.linalg.norm(a["curb_quad"].astype(np.float64) - xy[:, None], axis=-1)
    assert (road[:T] <= reach[:T, None]).all()
    assert (curb[:T][a["has_curb"][:T]] <= reach[:T, None][a["has_curb"][:T]]).all()
    assert a["has_curb"][:T].any() and road[0].max() > C.TRACK_WIDTH
    # tile 0's far vertices come from the last centreline point
    step0 = np.linalg.norm(xy[0] - xy[T - 1])
    assert math.isclose(reach[0], step0 + C.TRACK_WIDTH + C.BORDER, rel_tol=1e-6)
    assert (reach[T:] == 0).all() and (road[T:] == 0).all() and (curb[T:] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_candidates_keep_every_tile_the_plain_pass_marks(case):
    """A wheel's SAT overlap, the pre-solve origin inside the road quad or
    the post-solve origin inside the road or curb quad: each such (car,
    tile) is a candidate."""
    label, (pre, post, _, _), _ = case
    cand = track_engine.track_candidates(TRACK, pre, post)
    marks = track_engine.plain_marks(TRACK, pre, post)
    assert not (marks & ~cand).any(), f"{label}: {int((marks & ~cand).sum())} marked tiles culled"
    if not label.startswith("off-road"):
        assert marks.any(), label       # the case touches the track at all


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_pass_on_candidates_equals_the_full_plain_pass(case):
    label, (pre, post, visited, touched), n = case
    full = track_engine.track_pass_plain(TRACK, pre, post, visited, touched, n)
    culled = track_engine.track_pass_culled_plain(TRACK, pre, post, visited, touched, n)
    assert _within_bars(full, culled), label


def _within_bars(a, b) -> bool:
    return all(float((x - y).abs().max()) <= BONUS_TOL if name == "bonus" else torch.equal(x, y)
               for name, x, y in zip(track_engine.OUTPUT_NAMES, a, b))


@pytest.mark.parametrize("n", (1, 2, 4))
def test_wheels_only_case_rests_on_the_wheel_term(n):
    """In 'wheels-only' the plain pass marks tiles (the wheels' overlaps),
    and the cull without its wheel term keeps none of them: only the wheel
    term can carry the marks there."""
    pre, post, _, _ = track_cases.cull_cases(TRACK, n)["wheels-only"]
    marks = track_engine.plain_marks(TRACK, pre, post)
    assert marks.any()
    no_wheels = pre.replace(wheel_c=pre.wheel_c + track_cases.LIFT_M)
    assert not (marks & track_engine.track_candidates(TRACK, no_wheels, post)).any()
    assert not (marks & ~track_engine.track_candidates(TRACK, pre, post)).any()


PROBE_TRACK = tree_map(lambda x: x.repeat_interleave(32, 0), TRACK)     # 256 envs


@pytest.mark.parametrize("n", (1, 2, 4))
@pytest.mark.parametrize("probe,radius", [("probe, wheels only", "WHEEL_CULL_EXTRA"),
                                          ("probe, origins only", "ORIGIN_CULL_EXTRA")])
def test_probes_tell_the_cull_radii_apart(n, probe, radius, monkeypatch):
    """On each probe the culled plain pass (what the kernel must equal on
    the card) differs from the full plain pass, and from itself with the
    probed radius's extra set to 0: a kernel that added no extra there
    would fail the card's comparison."""
    args = track_cases.cull_probes(PROBE_TRACK, n)[probe] + (n,)
    culled = track_engine.track_pass_culled_plain(*args)
    assert not _within_bars(culled, track_engine.track_pass_plain(*args))
    monkeypatch.setattr(track_engine, radius, 0.0)
    assert not _within_bars(culled, track_engine.track_pass_culled_plain(*args))


def test_candidates_per_car_stay_few():
    """The cull's point: a handful of the 384 tiles per car. The mean over
    every case stays under 40; a car on the road keeps at least the tiles
    its wheels overlap."""
    counts = [track_engine.track_candidates(TRACK, pre, post).sum(-1).float()
              for _, (pre, post, _, _), _ in CASES]
    mean = float(torch.cat([c.flatten() for c in counts]).mean())
    assert 1.0 < mean < 40.0, mean
    spawn = counts[0]
    assert (spawn >= 4).all() and (spawn <= 12).all(), spawn


def test_work_with_candidates_counts_the_culled_tables():
    """track_pass_work's culled count: xy, valid and the masks of every
    tile, the road tables of candidate tiles only, the curb quads (and the
    post-solve origin's two point-in-quad tests) only where that origin is
    near; fewer bytes and operations than the un-culled count on the same
    shape."""
    pre, post, _, _ = _spawn(2)
    cand = track_engine.track_candidates(TRACK, pre, post)
    near = track_engine.post_candidates(TRACK, post)
    E, N = len(SEEDS), 2
    full_b, full_f = track_engine.track_pass_work(E, N, MT)
    cull_b, cull_f = track_engine.track_pass_work(E, N, MT, candidates=cand, near_post=near)
    assert not (near & ~cand).any()
    tiles, post_tiles = int(cand.any(1).sum()), int(near.any(1).sum())
    assert 0 < post_tiles < tiles
    assert cull_b == (full_b - (E * MT - tiles) * 4 * 32 - E * MT * 4 + E * N * 4
                      - (tiles - post_tiles) * 4 * 8)
    assert cull_f < full_f / 10
    none = torch.zeros_like(cand)
    none_b, _ = track_engine.track_pass_work(E, N, MT, candidates=none, near_post=none)
    assert none_b == cull_b - tiles * 4 * 24 - post_tiles * 4 * 8
    _, all_post_f = track_engine.track_pass_work(E, N, MT, candidates=cand, near_post=cand)
    assert all_post_f - cull_f == (int(cand.sum()) - int(near.sum())) * 2 * 4 * 9
