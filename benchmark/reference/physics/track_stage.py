"""The per-step track stage in plain PyTorch: wheel-tile SAT, visit rewards,
nearest tile, on-grass.

Frozen copy of the plain half of ``multi_car_racing_tpu_torch/physics/
track_engine.py`` (commit 3d8d1d4): ``track_pass_plain`` and the functions
it calls, which the port's kernel ``csrc/track_pass.cu`` (K4/K5) stands for,
and the cull's radii (``track_candidates``, ``post_candidates``) that the
benchmark's K4/K5 work counter reads. On the pre-solve pose it computes the
wheel-rect vs tile SAT (the lagged friction mask of the next step), the
FrictionDetector visit bookkeeping and the render "touched" flattening; on
the post-solve hull origin the nearest-tile heading and the on-grass flag.
"""

from __future__ import annotations

import math

import torch

from .. import config as C
from . import overlap
from .state import CarState

def _contact_pass(cars: CarState, track, cand: torch.Tensor | None = None):
    """The Collide() equivalent on the given (pre-solve) pose: returns
    (wheel_on_road (E,N,4), car_tile (E,N,MT), touched (E,MT)), with every
    (car, tile) test outside ``cand`` (E,N,MT) false when it is given.

    The render-only "touched" flag includes hull contact approximated by the
    hull *center* being inside a tile."""
    wheel_ov = overlap.wheel_tile_overlap(cars, track)        # (E, N, 4, MT)
    hull_in = overlap.point_in_quads_T(cars.hull_origin, track.quad_T)
    if cand is not None:
        wheel_ov, hull_in = wheel_ov & cand[:, :, None], hull_in & cand
    wheel_on_road = wheel_ov.any(-1)
    car_tile = wheel_ov.any(2)                                # (E, N, MT)
    touched = (car_tile | hull_in).any(1)
    return wheel_on_road, car_tile, touched


def _visit_rewards(track, visited: torch.Tensor, car_tile: torch.Tensor,
                   num_agents: int):
    """FrictionDetector begin-contact bookkeeping (mcr:110-120):
    reward += (1 - past_visitors / num_agents) * 1000 / len(track) for each
    first visit, with car-id ordering for same-step ties (lowest id counts as
    the earlier visitor). Returns (bonus (E,N), new visited, count (E,N))."""
    f32 = track.xy.dtype
    new = car_tile & ~visited & track.valid[:, None, :]        # (E, N, MT)
    prev_count = visited.sum(dim=1, dtype=torch.int32)        # (E, MT)
    new_i = new.to(torch.int32)
    rank = torch.cumsum(new_i, dim=1, dtype=torch.int32) - new_i   # exclusive
    past = prev_count[:, None, :] + rank
    factor = 1.0 - past.to(f32) / num_agents
    tile_bonus = 1000.0 / track.n_tiles.to(f32)               # (E,)
    bonus = torch.sum(new.to(f32) * factor, dim=2) * tile_bonus[:, None]
    cnt = new.sum(dim=2, dtype=torch.int32)
    return bonus, visited | new, cnt


def nearest_tile(track, points: torch.Tensor) -> torch.Tensor:
    """Index of the valid centreline point nearest to each of ``points``
    (E, N, 2): (E, N) int64, the first one on a tie (``jnp.argmin``'s)."""
    d2 = torch.sum(torch.square(points[:, :, None, :] - track.xy[:, None]), dim=-1)
    d2 = torch.where(track.valid[:, None, :], d2, torch.full_like(d2, math.inf))
    return torch.argmin(d2, dim=2)


def track_pass_plain(track, pre_cars: CarState, post_origin: torch.Tensor,
                     visited: torch.Tensor, tile_touched: torch.Tensor,
                     num_agents: int):
    """The track stage in PyTorch ops (the JAX package's XLA path).

    Returns (wheel_on_road (E,N,4) bool, visited' (E,N,MT) bool, bonus (E,N)
    f32, count (E,N) int32, tile_touched' (E,MT) bool, nearest_beta (E,N)
    f32, on_grass (E,N) bool), the contract of the JAX
    ``track_pass_batched``."""
    return _track_pass(track, pre_cars, post_origin, visited, tile_touched, num_agents)



def _track_pass(track, pre_cars, post_origin, visited, tile_touched, num_agents,
                cand=None, near_post=None):
    """track_pass_plain's outputs; with ``cand`` and ``near_post`` (E,N,MT),
    the pre-solve tests of a (car, tile) outside ``cand`` and the post-solve
    origin's outside ``near_post`` are false."""
    wheel_on_road, car_tile, touched = _contact_pass(pre_cars, track, cand)
    bonus, new_visited, cnt = _visit_rewards(track, visited, car_tile, num_agents)

    nearest_beta = torch.gather(track.beta, 1, nearest_tile(track, post_origin))
    in_road = overlap.point_in_quads_T(post_origin, track.quad_T)
    in_curb = overlap.point_in_quads_T(post_origin, track.curb_quad_T)
    if near_post is not None:
        in_road, in_curb = in_road & near_post, in_curb & near_post
    on_grass = ~(in_road.any(-1) | in_curb.any(-1))
    return (wheel_on_road, new_visited, bonus, cnt, tile_touched | touched,
            nearest_beta, on_grass)

# The kernel's cull (csrc/track_pass.cu, pass A). Tile t spans centreline
# points t and t - 1 (t - 1 wrapping to n_tiles - 1 at t = 0), its road
# vertices at TRACK_WIDTH and its curb vertices at up to TRACK_WIDTH + BORDER
# from them (track/common.py), so every vertex lies within reach_t =
# |xy_t - xy_{t-1}| + TRACK_WIDTH + BORDER of xy_t. A padding tile's vertices
# and centreline point are all at _PAD_FAR: reach 0. A wheel whose SAT
# separation from tile t is below the margin has its centre within
# reach_t + |(hx, hy)| + margin of xy_t, up to the SAT's corner-corner
# excess (a fraction of a metre at the tiles' near-square corners), which
# the triangle bound absorbs: the radial offsets stand near-perpendicular to
# the centreline step, so the farthest vertex lies 2.5 m or more inside
# reach_t (host tracks of seeds 0-7). CULL_SLACK is far above the float32
# rounding of the distances (~1e-4 m). tests/test_torch_track_cull.py holds
# the cull sound on host tracks.
CULL_SLACK = 0.5
WHEEL_CULL_EXTRA = float(torch.tensor(
    math.hypot(overlap.WHEEL_HX, overlap.WHEEL_HY) + C.SENSOR_OVERLAP_MARGIN + CULL_SLACK,
    dtype=torch.float32))
ORIGIN_CULL_EXTRA = float(torch.tensor(CULL_SLACK, dtype=torch.float32))
REACH_BASE = float(torch.tensor(C.TRACK_WIDTH + C.BORDER, dtype=torch.float32))


def tile_reach(track) -> torch.Tensor:
    """reach_t (E, MT) f32: the radius about xy_t that holds every road and
    curb vertex of tile t; 0 for padding tiles."""
    E, MT = track.valid.shape
    t = torch.arange(MT, device=track.xy.device).expand(E, MT)
    prev = torch.where(t == 0, (track.n_tiles.long() - 1)[:, None], t - 1)
    step = track.xy - torch.gather(track.xy, 1, prev[..., None].expand(E, MT, 2))
    dx, dy = step[..., 0], step[..., 1]
    reach = torch.sqrt(dx * dx + dy * dy) + REACH_BASE
    return torch.where(track.valid, reach, torch.zeros_like(reach))


def _within(points: torch.Tensor, xy: torch.Tensor, radius: torch.Tensor) -> torch.Tensor:
    """|points - xy|^2 <= radius^2 per (env, car, tile), each operation
    rounded on its own as in the kernel: points (E, N, 2), xy (E, MT, 2),
    radius (E, MT)."""
    dx = points[:, :, None, 0] - xy[:, None, :, 0]
    dy = points[:, :, None, 1] - xy[:, None, :, 1]
    return dx * dx + dy * dy <= (radius * radius)[:, None]


def post_candidates(track, post_origin: torch.Tensor) -> torch.Tensor:
    """The candidates where the kernel tests the post-solve origin (the
    road and curb point-in-quad tests, the only reads of the curb table):
    (E, N, MT) bool, the post-solve origin within reach_t +
    ORIGIN_CULL_EXTRA of xy_t (the kernel's ``post_in``). Used by the tests
    and chip_smoke.py only."""
    return _within(post_origin, track.xy, tile_reach(track) + ORIGIN_CULL_EXTRA)


def track_candidates(track, pre_cars: CarState, post_origin: torch.Tensor) -> torch.Tensor:
    """The tiles the kernel's pass B visits for each car: (E, N, MT) bool,
    tile t a candidate for car n when a wheel centre lies within
    reach_t + WHEEL_CULL_EXTRA of xy_t, or the pre-solve or post-solve hull
    origin within reach_t + ORIGIN_CULL_EXTRA. The kernel's pass-A formula
    in float32; a tile outside it keeps the masks it came in with. Used by
    the tests and chip_smoke.py only."""
    reach = tile_reach(track)
    wheel_r = reach + WHEEL_CULL_EXTRA
    cand = _within(pre_cars.hull_origin, track.xy, reach + ORIGIN_CULL_EXTRA)
    cand = cand | post_candidates(track, post_origin)
    for k in range(4):
        cand = cand | _within(pre_cars.wheel_c[:, :, k], track.xy, wheel_r)
    return cand
