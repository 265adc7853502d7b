"""The per-step track stage: wheel-tile SAT, visit rewards, nearest tile, on-grass.

Counterpart of the JAX package's ``physics/track_engine.py``. One function
of E envs computes, on the pre-solve pose (Box2D collides at the start of
world.Step),

- the wheel-rect vs tile SAT of ``overlap.wheel_tile_overlap`` -> the lagged
  friction mask ``wheel_on_road`` of the next step (cd:180-186);
- the FrictionDetector visit bookkeeping (mcr:110-120): first visits, the
  ``1 - past_visitors / N`` factor with the car-id tie-break, the per-car
  bonus and count;
- the render "touched" flattening, with the hull centre inside a tile
  standing in for hull contact (mcr:102-104);

and on the post-solve hull origin the nearest-tile heading (first argmin
over the centreline) and the on-grass flag (mcr:446-495).

``track_pass`` launches the hand-written CUDA kernel ``csrc/track_pass.cu``
on CUDA tensors; it visits only the tiles a car can touch, the candidates
of ``track_candidates``. It replaces both TPU kernels of the JAX module,
``_make_kernel`` / ``track_pass_batched`` (v1) and ``_make_kernel_v2`` /
``track_pass_batched_v2`` (v2), which compute the same outputs. On CPU
tensors it runs ``track_pass_plain``, the same function in PyTorch ops;
there is no fallback from one to the other. ``track_pass.launches`` counts
kernel launches, and ``track_pass_plain.cuda_calls`` counts calls of the
plain version on CUDA tensors, so a run can show that its main path went
through the kernel and never through the plain ops.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import config as C
from . import overlap
from .state import CarState, wheel_forward_side

KERNEL = "track_pass"

# fp32 operations of the work the function needs, from the arithmetic of
# the plain version: per (car, wheel, tile) the 6-axis SAT -- 2 wheel axes
# (4 projections of 3, 3 min, 3 max, 5 for the gap) and 4 tile axes (3
# projections of 3, support radius 5, gap 5, 1 max), the max and the margin
# compare; per (car, tile) 3 point-in-quad tests (4 edges of 7 and 2
# compares), d^2 (5 and the compare) and the visit bookkeeping (the
# division, the factor and its sum).
FLOPS_WHEEL_TILE = 2 * (4 * 3 + 3 + 3 + 5) + 4 * (3 * 3 + 5 + 5 + 1) + 2
FLOPS_POINT_IN_QUAD = 4 * 9
FLOPS_CAR_TILE = 3 * FLOPS_POINT_IN_QUAD + 6 + 4
FLOPS_NEAREST = 6                       # d^2 and the compare

# The seven outputs of the track pass, in order.
OUTPUT_NAMES = ("wheel_on_road", "visited", "bonus", "count", "tile_touched",
                "nearest_beta", "on_grass")


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
    if visited.device.type == "cuda":
        track_pass_plain.cuda_calls += 1
    return _track_pass(track, pre_cars, post_origin, visited, tile_touched, num_agents)


track_pass_plain.cuda_calls = 0


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


def plain_marks(track, pre_cars: CarState, post_origin: torch.Tensor) -> torch.Tensor:
    """(E, N, MT) bool: the tiles the plain track pass marks for each car --
    a wheel's SAT overlap, the pre-solve hull origin inside the road quad,
    the post-solve origin inside the road or the curb quad. The cull must
    keep each of them. Used by the tests and chip_smoke.py only."""
    return (overlap.wheel_tile_overlap(pre_cars, track).any(2)
            | overlap.point_in_quads_T(pre_cars.hull_origin, track.quad_T)
            | overlap.point_in_quads_T(post_origin, track.quad_T)
            | overlap.point_in_quads_T(post_origin, track.curb_quad_T))


def track_pass_culled_plain(track, pre_cars: CarState, post_origin: torch.Tensor,
                            visited: torch.Tensor, tile_touched: torch.Tensor,
                            num_agents: int):
    """What the kernel computes, in PyTorch ops: track_pass_plain with the
    pre-solve tests outside ``track_candidates`` and the post-solve
    origin's outside ``post_candidates`` false. It equals track_pass_plain
    wherever the cull keeps every marked tile (any packed track), and shows
    the cull's radii where it does not (``track_cases.cull_probes``). Used
    by the tests and chip_smoke.py only."""
    return _track_pass(track, pre_cars, post_origin, visited, tile_touched, num_agents,
                       track_candidates(track, pre_cars, post_origin),
                       post_candidates(track, post_origin))


def track_pass_work(E: int, N: int, MT: int, valid_tiles: int | None = None,
                    candidates: torch.Tensor | None = None,
                    near_post: torch.Tensor | None = None):
    """(bytes, fp32 operations) of one track pass over E envs of N cars and
    MT padded tiles: every input read once and every output written once,
    and the arithmetic of the valid tiles (``valid_tiles``, summed over
    envs; all E * MT when not given), which is what the data needs.

    With ``candidates`` and ``near_post`` (the (E, N, MT) bools of
    ``track_candidates`` and ``post_candidates``) it counts what the culled
    kernel needs: xy, valid and the masks over all tiles and the
    nearest-tile d^2 of every car and valid tile; the road tables of the
    tiles some car of the env may touch, with the SAT, the pre-solve
    point-in-quad test and the visit arithmetic of each (car, candidate)
    pair; and the curb quads of the tiles some car's post-solve origin may
    lie in, with the two post-solve point-in-quad tests of each (car, such
    tile) pair."""
    tiles = E * MT if valid_tiles is None else valid_tiles
    table_floats = 4 * 2 + 4 * 2 + 4 + 4 + 4 * 2 + 2 + 1    # quads, axes, lo, hi, curb, xy, beta
    per_tile = E * MT * (1 + 1 + N)                         # valid, touched, visited
    per_car = (E * 4                                        # n_tiles
               + E * N * 4 * (2 + 1) * 4                    # wheel_c, wheel_a
               + E * N * (2 + 1 + 2) * 4)                   # hull_c, hull_a, post_origin
    written = (E * N * 4                                    # wheel_on_road
               + E * N * MT + E * MT                        # visited', tile_touched'
               + E * N * (4 + 4 + 4 + 1))                   # bonus, count, beta, on_grass
    if candidates is None:
        read = per_tile + E * MT * 4 * table_floats + per_car
        flops = N * tiles * (4 * FLOPS_WHEEL_TILE + FLOPS_CAR_TILE)
        return read + written, flops
    if near_post is None:
        raise ValueError("track_pass_work: candidates need near_post")
    pairs, post_pairs = int(candidates.sum()), int(near_post.sum())
    cand_tiles = int(candidates.any(1).sum())
    post_tiles = int(near_post.any(1).sum())
    read = (per_tile + E * MT * 4 * 2                       # xy
            + cand_tiles * 4 * (table_floats - 3 - 8)       # road quads, axes, lo, hi
            + post_tiles * 4 * 8                            # curb quads
            + E * N * 4 + per_car)                          # beta at each car's nearest tile
    flops = (N * tiles * FLOPS_NEAREST
             + pairs * (4 * FLOPS_WHEEL_TILE + FLOPS_CAR_TILE - FLOPS_NEAREST
                        - 2 * FLOPS_POINT_IN_QUAD)
             + post_pairs * 2 * FLOPS_POINT_IN_QUAD)
    return read + written, flops


def _library():
    from .. import _cuda

    lib = _cuda.load(KERNEL)
    fn = lib.track_pass_launch
    if fn.argtypes is None:
        vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [vp] * 20 + [ci] * 3 + [cf] * 6 + [vp]
        fn.restype = ci
        lib.track_pass_error_string.argtypes = [ci]
        lib.track_pass_error_string.restype = ctypes.c_char_p
    return lib


# The kernel's shared memory (csrc/track_pass.cu): four envs a block, per
# tile its reach (4 bytes), visitor count (2: at most TRACK_MAX_CARS cars),
# list entry (2), touched flag and candidate flag, within the 48 KB a block
# gets without opting in.
TRACK_ENVS_PER_BLOCK = 4
TRACK_SMEM_PER_TILE = 10
TRACK_SMEM_LIMIT = 48 * 1024
TRACK_MAX_CARS = 2 ** 16 - 1


def track_smem_bytes(max_tiles: int) -> int:
    """Shared memory of one block of the track kernel at ``max_tiles``
    padded tiles (any number of cars up to TRACK_MAX_CARS): 15,360 bytes at
    384."""
    return TRACK_ENVS_PER_BLOCK * ((TRACK_SMEM_PER_TILE * max_tiles + 3) & ~3)


def _check(track, pre_cars: CarState, post_origin, visited, tile_touched,
           num_agents: int):
    """Shapes, dtypes, device and contiguity of the kernel's inputs; raises
    ValueError on anything it does not take (no silent copies): on more
    cars than its 16-bit visitor counts hold (TRACK_MAX_CARS), and on a tile
    count whose per-tile arrays do not fit its shared memory
    (:func:`track_smem_bytes`)."""
    E, N = pre_cars.hull_a.shape
    MT = track.beta.shape[-1]
    dev = visited.device
    if N != num_agents:
        raise ValueError(f"track_pass: {N} cars per env under num_agents={num_agents}")
    if N > TRACK_MAX_CARS:
        raise ValueError(f"track_pass: {N} cars per env; the kernel counts a tile's visitors "
                         f"in 16 bits, at most {TRACK_MAX_CARS} cars")
    if track_smem_bytes(MT) > TRACK_SMEM_LIMIT:
        most = TRACK_SMEM_LIMIT // (TRACK_ENVS_PER_BLOCK * TRACK_SMEM_PER_TILE)
        raise ValueError(f"track_pass: {MT} padded tiles need {track_smem_bytes(MT)} bytes of "
                         f"shared memory a block, more than the kernel's {TRACK_SMEM_LIMIT} "
                         f"(at most {most} tiles)")
    f32, b = torch.float32, torch.bool
    want = dict(
        quad_T=(track.quad_T, f32, (E, 4, 2, MT)),
        quad_ax_T=(track.quad_ax_T, f32, (E, 4, 2, MT)),
        quad_lo=(track.quad_lo, f32, (E, 4, MT)),
        quad_hi=(track.quad_hi, f32, (E, 4, MT)),
        curb_quad_T=(track.curb_quad_T, f32, (E, 4, 2, MT)),
        xy=(track.xy, f32, (E, MT, 2)),
        beta=(track.beta, f32, (E, MT)),
        valid=(track.valid, b, (E, MT)),
        n_tiles=(track.n_tiles, torch.int32, (E,)),
        visited=(visited, b, (E, N, MT)),
        tile_touched=(tile_touched, b, (E, MT)),
    )
    for name, (t, dtype, shape) in want.items():
        if (t.dtype != dtype or t.device != dev or tuple(t.shape) != shape
                or not t.is_contiguous()):
            raise ValueError(f"track_pass: {name} must be a contiguous {dtype} {shape} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device}"
                             f"{'' if t.is_contiguous() else ', not contiguous'}")
    for name, t, shape in (("wheel_c", pre_cars.wheel_c, (E, N, 4, 2)),
                           ("wheel_a", pre_cars.wheel_a, (E, N, 4)),
                           ("hull_c", pre_cars.hull_c, (E, N, 2)),
                           ("post_origin", post_origin, (E, N, 2))):
        if t.dtype != f32 or t.device != dev or tuple(t.shape) != shape:
            raise ValueError(f"track_pass: {name} must be float32 {shape} on {dev}, "
                             f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def pack_cars(pre_cars: CarState, post_origin: torch.Tensor):
    """The kernel's per-car inputs: wheels (E, N, 4, 6) = centre, forward and
    side unit vectors; origins (E, N, 4) = pre-solve and post-solve hull
    origin. The frames and origins come from the same torch ops as in the
    plain version, so both see the same bits."""
    forw, side = wheel_forward_side(pre_cars)
    wheels = torch.cat([pre_cars.wheel_c, forw, side], dim=-1)
    origins = torch.cat([pre_cars.hull_origin, post_origin], dim=-1)
    return wheels, origins


def launch(track, wheels: torch.Tensor, origins: torch.Tensor, visited: torch.Tensor,
           tile_touched: torch.Tensor):
    """Launch the kernel on checked inputs (``_check``) and the cars as
    ``pack_cars`` packs them, on the current stream; returns the seven
    outputs of ``track_pass_plain``. Counts the launch in
    ``track_pass.launches``."""
    E, N, MT = visited.shape
    dev = visited.device
    lib = _library()
    won = torch.empty((E, N, 4), dtype=torch.bool, device=dev)
    vis_out = torch.empty((E, N, MT), dtype=torch.bool, device=dev)
    bonus = torch.empty((E, N), dtype=torch.float32, device=dev)
    cnt = torch.empty((E, N), dtype=torch.int32, device=dev)
    tt_out = torch.empty((E, MT), dtype=torch.bool, device=dev)
    nbeta = torch.empty((E, N), dtype=torch.float32, device=dev)
    grass = torch.empty((E, N), dtype=torch.bool, device=dev)
    # Bool tensors cross as their uint8 bytes (0 or 1), without a copy.
    ptrs = [x.data_ptr() for x in (
        track.quad_T, track.quad_ax_T, track.quad_lo, track.quad_hi, track.curb_quad_T,
        track.xy, track.beta, track.valid.view(torch.uint8), track.n_tiles, wheels,
        origins, visited.view(torch.uint8), tile_touched.view(torch.uint8),
        won.view(torch.uint8), vis_out.view(torch.uint8), bonus, cnt,
        tt_out.view(torch.uint8), nbeta, grass.view(torch.uint8))]
    with torch.cuda.device(dev):      # the stream and the launch belong to dev
        rc = lib.track_pass_launch(
            *ptrs, E, N, MT, overlap.WHEEL_HX, overlap.WHEEL_HY, C.SENSOR_OVERLAP_MARGIN,
            REACH_BASE, WHEEL_CULL_EXTRA, ORIGIN_CULL_EXTRA,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        msg = lib.track_pass_error_string(rc).decode()
        raise RuntimeError(f"track_pass launch failed: {msg} ({rc})")
    track_pass.launches += 1
    return won, vis_out, bonus, cnt, tt_out, nbeta, grass


def track_pass(track, pre_cars: CarState, post_origin: torch.Tensor,
               visited: torch.Tensor, tile_touched: torch.Tensor, num_agents: int):
    """The track stage of E envs: the kernel on CUDA tensors,
    ``track_pass_plain`` on CPU tensors. Same arguments and results as
    ``track_pass_plain``."""
    dev = visited.device
    if dev.type == "cpu":
        return track_pass_plain(track, pre_cars, post_origin, visited, tile_touched,
                                num_agents)
    if dev.type != "cuda":
        raise ValueError(f"track_pass: unsupported device {dev}")
    _check(track, pre_cars, post_origin, visited, tile_touched, num_agents)
    return launch(track, *pack_cars(pre_cars, post_origin), visited, tile_touched)


track_pass.launches = 0
