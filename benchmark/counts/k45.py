"""Work of K4/K5 (``csrc/track_pass.cu``, the track stage) on one step's data.

Frozen copy of ``track_pass_work`` of ``multi_car_racing_tpu_torch/physics/
track_engine.py`` (commit 3d8d1d4) in its culled form, with the cull's
radii from the benchmark's plain reference (``reference/physics/
track_stage.track_candidates`` and ``post_candidates``): xy, valid and the
masks over all tiles and the nearest-tile d^2 of every car and valid tile;
the road tables of the tiles some car of the env may touch, with the SAT,
the pre-solve point-in-quad test and the visit arithmetic of each (car,
candidate) pair; and the curb quads of the tiles some car's post-solve
origin may lie in, with the two post-solve point-in-quad tests of each.
Every input is read once and every output written once.

fp32 operations, from the arithmetic of the plain version: per (car, wheel,
tile) the 6-axis SAT -- 2 wheel axes (4 projections of 3, 3 min, 3 max, 5
for the gap) and 4 tile axes (3 projections of 3, support radius 5, gap 5,
1 max), the max and the margin compare; per (car, tile) 3 point-in-quad
tests (4 edges of 7 and 2 compares), d^2 (5 and the compare) and the visit
bookkeeping (the division, the factor and its sum).
"""

from benchmark.reference.physics import track_stage

WHEN = "step"
KERNELS = ("track_pass_kernel",)

FLOPS_WHEEL_TILE = 2 * (4 * 3 + 3 + 3 + 5) + 4 * (3 * 3 + 5 + 5 + 1) + 2
FLOPS_POINT_IN_QUAD = 4 * 9
FLOPS_CAR_TILE = 3 * FLOPS_POINT_IN_QUAD + 6 + 4
FLOPS_NEAREST = 6                       # d^2 and the compare


def track_pass_work(E: int, N: int, MT: int, valid_tiles: int, candidates, near_post):
    """(bytes, fp32 operations) of one culled track pass over E envs of N
    cars and MT padded tiles, ``candidates`` and ``near_post`` the (E, N, MT)
    bools of ``track_candidates`` and ``post_candidates``."""
    table_floats = 4 * 2 + 4 * 2 + 4 + 4 + 4 * 2 + 2 + 1    # quads, axes, lo, hi, curb, xy, beta
    per_tile = E * MT * (1 + 1 + N)                         # valid, touched, visited
    per_car = (E * 4                                        # n_tiles
               + E * N * 4 * (2 + 1) * 4                    # wheel_c, wheel_a
               + E * N * (2 + 1 + 2) * 4)                   # hull_c, hull_a, post_origin
    written = (E * N * 4                                    # wheel_on_road
               + E * N * MT + E * MT                        # visited', tile_touched'
               + E * N * (4 + 4 + 4 + 1))                   # bonus, count, beta, on_grass
    pairs, post_pairs = int(candidates.sum()), int(near_post.sum())
    cand_tiles = int(candidates.any(1).sum())
    post_tiles = int(near_post.any(1).sum())
    read = (per_tile + E * MT * 4 * 2                       # xy
            + cand_tiles * 4 * (table_floats - 3 - 8)       # road quads, axes, lo, hi
            + post_tiles * 4 * 8                            # curb quads
            + E * N * 4 + per_car)                          # beta at each car's nearest tile
    flops = (N * valid_tiles * FLOPS_NEAREST
             + pairs * (4 * FLOPS_WHEEL_TILE + FLOPS_CAR_TILE - FLOPS_NEAREST
                        - 2 * FLOPS_POINT_IN_QUAD)
             + post_pairs * 2 * FLOPS_POINT_IN_QUAD)
    return read + written, flops


def work(step) -> tuple[int, int]:
    """(fp32 operations, bytes) of one step's track pass over every env."""
    track, pre, post_origin = step.pre.track, step.pre.cars, step.post.cars.hull_origin
    E, N = pre.hull_a.shape
    nbytes, flops = track_pass_work(
        E, N, track.max_tiles, int(track.n_tiles.sum()),
        track_stage.track_candidates(track, pre, post_origin),
        track_stage.post_candidates(track, post_origin))
    return flops, nbytes
