"""Work of K2 (``csrc/contact_island.cu``, the island with car-car contacts)
on one step's data.

Frozen copy of ``contact_island_flops``, ``contact_island_work`` and
``contact_island_bytes`` of ``multi_car_racing_tpu_torch/physics/
fused_world.py`` (commit 3d8d1d4), evaluated with the benchmark's plain
reference (``reference/physics``): K1's chain for every car, plus every
env's broadphase; in a near env the SAT of every manifold row but the world
polygons once per fixture; the clipping of each row whose manifold is live;
and the solve of each live contact point and of each body a live point
touches. Only what the step's data needs is counted, as for K1 (a division,
square root, sine or cosine counts 8).
"""

import torch

from benchmark.counts import k1
from benchmark.reference import config as C
from benchmark.reference.physics import collide
from benchmark.reference.physics.island import near_flags

WHEN = "step"
KERNELS = ("far_pass_kernel", "near_pass_kernel")

FLOPS_BROADPHASE_CAR = 136      # every env, per car: 5 boxes (5 sin/cos pairs)
FLOPS_BROADPHASE_PAIR = 90      # ... per car pair: 9 box-overlap tests
FLOPS_BODY_FRAME = 24           # near env, per body: sin/cos and fixture origin
FLOPS_FIXTURE_WORLD = 112       # ... per fixture: 8 world vertices and normals
FLOPS_SAT_ROW = 580             # ... per row: 2 max-separation passes, flip
FLOPS_CLIP_ROW = 313            # live row: reference/incident selects 172, clipping 141
FLOPS_POINT_BUNDLE = 52         # live point: lever arms, normal and tangent masses
FLOPS_POINT_WARM = 18           # ... warm start: impulse, torques, the 2 body sums
FLOPS_POINT_VEL = 34 + 32       # ... per velocity iteration: friction, then normal
FLOPS_POINT_POS = 30            # ... per position iteration
FLOPS_BODY_UPDATE = 9           # a body that a live point touches, per sub-pass


def contact_island_flops(n_cars: int, n_limit_joints: int, num_cars: int,
                         n_near_envs: int, n_live_rows: int, n_live_points: int,
                         n_touched_bodies: int, velocity_iters: int,
                         position_iters: int) -> int:
    """fp32 operations of one K2 call on this call's data. Live points and
    the touched bodies take part in one warm-start sub-pass, two sub-passes
    (friction, normal) per contact velocity iteration and one per contact
    position iteration."""
    n_envs = n_cars // num_cars
    pairs = len(collide.car_pairs(num_cars))
    k_vel = min(C.CONTACT_VELOCITY_ITERS, velocity_iters)
    k_pos = min(C.CONTACT_POSITION_ITERS, position_iters)
    return (k1.island_flops(n_cars, n_limit_joints, velocity_iters, position_iters)
            + n_envs * (num_cars * FLOPS_BROADPHASE_CAR + pairs * FLOPS_BROADPHASE_PAIR)
            + n_near_envs * num_cars * (5 * FLOPS_BODY_FRAME + 8 * FLOPS_FIXTURE_WORLD)
            + n_near_envs * pairs * collide.M_PER_PAIR * FLOPS_SAT_ROW
            + n_live_rows * FLOPS_CLIP_ROW
            + n_live_points * (FLOPS_POINT_BUNDLE + FLOPS_POINT_WARM
                               + k_vel * FLOPS_POINT_VEL + k_pos * FLOPS_POINT_POS)
            + n_touched_bodies * FLOPS_BODY_UPDATE * (1 + 2 * k_vel + k_pos))


def contact_island_bytes(n_cars: int, num_cars: int) -> int:
    """K1's car rows, plus the contact carry (4 impulse floats and an int32
    id per manifold row) read once and written once."""
    n_envs = n_cars // num_cars
    rows = len(collide.car_pairs(num_cars)) * collide.M_PER_PAIR
    return k1.island_bytes(n_cars) + n_envs * rows * 4 * (4 + 1) * 2


def contact_work(cars) -> dict:
    """Near envs, manifold rows with a live point, live contact points, and
    for each point index the bodies its live points touch (summed over envs
    and point indices), of pre-solve cars (two or more per env)."""
    n = cars.hull_a.shape[1]
    near = near_flags(cars)
    ok = collide.collide(cars, n).point_ok & near[:, None, None]    # (E, MM, 2)
    _, rows_a, rows_b, *_ = collide.tables(n)
    live = ok.transpose(1, 2).to(torch.int32)                       # (E, 2, MM)
    touches = torch.zeros((*live.shape[:2], 5 * n), dtype=torch.int32, device=live.device)
    for rows in (rows_a, rows_b):
        touches.index_add_(2, torch.as_tensor(rows, device=live.device), live)
    return dict(n_near_envs=int(near.sum()), n_live_rows=int(ok.any(-1).sum()),
                n_live_points=int(ok.sum()), n_touched_bodies=int((touches > 0).sum()))


def work(step) -> tuple[int, int]:
    """(fp32 operations, bytes) of one step's island over every car."""
    cfg, cars = step.cfg, step.pre.cars
    n_cars, n = cars.hull_a.numel(), cars.hull_a.shape[1]
    flops = contact_island_flops(n_cars, k1.limit_joints(step.post), n, **contact_work(cars),
                                 velocity_iters=cfg.velocity_iters,
                                 position_iters=cfg.position_iters)
    return flops, contact_island_bytes(n_cars, n)
