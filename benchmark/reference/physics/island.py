"""The fused physics stage of a step in plain PyTorch.

Frozen copy of the plain half of ``multi_car_racing_tpu_torch/physics/
fused_world.py`` (commit 3d8d1d4): ``island_step_plain`` (tire model,
car-car Collide pass and the Gauss-Seidel island solve, the function that
the port's kernels ``csrc/joints_island.cu`` (K1) and
``csrc/contact_island.cu`` (K2) stand for) and ``near_flags``, K2's per-env
broadphase test, which the benchmark's K2 work counter reads.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from . import collide, shapes, tire, world
from .collide import ContactState
from .state import CarState


def island_step_plain(cars: CarState, wheel_on_road: torch.Tensor,
                      contact_state: ContactState,
                      velocity_iters: int = C.VELOCITY_ITERS,
                      position_iters: int = C.POSITION_ITERS):
    """tire_step -> [collide -> make_bundle ->] world_step in PyTorch ops.

    Returns (new CarState, skid (E, N, 4) bool, new ContactState); at one car
    per env the contact carry passes through unchanged."""
    n = cars.hull_a.shape[1]
    cars, force, motor, skid = tire.tire_step(cars, wheel_on_road)
    if n == 1:
        new_cars, _ = world.world_step(cars, force, motor,
                                       velocity_iters=velocity_iters,
                                       position_iters=position_iters)
        return new_cars, skid, contact_state
    man = collide.collide(cars, n)
    bundle = collide.make_bundle(man, contact_state, cars, n)
    new_cars, bundle = world.world_step(cars, force, motor,
                                        velocity_iters=velocity_iters,
                                        position_iters=position_iters,
                                        contacts=bundle)
    return new_cars, skid, collide.extract_state(bundle)


# ---------------------------------------------------------------------------
# Broadphase: the per-env flag K2 branches on.
# ---------------------------------------------------------------------------

# Local-frame AABB of the four hull fixtures relative to the hull COM (mid +
# half-extents), and the wheel's symmetric box. Disjoint world AABBs fattened
# by the slack guarantee b2CollidePolygons culls the pair (sep > totalRadius).
_HULL_FIXT = shapes.CAR_FIXTURE_BODY == 0
_hv = (shapes.CAR_FIXTURE_VERTS[_HULL_FIXT].reshape(-1, 2)
       - shapes.HULL_LOCAL_CENTER[None, :])
HULL_AABB_MID = tuple(float(v) for v in (_hv.min(0) + _hv.max(0)) / 2.0)
HULL_AABB_HALF = tuple(float(v) for v in (_hv.max(0) - _hv.min(0)) / 2.0)
_wv = shapes.CAR_FIXTURE_VERTS[~_HULL_FIXT].reshape(-1, 2)
WHEEL_AABB_HALF = tuple(float(v) for v in np.abs(_wv).max(0))
# Box2D's b2_aabbExtension. A slack of just the summed polygon skins is NOT
# enough for culling soundness: for vertex-vertex closest features the SAT
# max face separation can be as low as gap*cos(45 deg) for these right-angle
# boxes. 0.1 m >= sqrt(2) * totalRadius covers that with Box2D's own margin.
BP_SLACK = 0.1


def near_flags(cars: CarState) -> torch.Tensor:
    """Per-env broadphase: could ANY car pair of the env produce a contact?

    An AABB test per colliding fixture-body combination (hull-hull and
    hull-wheel both ways; wheel-wheel is masked out by Box2D category bits),
    fattened by ``BP_SLACK``: if the fattened AABBs of a pair are disjoint,
    b2CollidePolygons culls it and every contact sub-pass adds exact zeros
    for it. Returns (E,) bool. The plain version of the flag K2 computes for
    each env from the pre-solve poses."""
    n = cars.hull_a.shape[1]
    s, c = torch.sin(cars.hull_a), torch.cos(cars.hull_a)         # (E, N)
    ac, as_ = torch.abs(c), torch.abs(s)
    mid, half = HULL_AABB_MID, HULL_AABB_HALF
    hull_cx = cars.hull_c[..., 0] + c * mid[0] - s * mid[1]
    hull_cy = cars.hull_c[..., 1] + s * mid[0] + c * mid[1]
    hull_hx = ac * half[0] + as_ * half[1]
    hull_hy = as_ * half[0] + ac * half[1]
    ws, wc = torch.abs(torch.sin(cars.wheel_a)), torch.abs(torch.cos(cars.wheel_a))
    wx, wy = cars.wheel_c[..., 0], cars.wheel_c[..., 1]          # (E, N, 4)
    whx = wc * WHEEL_AABB_HALF[0] + ws * WHEEL_AABB_HALF[1]
    why = ws * WHEEL_AABB_HALF[0] + wc * WHEEL_AABB_HALF[1]

    def overlap(ax, ay, ahx, ahy, bx, by, bhx, bhy):
        return ((torch.abs(ax - bx) <= ahx + bhx + BP_SLACK)
                & (torch.abs(ay - by) <= ahy + bhy + BP_SLACK))

    pairs = collide.car_pairs(n)
    if not pairs:
        return torch.zeros_like(cars.hull_a[:, 0], dtype=torch.bool)
    a, b = (torch.as_tensor(x, device=cars.hull_a.device) for x in zip(*pairs))
    hull = (hull_cx, hull_cy, hull_hx, hull_hy)                     # (E, N) each
    wheel = (wx, wy, whx, why)                                      # (E, N, 4) each
    ha = [x[:, a, None] for x in hull]                              # (E, P, 1)
    hb = [x[:, b, None] for x in hull]
    wa = [x[:, a] for x in wheel]                                   # (E, P, 4)
    wb = [x[:, b] for x in wheel]
    hit = overlap(*ha, *hb)[..., 0] | overlap(*ha, *wb).any(-1) | overlap(*wa, *hb).any(-1)
    return hit.any(-1)
