"""Sensor overlap: wheel rects vs track-tile quads (SAT), batched over envs.

Port of the two hot-path tests of the JAX package's ``physics/overlap.py``
(``wheel_tile_overlap`` and ``point_in_quads_T``). They replace Box2D's
broadphase + sensor Begin/EndContact events (mcr:84-123) with a dense
separating-axis test over every padded tile. "Touching" in Box2D is GJK
distance below the summed polygon skins (2 * b2_polygonRadius = 0.02); the
SAT max-axis separation equals that distance except in corner-corner
configurations (where it is a lower bound), a documented divergence.
"""

from __future__ import annotations

import torch

from .. import config as C
from .state import CarState, wheel_forward_side

WHEEL_HX = float(C.WHEEL_W * C.SIZE)   # rect half-width along local x (side)
WHEEL_HY = float(C.WHEEL_R * C.SIZE)   # rect half-height along local y (forw)


def wheel_tile_overlap(
    cars: CarState, track, margin: float = C.SENSOR_OVERLAP_MARGIN
) -> torch.Tensor:
    """SAT overlap of each wheel rect against every tile quad:
    (E, N, 4, MT) bool.

    Wheel rects are oriented boxes: 2 unique face axes + analytic support
    radius, so the full SAT needs 6 axes instead of 8.
    """
    forw, side = wheel_forward_side(cars)              # (E, N, 4, 2)
    c = cars.wheel_c                                   # (E, N, 4, 2)
    qx = track.quad_T[:, :, 0][:, None, None]          # (E, 1, 1, 4v, MT)
    qy = track.quad_T[:, :, 1][:, None, None]

    sep = None
    # --- wheel's own axes (side: half-extent HX, forw: HY).
    for ax, h in ((side, WHEEL_HX), (forw, WHEEL_HY)):
        axx, axy = ax[..., 0:1], ax[..., 1:2]          # (E, N, 4, 1)
        cp = c[..., 0:1] * axx + c[..., 1:2] * axy     # (E, N, 4, 1)
        lo_b = hi_b = None
        for v in range(4):
            p = axx * qx[..., v, :] + axy * qy[..., v, :]   # (E, N, 4, MT)
            lo_b = p if lo_b is None else torch.minimum(lo_b, p)
            hi_b = p if hi_b is None else torch.maximum(hi_b, p)
        g = torch.maximum(lo_b - (cp + h), (cp - h) - hi_b)
        sep = g if sep is None else torch.maximum(sep, g)

    # --- tile's 4 edge normals with precomputed own-interval.
    for a in range(4):
        axx = track.quad_ax_T[:, a, 0][:, None, None]  # (E, 1, 1, MT)
        axy = track.quad_ax_T[:, a, 1][:, None, None]
        cp = c[..., 0:1] * axx + c[..., 1:2] * axy     # (E, N, 4, MT)
        sp = side[..., 0:1] * axx + side[..., 1:2] * axy
        fp = forw[..., 0:1] * axx + forw[..., 1:2] * axy
        r = WHEEL_HX * torch.abs(sp) + WHEEL_HY * torch.abs(fp)
        lo = track.quad_lo[:, a][:, None, None]
        hi = track.quad_hi[:, a][:, None, None]
        g = torch.maximum(lo - (cp + r), (cp - r) - hi)
        sep = torch.maximum(sep, g)

    return sep < margin


def point_in_quads_T(points: torch.Tensor, quad_T: torch.Tensor) -> torch.Tensor:
    """Points (E, N, 2) strictly inside quads given tiles-last verts
    (E, 4, 2, MT) -> (E, N, MT) bool. Interior only, either winding
    (shapely's ``Point.within`` on convex quads, mcr:469-471)."""
    px, py = points[..., 0:1], points[..., 1:2]        # (E, N, 1)
    pos = neg = None
    for v in range(4):
        ax_, ay_ = quad_T[:, v, 0][:, None], quad_T[:, v, 1][:, None]   # (E, 1, MT)
        w = (v + 1) % 4
        bx_, by_ = quad_T[:, w, 0][:, None], quad_T[:, w, 1][:, None]
        cr = (bx_ - ax_) * (py - ay_) - (by_ - ay_) * (px - ax_)       # (E, N, MT)
        p, q = cr > 0, cr < 0
        pos = p if pos is None else pos & p
        neg = q if neg is None else neg & q
    return pos | neg
