# Frozen copy of multi_car_racing_tpu_torch/physics/overlap.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Sensor overlap: car fixtures vs track-tile quads (SAT), batched over envs.

Port of the JAX package's ``physics/overlap.py``: the two hot-path tests
(``wheel_tile_overlap`` and ``point_in_quads_T``) and the full fixture SAT
(``car_fixture_world_geometry`` + ``fixtures_vs_quads``) that
``EnvConfig.exact_hull_touch`` uses for the tiles' touched flag. They replace Box2D's
broadphase + sensor Begin/EndContact events (mcr:84-123) with a dense
separating-axis test over every padded tile. "Touching" in Box2D is GJK
distance below the summed polygon skins (2 * b2_polygonRadius = 0.02); the
SAT max-axis separation equals that distance except in corner-corner
configurations (where it is a lower bound), a documented divergence.
"""

from __future__ import annotations

import torch

from .. import config as C
from . import shapes
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


def car_fixture_world_geometry(cars: CarState):
    """World-space fixture polygons of each car.

    Returns (verts (E, N, 8, 8, 2), normals (E, N, 8, 8, 2)): fixtures 0-3
    are the hull polygons (in the hull *origin* frame), 4-7 the wheel
    rects. Padded vertices wrap cyclically (harmless for SAT)."""
    dev, dt = cars.hull_c.device, cars.hull_c.dtype
    local_v = torch.as_tensor(shapes.CAR_FIXTURE_VERTS, dtype=dt, device=dev)    # (8, 8, 2)
    local_n = torch.as_tensor(shapes.CAR_FIXTURE_NORMALS, dtype=dt, device=dev)
    origin = torch.cat([cars.hull_origin[:, :, None, :], cars.wheel_c], dim=2)   # (E, N, 5, 2)
    angle = torch.cat([cars.hull_a[:, :, None], cars.wheel_a], dim=2)           # (E, N, 5)
    body = torch.as_tensor(shapes.CAR_FIXTURE_BODY, dtype=torch.int64, device=dev)
    f_origin = origin[:, :, body]                                               # (E, N, 8, 2)
    f_angle = angle[:, :, body]                                                 # (E, N, 8)
    s, c = torch.sin(f_angle)[..., None], torch.cos(f_angle)[..., None]         # (E, N, 8, 1)

    def rot(v):                                                                 # (8, 8, 2)
        return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]],
                           dim=-1)

    return rot(local_v) + f_origin[..., None, :], rot(local_n)


def _interval_gap(axes: torch.Tensor, averts: torch.Tensor, bverts: torch.Tensor):
    """Separation along each axis: max(minB - maxA, minA - maxB).

    axes (..., K, 2); averts (..., Va, 2); bverts (..., Vb, 2), broadcasting
    over the leading dims. Returns (..., K)."""
    pa = torch.sum(axes[..., :, None, :] * averts[..., None, :, :], dim=-1)
    pb = torch.sum(axes[..., :, None, :] * bverts[..., None, :, :], dim=-1)
    return torch.maximum(pb.amin(-1) - pa.amax(-1), pa.amin(-1) - pb.amax(-1))


def quad_axes(quads: torch.Tensor) -> torch.Tensor:
    """Unit edge normals of quads (..., 4, 2) -> (..., 4, 2). Degenerate
    (padding) quads give NaN axes, which make every comparison False:
    exactly 'no overlap'."""
    edges = torch.roll(quads, -1, dims=-2) - quads
    n = torch.stack([edges[..., 1], -edges[..., 0]], dim=-1)
    return n / torch.sqrt(torch.sum(n * n, dim=-1, keepdim=True))


def fixtures_vs_quads(fverts: torch.Tensor, fnormals: torch.Tensor, quads: torch.Tensor,
                      margin: float = C.SENSOR_OVERLAP_MARGIN) -> torch.Tensor:
    """(E, N, F, T) bool: SAT overlap (within margin) of every fixture,
    fverts / fnormals (E, N, F, 8, 2) in world space, against every quad of
    its env's ``quads`` (E, T, 4, 2)."""
    q = quads[:, None, None]                                   # (E, 1, 1, T, 4, 2)
    qax = quad_axes(quads)[:, None, None]
    fv = fverts[:, :, :, None]                                 # (E, N, F, 1, 8, 2)
    gap_f = _interval_gap(fnormals[:, :, :, None], fv, q)      # (E, N, F, T, 8)
    gap_q = _interval_gap(qax, fv, q)                          # (E, N, F, T, 4)
    sep = torch.maximum(gap_f.amax(-1), gap_q.amax(-1))
    return sep < margin


HULL_TOUCH_CHUNK = 64    # envs per pass of hull_tile_overlap (bounds its memory)


def hull_tile_overlap(cars: CarState, track) -> torch.Tensor:
    """(E, MT) bool: some hull fixture of some car of the env overlaps the
    tile (``fixtures_vs_quads`` on fixtures 0-3, the JAX package's
    ``exact_hull_touch`` term). Chunked over envs."""
    verts, normals = car_fixture_world_geometry(cars)
    E = verts.shape[0]
    out = []
    for e0 in range(0, E, HULL_TOUCH_CHUNK):
        sl = slice(e0, e0 + HULL_TOUCH_CHUNK)
        ov = fixtures_vs_quads(verts[sl, :, 0:4], normals[sl, :, 0:4], track.quad[sl])
        out.append(ov.any(2).any(1))
    return torch.cat(out, dim=0)
