"""Car fixture geometry and mass properties (host-side precompute).

Reproduces what Box2D derives implicitly when the reference creates a car
(cd:54-139): polygon convex hulls (CCW ordering + outward edge normals) and
``b2PolygonShape::ComputeMass`` / ``b2Body::ResetMassData`` numerics — total
mass, local center of mass, and rotational inertia about the COM for the hull
(4 fixtures, density 1.0) and each wheel (1 rect fixture, density 0.1).

Everything here is plain numpy executed once at import; the solver consumes
the resulting constants. A copy of the JAX package's ``physics/shapes.py``
(verified there against Box2D 2.3.5), kept so the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np

from .. import config as C


def _ccw(verts: np.ndarray) -> np.ndarray:
    """Orient polygon counter-clockwise (Box2D's convex hull does this)."""
    v = np.asarray(verts, dtype=np.float64)
    area2 = np.sum(v[:, 0] * np.roll(v[:, 1], -1) - np.roll(v[:, 0], -1) * v[:, 1])
    return v if area2 > 0 else v[::-1]


def polygon_mass(verts: np.ndarray, density: float):
    """b2PolygonShape::ComputeMass: (mass, centroid, I_about_body_origin)."""
    v = _ccw(verts)
    n = len(v)
    s = v.mean(axis=0)  # reference point for accuracy
    area = 0.0
    center = np.zeros(2)
    inertia = 0.0
    k_inv3 = 1.0 / 3.0
    for i in range(n):
        e1 = v[i] - s
        e2 = v[(i + 1) % n] - s
        d = e1[0] * e2[1] - e1[1] * e2[0]
        tri_area = 0.5 * d
        area += tri_area
        center += tri_area * k_inv3 * (e1 + e2)
        intx2 = e1[0] * e1[0] + e2[0] * e1[0] + e2[0] * e2[0]
        inty2 = e1[1] * e1[1] + e2[1] * e1[1] + e2[1] * e2[1]
        inertia += (0.25 * k_inv3 * d) * (intx2 + inty2)
    mass = density * area
    center /= area
    centroid = center + s
    # Inertia about the body origin (Box2D's parallel-axis shuffle).
    i_origin = density * inertia + mass * (centroid @ centroid - center @ center)
    return mass, centroid, i_origin


def body_mass_data(fixtures: list[tuple[np.ndarray, float]]):
    """b2Body::ResetMassData over fixtures [(verts, density)]:
    (mass, local_center, I_about_com)."""
    mass = 0.0
    center = np.zeros(2)
    i_origin = 0.0
    for verts, density in fixtures:
        m, c, i_o = polygon_mass(verts, density)
        mass += m
        center += m * c
        i_origin += i_o
    center /= mass
    i_com = i_origin - mass * (center @ center)
    return mass, center, i_com


def poly_with_normals(verts: np.ndarray, max_verts: int = 8):
    """CCW verts padded to max_verts (wrapping cyclically) + outward unit
    edge normals + true vertex count. Cyclic padding keeps row ``(i+1) %
    max_verts`` equal to the polygon's next vertex for every real edge ``i``
    — the manifold clipper reads the reference/incident face's second vertex
    that way, including for the closing edge (v[n-1] -> v[0]). Padded rows
    duplicate real vertices/normals, so support/projection math and argmin/
    argmax edge selection (first-occurrence tie-break) need no masking."""
    v = _ccw(verts)
    n = len(v)
    edges = np.roll(v, -1, axis=0) - v
    normals = np.stack([edges[:, 1], -edges[:, 0]], axis=-1)
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    idx = np.arange(max_verts) % n
    return v[idx], normals[idx], n


# ---------------------------------------------------------------------------
# Precomputed car constants
# ---------------------------------------------------------------------------
_S = C.SIZE

HULL_POLYS = [np.asarray(p, dtype=np.float64) * _S
              for p in (C.HULL_POLY1, C.HULL_POLY2, C.HULL_POLY3, C.HULL_POLY4)]

WHEEL_POLY = np.asarray(
    [(-C.WHEEL_W, +C.WHEEL_R), (+C.WHEEL_W, +C.WHEEL_R),
     (+C.WHEEL_W, -C.WHEEL_R), (-C.WHEEL_W, -C.WHEEL_R)],
    dtype=np.float64,
) * _S

WHEEL_RAD = C.WHEEL_R * _S                     # w.wheel_rad (cd:113)
WHEEL_POS = np.asarray(C.WHEELPOS, dtype=np.float64) * _S   # joint anchors on hull

HULL_MASS, HULL_LOCAL_CENTER, HULL_I = body_mass_data(
    [(p, C.HULL_FIXTURE_DENSITY) for p in HULL_POLYS]
)
WHEEL_MASS, WHEEL_LOCAL_CENTER, WHEEL_I = body_mass_data(
    [(WHEEL_POLY, C.WHEEL_FIXTURE_DENSITY)]
)

HULL_INV_MASS = 1.0 / HULL_MASS
HULL_INV_I = 1.0 / HULL_I
WHEEL_INV_MASS = 1.0 / WHEEL_MASS
WHEEL_INV_I = 1.0 / WHEEL_I

# Padded fixture local geometry for collision/overlap code:
# car fixture list = 4 hull polys + 4 wheel rects (indices 0-3 hull, 4-7 wheels)
_hulls = [poly_with_normals(p) for p in HULL_POLYS]
_wheel = poly_with_normals(WHEEL_POLY)
CAR_FIXTURE_VERTS = np.stack([h[0] for h in _hulls] + [_wheel[0]] * 4)   # (8,8,2)
CAR_FIXTURE_NORMALS = np.stack([h[1] for h in _hulls] + [_wheel[1]] * 4)  # (8,8,2)
CAR_FIXTURE_NVERTS = np.asarray([h[2] for h in _hulls] + [_wheel[2]] * 4)  # (8,)
# Body index per fixture within a car: 0 = hull, 1..4 = wheels.
CAR_FIXTURE_BODY = np.asarray([0, 0, 0, 0, 1, 2, 3, 4])
