# Frozen copy of multi_car_racing_tpu_torch/physics/collide.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Car-car polygon contacts: manifold generation + impulse solver.

Port of the JAX package's ``physics/collide.py`` over a leading env axis
``E``. The only non-sensor collisions in the game are hull-hull and
cross-car wheel-hull pairs (wheel-wheel is masked out by category bits,
cd:108-109; a car's own wheel-hull pairs are joint-connected and skip
collision).

Box2D semantics reproduced:
- ``b2CollidePolygons``: SAT max-separation over both polys' face normals,
  reference-face selection with the 0.1*linearSlop bias, incident-edge
  clipping, up to two contact points, polygon skin radii.
- ``b2ContactSolver``: warm starting (impulses persist while the manifold's
  feature id persists), friction-first accumulated-clamp velocity solve
  (friction sqrt(0.2*0.2), restitution 0), Baumgarte position push-out with
  slop and maxLinearCorrection.

As in the JAX package, each velocity iteration solves the manifolds in three
sub-passes (friction for both points, then normal point 0, then normal
point 1), each Jacobi across manifold rows with immediate application; the
position pass reuses the Collide-time manifold moved rigidly with the bodies.

Bodies are flattened to ``5N`` slots per env (hull + 4 wheels per car, slot
``car*5 + j``) and manifolds to ``P*48`` rows. Rows gather their two bodies
with ``index_select`` and impulses return to the bodies with ``index_add_``:
exact float32 arithmetic, never a reduced-precision matmul, since the
gathered values carry world positions.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from .. import config as C
from . import shapes
from .joints import Positions, Velocities

_TOTAL_RADIUS = 2.0 * C.B2_POLYGON_RADIUS
_FRICTION = C.HULL_FRICTION

FIXTURE_PAIRS = [
    (fa, fb) for fa in range(8) for fb in range(8) if not (fa >= 4 and fb >= 4)
]
M_PER_PAIR = len(FIXTURE_PAIRS)          # 48


def car_pairs(n: int):
    return list(itertools.combinations(range(n), 2))


def _tables(num_cars: int):
    """Static routing tables for the flattened manifold list (numpy)."""
    pairs = car_pairs(num_cars)
    body = shapes.CAR_FIXTURE_BODY
    rows_a = np.asarray([a * 5 + body[fa] for (a, _) in pairs
                         for (fa, _) in FIXTURE_PAIRS], np.int64)
    rows_b = np.asarray([b * 5 + body[fb] for (_, b) in pairs
                         for (_, fb) in FIXTURE_PAIRS], np.int64)
    # Manifold -> flat-fixture (car*8 + fixture) index, for the Collide pass.
    fix_a = np.asarray([a * 8 + fa for (a, _) in pairs for (fa, _) in FIXTURE_PAIRS],
                       np.int64)
    fix_b = np.asarray([b * 8 + fb for (_, b) in pairs for (_, fb) in FIXTURE_PAIRS],
                       np.int64)
    inv_m = np.tile(
        np.asarray([shapes.HULL_INV_MASS] + [shapes.WHEEL_INV_MASS] * 4), num_cars
    ).astype(np.float32)
    inv_i = np.tile(
        np.asarray([shapes.HULL_INV_I] + [shapes.WHEEL_INV_I] * 4), num_cars
    ).astype(np.float32)
    return pairs, rows_a, rows_b, inv_m, inv_i, fix_a, fix_b


_TABLE_CACHE: dict = {}


def tables(num_cars: int):
    """(pairs, rows_a, rows_b, inv_m, inv_i, fix_a, fix_b) as numpy arrays:
    the body slot of each manifold row's two sides, the bodies' inverse
    masses and inertias, and each row's two flat fixtures."""
    if num_cars not in _TABLE_CACHE:
        _TABLE_CACHE[num_cars] = _tables(num_cars)
    return _TABLE_CACHE[num_cars]


_DEVICE_TABLES: dict = {}


def _device_tables(num_cars: int, device: torch.device):
    key = (num_cars, str(device))
    if key not in _DEVICE_TABLES:
        _, rows_a, rows_b, inv_m, inv_i, fix_a, fix_b = tables(num_cars)
        _DEVICE_TABLES[key] = tuple(
            torch.as_tensor(x, device=device)
            for x in (rows_a, rows_b, inv_m, inv_i, fix_a, fix_b)
        )
    return _DEVICE_TABLES[key]


# ---------------------------------------------------------------------------
# Flat body-state helpers
# ---------------------------------------------------------------------------

def flatten_vel(vel: Velocities):
    """-> (V (E, 5N, 2), W (E, 5N))."""
    E, n = vel.hull_w.shape
    v = torch.cat([vel.hull_v[:, :, None, :], vel.wheel_v], dim=2).reshape(E, 5 * n, 2)
    w = torch.cat([vel.hull_w[:, :, None], vel.wheel_w], dim=2).reshape(E, 5 * n)
    return v, w


def unflatten_vel(v, w, n) -> Velocities:
    E = v.shape[0]
    v = v.reshape(E, n, 5, 2)
    w = w.reshape(E, n, 5)
    return Velocities(hull_v=v[:, :, 0], hull_w=w[:, :, 0],
                      wheel_v=v[:, :, 1:], wheel_w=w[:, :, 1:])


def flatten_com(hull_c, hull_a, wheel_c, wheel_a):
    """-> (C (E, 5N, 2), A (E, 5N))."""
    E, n = hull_a.shape
    c = torch.cat([hull_c[:, :, None, :], wheel_c], dim=2).reshape(E, 5 * n, 2)
    a = torch.cat([hull_a[:, :, None], wheel_a], dim=2).reshape(E, 5 * n)
    return c, a


def _cross(r, p):
    """2-D cross product r x p over the last axis."""
    return r[..., 0] * p[..., 1] - r[..., 1] * p[..., 0]


def _dot(a, b):
    """2-D dot product over the last axis, elementwise (no matmul)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]


# ---------------------------------------------------------------------------
# Manifold generation (Collide pass)
# ---------------------------------------------------------------------------

def _take(arr, idx):
    """arr (..., 8, 2), idx (...) int -> arr[..., idx, :] (..., 2)."""
    i = idx[..., None, None].expand(*idx.shape, 1, arr.shape[-1])
    return torch.gather(arr, -2, i).squeeze(-2)


def _max_separation(va, na, vb):
    """b2FindMaxSeparation over (..., 8, 2) polygons: (sep, edge int64)."""
    d = (na[..., :, None, 0] * vb[..., None, :, 0]
         + na[..., :, None, 1] * vb[..., None, :, 1])            # (..., 8, 8)
    s = torch.amin(d, dim=-1) - _dot(na, va)                       # (..., 8)
    edge = torch.argmax(s, dim=-1)                                 # first max
    return torch.amax(s, dim=-1), edge


def _collide_pair(va, na, vb, nb):
    """Batched fixture pairs (..., 8, 2) -> (normal (..., 2), pts (..., 2, 2),
    seps (..., 2), ok (..., 2) bool, id (...) int32)."""
    sep_a, edge_a = _max_separation(va, na, vb)
    sep_b, edge_b = _max_separation(vb, nb, va)
    no_contact = (sep_a > _TOTAL_RADIUS) | (sep_b > _TOTAL_RADIUS)

    flip = sep_b > sep_a + 0.1 * C.B2_LINEAR_SLOP
    f2 = flip[..., None, None]
    ref_v = torch.where(f2, vb, va)
    ref_n = torch.where(f2, nb, na)
    inc_v = torch.where(f2, va, vb)
    inc_n = torch.where(f2, na, nb)
    ref_edge = torch.where(flip, edge_b, edge_a)

    rn = _take(ref_n, ref_edge)                                    # (..., 2)
    inc_edge = torch.argmin(_dot(rn[..., None, :], inc_n), dim=-1)  # first min

    i1 = _take(inc_v, inc_edge)
    i2 = _take(inc_v, torch.remainder(inc_edge + 1, 8))
    v1 = _take(ref_v, ref_edge)
    v2 = _take(ref_v, torch.remainder(ref_edge + 1, 8))

    tangent = v2 - v1
    tlen = torch.sqrt(tangent[..., 0] * tangent[..., 0] + tangent[..., 1] * tangent[..., 1])
    tangent = tangent / torch.clamp(tlen, min=1e-12)[..., None]

    def clip(p1, p2, nrm, offset):
        d1 = _dot(nrm, p1) - offset
        d2 = _dot(nrm, p2) - offset
        den = torch.where(torch.abs(d1 - d2) > 1e-12, d1 - d2, torch.ones_like(d1))
        t = d1 / den
        interp = p1 + torch.clamp(t, 0.0, 1.0)[..., None] * (p2 - p1)
        keep1 = d1 <= 0
        keep2 = d2 <= 0
        crossed = d1 * d2 < 0
        out1 = torch.where(keep1[..., None], p1,
                           torch.where(crossed[..., None], interp, p2))
        out2 = torch.where(keep2[..., None], p2,
                           torch.where(crossed[..., None], interp, p1))
        ok = (keep1.to(torch.int32) + keep2.to(torch.int32)
              + crossed.to(torch.int32)) >= 2
        return out1, out2, ok

    off1 = -_dot(tangent, v1) + _TOTAL_RADIUS
    p1, p2, ok1 = clip(i1, i2, -tangent, off1)
    off2 = _dot(tangent, v2) + _TOTAL_RADIUS
    q1, q2, ok2 = clip(p1, p2, tangent, off2)

    front = _dot(rn, v1)
    s1 = _dot(rn, q1) - front - _TOTAL_RADIUS
    s2 = _dot(rn, q2) - front - _TOTAL_RADIUS
    ok = ok1 & ok2 & ~no_contact
    pt_ok = torch.stack([ok & (s1 <= _TOTAL_RADIUS), ok & (s2 <= _TOTAL_RADIUS)], dim=-1)

    normal = torch.where(flip[..., None], -rn, rn)
    cid = (flip.to(torch.int32) * 1024 + ref_edge.to(torch.int32) * 64
           + inc_edge.to(torch.int32))
    cid = torch.where(pt_ok.any(-1), cid, torch.full_like(cid, -1))
    return normal, torch.stack([q1, q2], dim=-2), torch.stack([s1, s2], dim=-1), pt_ok, cid


@dataclasses.dataclass(frozen=True)
class Manifolds:
    normal: torch.Tensor      # (E, MM, 2)
    point: torch.Tensor       # (E, MM, 2, 2)
    separation: torch.Tensor  # (E, MM, 2)
    point_ok: torch.Tensor    # (E, MM, 2) bool
    ids: torch.Tensor         # (E, MM) int32


def fixture_geometry(cars):
    """World-space vertices and outward normals of every car fixture:
    (verts, normals), each (E, N*8, 8, 2), fixture ``car*8 + f``."""
    E, n = cars.hull_a.shape
    dev, dtype = cars.hull_c.device, cars.hull_c.dtype
    local_v = torch.as_tensor(shapes.CAR_FIXTURE_VERTS, dtype=dtype, device=dev)
    local_n = torch.as_tensor(shapes.CAR_FIXTURE_NORMALS, dtype=dtype, device=dev)
    body = torch.as_tensor(shapes.CAR_FIXTURE_BODY, device=dev)
    origin = torch.cat([cars.hull_origin[:, :, None, :], cars.wheel_c], dim=2)  # (E,N,5,2)
    angle = torch.cat([cars.hull_a[:, :, None], cars.wheel_a], dim=2)         # (E,N,5)
    f_origin = origin[:, :, body]                                 # (E, N, 8, 2)
    f_angle = angle[:, :, body]                                   # (E, N, 8)
    ca, sa = torch.cos(f_angle)[..., None], torch.sin(f_angle)[..., None]
    vx, vy = local_v[..., 0], local_v[..., 1]                     # (8, 8)
    nx, ny = local_n[..., 0], local_n[..., 1]
    wv = torch.stack([ca * vx - sa * vy, sa * vx + ca * vy], dim=-1) + f_origin[:, :, :, None, :]
    wn = torch.stack([ca * nx - sa * ny, sa * nx + ca * ny], dim=-1)
    return wv.reshape(E, n * 8, 8, 2), wn.reshape(E, n * 8, 8, 2)


def collide(cars, num_cars: int) -> Manifolds:
    """Collide pass over all car pairs of every env: all ``P*48`` fixture
    pairs per env as one batched ``(E, MM, ...)`` computation."""
    *_, fix_a, fix_b = _device_tables(num_cars, cars.hull_c.device)
    wv, wn = fixture_geometry(cars)
    normal, pts, seps, ok, cid = _collide_pair(
        wv[:, fix_a], wn[:, fix_a], wv[:, fix_b], wn[:, fix_b])
    return Manifolds(normal=normal, point=pts, separation=seps, point_ok=ok, ids=cid)


# ---------------------------------------------------------------------------
# Contact solver (velocity + position)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ContactState:
    """Car-car contact warm-start carry (all zeros, ids -1, at one car)."""
    normal_imp: torch.Tensor    # (E, MM, 2)
    tangent_imp: torch.Tensor   # (E, MM, 2)
    ids: torch.Tensor           # (E, MM) int32


def init_contact_state(num_envs: int, num_cars: int, device=None,
                       dtype=torch.float32) -> ContactState:
    mm = max(len(car_pairs(num_cars)) * M_PER_PAIR, 1)
    return ContactState(
        normal_imp=torch.zeros((num_envs, mm, 2), dtype=dtype, device=device),
        tangent_imp=torch.zeros((num_envs, mm, 2), dtype=dtype, device=device),
        ids=torch.full((num_envs, mm), -1, dtype=torch.int32, device=device),
    )


@dataclasses.dataclass(frozen=True)
class ContactBundle:
    man: Manifolds
    normal_imp: torch.Tensor    # (E, MM, 2)
    tangent_imp: torch.Tensor
    r_a: torch.Tensor           # (E, MM, 2, 2) point - comA
    r_b: torch.Tensor
    normal_mass: torch.Tensor   # (E, MM, 2)
    tangent_mass: torch.Tensor  # (E, MM, 2)
    com_a0: torch.Tensor        # (E, MM, 2) COM at init (for the position pass)
    com_b0: torch.Tensor

    def replace(self, **updates) -> "ContactBundle":
        return dataclasses.replace(self, **updates)


def _tangent(n):
    return torch.stack([n[..., 1], -n[..., 0]], dim=-1)


def make_bundle(man: Manifolds, cstate: ContactState, cars, num_cars: int) -> ContactBundle:
    """InitializeVelocityConstraints: effective masses + warm-start carry."""
    rows_a, rows_b, inv_m, inv_i, _, _ = _device_tables(num_cars, cars.hull_c.device)
    com, _ = flatten_com(cars.hull_c, cars.hull_a, cars.wheel_c, cars.wheel_a)
    com_a = com[:, rows_a]                                # (E, MM, 2)
    com_b = com[:, rows_b]
    m_a, m_b = inv_m[rows_a][:, None], inv_m[rows_b][:, None]   # (MM, 1)
    i_a, i_b = inv_i[rows_a][:, None], inv_i[rows_b][:, None]

    r_a = man.point - com_a[:, :, None, :]                # (E, MM, 2, 2)
    r_b = man.point - com_b[:, :, None, :]
    n = man.normal[:, :, None, :]
    t = _tangent(man.normal)[:, :, None, :]

    def eff_mass(axis):
        crn_a = _cross(r_a, axis)
        crn_b = _cross(r_b, axis)
        k = m_a + m_b + i_a * crn_a ** 2 + i_b * crn_b ** 2
        return torch.where(k > 0, 1.0 / torch.clamp(k, min=1e-12), torch.zeros_like(k))

    keep = ((cstate.ids == man.ids) & (man.ids >= 0))[..., None] & man.point_ok
    zero = torch.zeros_like(cstate.normal_imp)
    return ContactBundle(
        man=man,
        normal_imp=torch.where(keep, cstate.normal_imp, zero),
        tangent_imp=torch.where(keep, cstate.tangent_imp, zero),
        r_a=r_a, r_b=r_b,
        normal_mass=eff_mass(n), tangent_mass=eff_mass(t),
        com_a0=com_a, com_b0=com_b,
    )


def _apply(v, w, p, ra, rb, tabs):
    """Route per-row impulses p (E, MM, 2) at arms ra, rb to the bodies:
    v += (sum_B p - sum_A p) * inv_m, w += (sum_B rb x p - sum_A ra x p) * inv_i."""
    rows_a, rows_b, inv_m, inv_i = tabs[:4]
    la = _cross(ra, p)
    lb = _cross(rb, p)
    v = v + (torch.zeros_like(v).index_add_(1, rows_b, p)
             - torch.zeros_like(v).index_add_(1, rows_a, p)) * inv_m[:, None]
    w = w + (torch.zeros_like(w).index_add_(1, rows_b, lb)
             - torch.zeros_like(w).index_add_(1, rows_a, la)) * inv_i
    return v, w


def warm_start(vel: Velocities, bundle: ContactBundle, n_cars: int) -> Velocities:
    """Apply carried-over impulses before iterating (b2ContactSolver::WarmStart)."""
    tabs = _device_tables(n_cars, vel.hull_w.device)
    v, w = flatten_vel(vel)
    n = bundle.man.normal
    t = _tangent(n)
    for k in range(2):
        p = bundle.normal_imp[..., k, None] * n + bundle.tangent_imp[..., k, None] * t
        v, w = _apply(v, w, p, bundle.r_a[:, :, k], bundle.r_b[:, :, k], tabs)
    return unflatten_vel(v, w, n_cars)


def velocity_pass(vel: Velocities, n_imp, t_imp, bundle: ContactBundle, n_cars: int):
    """One velocity iteration: friction sub-pass then two normal sub-passes,
    each Jacobi across manifold rows with immediate application.

    Returns (vel, n_imp, t_imp)."""
    tabs = _device_tables(n_cars, vel.hull_w.device)
    rows_a, rows_b = tabs[0], tabs[1]
    v, w = flatten_vel(vel)
    man = bundle.man
    n = man.normal
    t = _tangent(n)
    zero = torch.zeros_like(n_imp[..., 0])

    def rel_vel(k):
        va, vb = v[:, rows_a], v[:, rows_b]
        wa, wb = w[:, rows_a], w[:, rows_b]
        ra, rb = bundle.r_a[:, :, k], bundle.r_b[:, :, k]
        dva = torch.stack([-wa * ra[..., 1], wa * ra[..., 0]], dim=-1)
        dvb = torch.stack([-wb * rb[..., 1], wb * rb[..., 0]], dim=-1)
        return (vb + dvb) - (va + dva)

    t_cols, n_cols = list(t_imp.unbind(-1)), list(n_imp.unbind(-1))
    # Friction (both points).
    for k in range(2):
        vt = _dot(rel_vel(k), t)
        lam = -bundle.tangent_mass[..., k] * vt
        max_f = _FRICTION * n_cols[k]
        new = torch.minimum(torch.maximum(t_cols[k] + lam, -max_f), max_f)
        new = torch.where(man.point_ok[..., k], new, zero)
        lam = new - t_cols[k]
        t_cols[k] = new
        v, w = _apply(v, w, lam[..., None] * t, bundle.r_a[:, :, k], bundle.r_b[:, :, k], tabs)
    # Normal (per point, sequential sub-passes).
    for k in range(2):
        vn = _dot(rel_vel(k), n)
        lam = -bundle.normal_mass[..., k] * vn
        new = torch.clamp(n_cols[k] + lam, min=0.0)
        new = torch.where(man.point_ok[..., k], new, zero)
        lam = new - n_cols[k]
        n_cols[k] = new
        v, w = _apply(v, w, lam[..., None] * n, bundle.r_a[:, :, k], bundle.r_b[:, :, k], tabs)
    return (unflatten_vel(v, w, n_cars), torch.stack(n_cols, dim=-1),
            torch.stack(t_cols, dim=-1))


def position_pass(pos: Positions, bundle: ContactBundle, n_cars: int) -> Positions:
    """One position iteration: Baumgarte push-out along the Collide-time
    normal, separations tracked by rigid translation of the bodies."""
    tabs = _device_tables(n_cars, pos.hull_a.device)
    rows_a, rows_b = tabs[0], tabs[1]
    c, a = flatten_com(pos.hull_c, pos.hull_a, pos.wheel_c, pos.wheel_a)
    man = bundle.man
    n = man.normal

    def shift():
        return _dot((c[:, rows_b] - bundle.com_b0) - (c[:, rows_a] - bundle.com_a0), n)

    for k in range(2):
        sep = man.separation[..., k] + shift()
        cc = torch.clamp(C.B2_BAUMGARTE * (sep + C.B2_LINEAR_SLOP),
                         -C.B2_MAX_LINEAR_CORRECTION, 0.0)
        # impulse magnitude = -C / K, with normal_mass == 1/K.
        imp = torch.where(man.point_ok[..., k], -cc * bundle.normal_mass[..., k],
                          torch.zeros_like(cc))
        c, a = _apply(c, a, imp[..., None] * n, bundle.r_a[:, :, k], bundle.r_b[:, :, k], tabs)

    E = c.shape[0]
    c = c.reshape(E, n_cars, 5, 2)
    a = a.reshape(E, n_cars, 5)
    return Positions(hull_c=c[:, :, 0], hull_a=a[:, :, 0],
                     wheel_c=c[:, :, 1:], wheel_a=a[:, :, 1:])


def extract_state(bundle: ContactBundle) -> ContactState:
    """StoreImpulses: carry accumulators + ids for next-step warm start."""
    return ContactState(normal_imp=bundle.normal_imp, tangent_imp=bundle.tangent_imp,
                        ids=bundle.man.ids)
