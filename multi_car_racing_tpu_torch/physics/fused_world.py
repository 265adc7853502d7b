"""The fused physics stage of a step: tire model, Collide pass and island solve.

``island_step`` runs, for every (env, car), the tire model, force
integration, the joint limit init and the 180-velocity / 60-position
Gauss-Seidel island solve, and at two or more cars per env the car-car
Collide pass and contact sub-passes with their warm-start carry. On CUDA
tensors it launches a hand-written kernel:

- one car per env: ``csrc/joints_island.cu`` (K1), which replaces the TPU
  kernel ``multi_car_racing_tpu/physics/pallas_world.py::_make_mega_kernel``
  with ``force_no_contacts=True``;
- two or more cars per env: ``csrc/contact_island.cu`` (K2), which replaces
  the full-contact ``_make_mega_kernel``. One K2 call per step makes two
  launches: a far pass, one thread per car, that computes each env's
  broadphase flag (the test of :func:`near_flags`), runs a far env's cars as
  K1 does and lists the near envs on the card; then a near pass, one warp
  per listed env, with the Collide pass and a contact solve over the live
  rows only (the lists of :func:`live_routing`). There is no host read.

On CPU tensors it runs ``island_step_plain``, the same function as
``tire_step -> collide -> make_bundle -> world_step -> extract_state`` in
PyTorch ops. There is no fallback from one to the other: a CUDA tensor
either goes through its kernel or raises.

``island_step.launches`` counts K1 launches and ``island_step.contact_launches``
K2 launches (and nothing else), so a run can show that its main path went
through the kernels.

``world_step_batched`` is the solve alone, with manifolds and warm impulses
computed outside (a ContactBundle): force integration, the joint limit init
and the island solve of cars the tire model has already run on. On CUDA
tensors it launches ``csrc/solve_island.cu`` (K3), which replaces the TPU
kernel ``pallas_world.py::_make_solve_kernel``: a list pass, one thread per
env, that lists on the card the envs with a live contact point (the test of
:func:`solve_live_envs`); then a solve pass whose first blocks run every car
of an env with no live point as K1's chain without the tire model, one
thread per car, and whose blocks after those take the listed envs, one warp
each. On CPU tensors it runs ``world.world_step`` on the same bundle. It is
the differential harness for K2: K2 against the plain Collide pass followed
by K3 holds K2's in-kernel Collide apart from its solve.
``world_step_batched.launches`` counts K3 calls.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import config as C
from . import collide, joints, shapes, tire, world
from .collide import ContactState
from .state import CarState

KERNEL = "joints_island"

# Row offsets of the packed (rows, E*N) buffers; equal to the constexprs at
# the top of csrc/joints_island.cu.
IN_ROWS = dict(IN_HULL=0, IN_WHEEL=6, IN_TIRE=30, IN_FUEL=50, IN_ONROAD=51,
               IN_JNT=55, N_IN=71)
OUT_ROWS = dict(OUT_HULL=0, OUT_WHEEL=6, OUT_JNT=30, OUT_TIRE=46, OUT_FUEL=58,
                N_OUT=59)

# Scalar parameters in the order of the kernel's ``enum Param``.
PARAM_NAMES = (
    "DT", "MA", "IA", "MB", "IB", "MOTOR_MASS", "MA_MB", "IA_IB",
    "ARM_X0", "ARM_X1", "ARM_X2", "ARM_X3",
    "ARM_Y0", "ARM_Y1", "ARM_Y2", "ARM_Y3",
    "WHEEL_RAD", "MAX_MOTOR", "SERVO_GAIN", "SERVO_MAX",
    "FRICTION", "FRICTION_GRASS", "DT_ENGINE", "WHEEL_I", "BRAKE_FORCE",
    "TIRE_STIFFNESS", "LOWER", "UPPER", "ANG_SLOP", "MAX_ANG_CORR",
    "MAX_TRANS", "MAX_TRANS2", "MAX_ROT", "MAX_ROT2", "DT_MB",
)


def param_values(dt: float = C.DT) -> tuple:
    """The kernel's scalar parameters at step ``dt`` (float64 here, float32
    on the card)."""
    ma, ia = float(shapes.HULL_INV_MASS), float(shapes.HULL_INV_I)
    mb, ib = float(shapes.WHEEL_INV_MASS), float(shapes.WHEEL_INV_I)
    v = dict(
        DT=dt, MA=ma, IA=ia, MB=mb, IB=ib, MOTOR_MASS=1.0 / (ia + ib),
        MA_MB=ma + mb, IA_IB=ia + ib,
        WHEEL_RAD=float(shapes.WHEEL_RAD),
        MAX_MOTOR=dt * C.STEER_JOINT_MAX_MOTOR_TORQUE,
        SERVO_GAIN=C.STEER_SERVO_GAIN, SERVO_MAX=C.STEER_SERVO_MAX_SPEED,
        FRICTION=C.FRICTION_LIMIT,
        FRICTION_GRASS=C.FRICTION_LIMIT * C.GRASS_FRICTION_FACTOR,
        DT_ENGINE=dt * C.ENGINE_POWER, WHEEL_I=C.WHEEL_MOMENT_OF_INERTIA,
        BRAKE_FORCE=C.BRAKE_FORCE, TIRE_STIFFNESS=C.TIRE_STIFFNESS,
        LOWER=C.STEER_JOINT_LOWER, UPPER=C.STEER_JOINT_UPPER,
        ANG_SLOP=C.B2_ANGULAR_SLOP, MAX_ANG_CORR=C.B2_MAX_ANGULAR_CORRECTION,
        MAX_TRANS=C.B2_MAX_TRANSLATION, MAX_TRANS2=C.B2_MAX_TRANSLATION ** 2,
        MAX_ROT=C.B2_MAX_ROTATION, MAX_ROT2=C.B2_MAX_ROTATION ** 2,
        DT_MB=dt * mb,
    )
    for k in range(4):
        v[f"ARM_X{k}"] = joints.ARM_X[k]
        v[f"ARM_Y{k}"] = joints.ARM_Y[k]
    return tuple(v[name] for name in PARAM_NAMES)


# fp32 operations per car, counted from csrc/joints_island.cu: an add,
# multiply, compare, select, min or max counts 1; a division, square root,
# sine or cosine counts 8. Joints whose limit is active take the longer
# velocity path (the 3x3 solve) and the position limit correction.
FLOPS_PER_CAR_FIXED = (4 * 117      # tire model, per wheel (2 sin/cos, 3 div, 1 sqrt)
                       + 4 * 5      # limit-state init
                       + 16 + 4 * 22  # anchor arms (sin/cos) + warm start
                       + 4 * 63     # K-matrix terms and inverses
                       + 5 * 14     # translation/rotation clamps (unclamped path)
                       + 30)        # position integration
FLOPS_VEL_JOINT = 48                # one joint, one velocity iteration, limit inactive
FLOPS_VEL_JOINT_LIMIT_EXTRA = 15    # ... extra when the limit is active
FLOPS_POS_JOINT = 77                # one joint, one position iteration (2 sin/cos, 1 div)
FLOPS_POS_JOINT_LIMIT_EXTRA = 4


def island_flops(n_cars: int, n_limit_joints: int,
                 velocity_iters: int = C.VELOCITY_ITERS,
                 position_iters: int = C.POSITION_ITERS) -> int:
    """fp32 operations of one island call over ``n_cars`` cars of which
    ``n_limit_joints`` joints (summed over cars) start the solve with an
    active limit: the work this call's data needs."""
    return (n_cars * FLOPS_PER_CAR_FIXED
            + velocity_iters * (4 * FLOPS_VEL_JOINT * n_cars
                                + FLOPS_VEL_JOINT_LIMIT_EXTRA * n_limit_joints)
            + position_iters * (4 * FLOPS_POS_JOINT * n_cars
                                + FLOPS_POS_JOINT_LIMIT_EXTRA * n_limit_joints))


def island_bytes(n_cars: int) -> int:
    """Bytes the island must move: each packed input read once, each output
    written once (floats plus the int32 limit states)."""
    return n_cars * 4 * (IN_ROWS["N_IN"] + 4 + OUT_ROWS["N_OUT"] + 4)


# ---------------------------------------------------------------------------
# K2 (csrc/contact_island.cu): constant tables, operation and byte counts.
# ---------------------------------------------------------------------------

CONTACT_KERNEL = "contact_island"

# Scalars of the contact parameter table, in the order of the kernel's
# ``enum CParam``; the fixtures' local vertices and outward normals follow
# them, (8 fixtures x 8 vertices x 2) floats each.
CPARAM_NAMES = (
    "FRICTION", "TOTAL_RADIUS", "FLIP_BIAS", "LINEAR_SLOP", "BAUMGARTE",
    "MAX_LIN_CORR", "LC_X", "LC_Y", "HULL_MID_X", "HULL_MID_Y",
    "HULL_HALF_X", "HULL_HALF_Y", "WHEEL_HALF_X", "WHEEL_HALF_Y", "BP_SLACK",
    "INV_M_HULL", "INV_M_WHEEL", "INV_I_HULL", "INV_I_WHEEL",
)


def contact_param_values() -> np.ndarray:
    """K2's float table: the CPARAM_NAMES scalars, then the fixtures' local
    vertices, then their normals (float32)."""
    v = dict(
        FRICTION=C.HULL_FRICTION, TOTAL_RADIUS=2.0 * C.B2_POLYGON_RADIUS,
        FLIP_BIAS=0.1 * C.B2_LINEAR_SLOP, LINEAR_SLOP=C.B2_LINEAR_SLOP,
        BAUMGARTE=C.B2_BAUMGARTE, MAX_LIN_CORR=C.B2_MAX_LINEAR_CORRECTION,
        LC_X=shapes.HULL_LOCAL_CENTER[0], LC_Y=shapes.HULL_LOCAL_CENTER[1],
        HULL_MID_X=HULL_AABB_MID[0], HULL_MID_Y=HULL_AABB_MID[1],
        HULL_HALF_X=HULL_AABB_HALF[0], HULL_HALF_Y=HULL_AABB_HALF[1],
        WHEEL_HALF_X=WHEEL_AABB_HALF[0], WHEEL_HALF_Y=WHEEL_AABB_HALF[1],
        BP_SLACK=BP_SLACK,
        INV_M_HULL=shapes.HULL_INV_MASS, INV_M_WHEEL=shapes.WHEEL_INV_MASS,
        INV_I_HULL=shapes.HULL_INV_I, INV_I_WHEEL=shapes.WHEEL_INV_I,
    )
    return np.concatenate([
        np.asarray([v[k] for k in CPARAM_NAMES], np.float64),
        shapes.CAR_FIXTURE_VERTS.reshape(-1), shapes.CAR_FIXTURE_NORMALS.reshape(-1),
    ]).astype(np.float32)


def contact_index_table(num_cars: int) -> np.ndarray:
    """K2's int32 routing table for ``num_cars`` cars per env, MM manifold
    rows and NB = 5 * num_cars bodies, laid out as

    - ``fix_a``, ``fix_b`` (MM each): the row's two flat fixtures ``car*8 + f``;
    - ``body_a``, ``body_b`` (MM each): the row's two body slots ``car*5 + j``;
    - ``offsets`` (NB + 1) and ``entries`` (2 MM): for body ``b`` the entries
      ``offsets[b]:offsets[b+1]``, each ``row*2 + side`` (side 1 where the
      body is the row's B side), rows ascending. A body's impulse sums run
      in this order, so every launch adds them in the same order.

    The same rows as ``collide.tables``."""
    _, rows_a, rows_b, _, _, fix_a, fix_b = collide.tables(num_cars)
    nb = 5 * num_cars
    lists = [[] for _ in range(nb)]
    for r, (a, b) in enumerate(zip(rows_a, rows_b)):
        lists[a].append(2 * r)
        lists[b].append(2 * r + 1)
    offsets = np.cumsum([0] + [len(x) for x in lists])
    entries = [e for x in lists for e in sorted(x)]
    return np.concatenate([fix_a, fix_b, rows_a, rows_b, offsets, entries]).astype(np.int32)


def live_routing(point_ok: torch.Tensor, num_cars: int):
    """The compact lists K2's and K3's solve walk (``build_live_lists`` in
    csrc/contact_rows.cuh), from a (E, MM, 2) point_ok, in plain torch:

    - ``rows`` (E, MM) int32: the rows with a live point, ascending, then -1;
    - ``n_rows`` (E,) int32: their number;
    - ``entries`` (E, 2 MM) int32: for body ``b``, its routing entries
      (``row*2 + side``, :func:`contact_index_table`) whose row is live, in
      the table's order, from the body's table offset on; -1 after them;
    - ``counts`` (E, 5 * num_cars) int32: each body's live entries.

    A body's impulse sums add its live entries in this order."""
    tab = contact_index_table(num_cars)
    mm = len(collide.car_pairs(num_cars)) * collide.M_PER_PAIR
    nb = 5 * num_cars
    offsets = torch.as_tensor(tab[4 * mm:4 * mm + nb + 1], dtype=torch.int64)
    table = torch.as_tensor(tab[4 * mm + nb + 1:], dtype=torch.int64, device=point_ok.device)
    live = point_ok.any(-1)                                            # (E, MM)
    n_rows = live.sum(1)
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    col = torch.arange(mm, device=live.device)
    rows = torch.where(col[None] < n_rows[:, None], order, -1)
    ent_live = live[:, table >> 1]                                     # (E, 2 MM)
    body = torch.repeat_interleave(torch.arange(nb), offsets[1:] - offsets[:-1]).to(live.device)
    # Within each body's segment, live entries first, each group in table order.
    perm = torch.argsort(body[None] * 2 + (~ent_live).to(torch.int64), dim=1, stable=True)
    counts = torch.zeros((live.shape[0], nb), dtype=torch.int64, device=live.device)
    counts.index_add_(1, body, ent_live.to(torch.int64))
    slot = torch.arange(2 * mm, device=live.device)
    keep = slot[None] - offsets.to(live.device)[body][None] < counts[:, body]
    entries = torch.where(keep, table[perm], -1)
    return (rows.to(torch.int32), n_rows.to(torch.int32), entries.to(torch.int32),
            counts.to(torch.int32))


# fp32 operations of K2 beyond K1's chain, counted from csrc/contact_island.cu
# as for K1 (a division, square root, sine or cosine counts 8). Only what this
# call's data needs is counted: every env's broadphase; in a near env the SAT
# of every row (it decides each row) but the world polygons once per fixture;
# the clipping of each row whose manifold is live; and the solve of each live
# contact point and of each body a live point touches. The kernel does more:
# each row rebuilds its two polygons and computes arms and masses, the far
# pass computes an env's broadphase once per car, and a live row's two points
# both take part in every sub-pass (a dead point adds zeros). The contact
# solve walks only the live rows and each body only its live entries
# (live_routing).
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
                         n_touched_bodies: int,
                         velocity_iters: int = C.VELOCITY_ITERS,
                         position_iters: int = C.POSITION_ITERS) -> int:
    """fp32 operations of one K2 call on this call's data
    (:func:`contact_island_work` counts the last four arguments).

    Point k's live points and the ``n_touched_bodies`` (summed over k) take
    part in one warm-start sub-pass, two sub-passes (friction, normal) per
    contact velocity iteration and one per contact position iteration."""
    n_envs = n_cars // num_cars
    pairs = len(collide.car_pairs(num_cars))
    k_vel = min(C.CONTACT_VELOCITY_ITERS, velocity_iters)
    k_pos = min(C.CONTACT_POSITION_ITERS, position_iters)
    return (island_flops(n_cars, n_limit_joints, velocity_iters, position_iters)
            + n_envs * (num_cars * FLOPS_BROADPHASE_CAR + pairs * FLOPS_BROADPHASE_PAIR)
            + n_near_envs * num_cars * (5 * FLOPS_BODY_FRAME + 8 * FLOPS_FIXTURE_WORLD)
            + n_near_envs * pairs * collide.M_PER_PAIR * FLOPS_SAT_ROW
            + n_live_rows * FLOPS_CLIP_ROW
            + n_live_points * (FLOPS_POINT_BUNDLE + FLOPS_POINT_WARM
                               + k_vel * FLOPS_POINT_VEL + k_pos * FLOPS_POINT_POS)
            + n_touched_bodies * FLOPS_BODY_UPDATE * (1 + 2 * k_vel + k_pos))


def _live_counts(point_ok: torch.Tensor, num_cars: int) -> dict:
    """Manifold rows with a live point, live contact points, and for each
    point index the bodies that its live points touch (summed over envs and
    point indices), of a (E, MM, 2) point_ok."""
    _, rows_a, rows_b, *_ = collide.tables(num_cars)
    live = point_ok.transpose(1, 2).to(torch.int32)                  # (E, 2, MM)
    touches = torch.zeros((*live.shape[:2], 5 * num_cars), dtype=torch.int32,
                          device=live.device)
    for rows in (rows_a, rows_b):
        touches.index_add_(2, torch.as_tensor(rows, device=live.device), live)
    return dict(n_live_rows=int(point_ok.any(-1).sum()), n_live_points=int(point_ok.sum()),
                n_touched_bodies=int((touches > 0).sum()))


def contact_island_work(cars: CarState) -> dict:
    """What K2's work depends on in this input (pre-solve cars, two or more
    per env), counted with the plain versions: near envs, manifold rows
    with a live point, live contact points, and for each point index the
    bodies that its live points touch, summed over envs and point indices."""
    n = cars.hull_a.shape[1]
    near = near_flags(cars)
    ok = collide.collide(cars, n).point_ok & near[:, None, None]    # (E, MM, 2)
    return dict(n_near_envs=int(near.sum()), **_live_counts(ok, n))


def contact_island_bytes(n_cars: int, num_cars: int) -> int:
    """Bytes K2 must move: K1's car rows, plus the contact carry (4 impulse
    floats and an int32 id per manifold row) read once and written once."""
    n_envs = n_cars // num_cars
    rows = len(collide.car_pairs(num_cars)) * collide.M_PER_PAIR
    return island_bytes(n_cars) + n_envs * rows * 4 * (4 + 1) * 2


# ---------------------------------------------------------------------------
# Plain PyTorch version.
# ---------------------------------------------------------------------------

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

    near = torch.zeros_like(cars.hull_a[:, 0], dtype=torch.bool)
    for (a, b) in collide.car_pairs(n):
        ha = (hull_cx[:, a, None], hull_cy[:, a, None], hull_hx[:, a, None], hull_hy[:, a, None])
        hb = (hull_cx[:, b, None], hull_cy[:, b, None], hull_hx[:, b, None], hull_hy[:, b, None])
        wa = (wx[:, a], wy[:, a], whx[:, a], why[:, a])
        wb = (wx[:, b], wy[:, b], whx[:, b], why[:, b])
        near = (near | overlap(*ha, *hb)[:, 0] | overlap(*ha, *wb).any(-1)
                | overlap(*wa, *hb).any(-1))
    return near


# ---------------------------------------------------------------------------
# Kernel wrapper.
# ---------------------------------------------------------------------------

_params_cache: dict = {}


def _library(name: str = KERNEL):
    """The built library of ``csrc/<name>.cu`` with its entry points typed."""
    from .. import _cuda

    lib = _cuda.load(name)
    fn = getattr(lib, f"{name}_launch")
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        if name == KERNEL:
            fn.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, vp]
        elif name == CONTACT_KERNEL:
            fn.argtypes = [vp] * 15 + [ci] * 7 + [vp]
        else:                   # solve_island: its live-env list and count too
            fn.argtypes = [vp] * 17 + [ci] * 7 + [vp]
        fn.restype = ci
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ci]
        err.restype = ctypes.c_char_p
    return lib


def _params(device: torch.device, dt: float = C.DT) -> torch.Tensor:
    key = ("params", str(device), float(dt))
    if key not in _params_cache:
        _params_cache[key] = torch.tensor(param_values(dt), dtype=torch.float32,
                                          device=device)
    return _params_cache[key]


def _contact_tables(device: torch.device, num_cars: int):
    """K2's (float table, int32 routing table) on ``device``, built once."""
    key = (str(device), num_cars)
    if key not in _params_cache:
        _params_cache[key] = (
            torch.from_numpy(contact_param_values()).to(device),
            torch.from_numpy(contact_index_table(num_cars)).to(device),
        )
    return _params_cache[key]


def _check_tensors(label: str, dev: torch.device, specs, contiguous: bool = True) -> None:
    """Each (name, tensor, dtype, shape) of ``specs`` must be a tensor of that
    dtype and shape on ``dev``, and contiguous if ``contiguous`` (a kernel
    reads it as it lies); raises ValueError otherwise."""
    for name, t, dtype, shape in specs:
        if (t.dtype != dtype or t.device != dev or tuple(t.shape) != tuple(shape)
                or (contiguous and not t.is_contiguous())):
            raise ValueError(f"{label}: {name} must be a {'contiguous ' * contiguous}{dtype} "
                             f"{tuple(shape)} tensor on {dev}, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}"
                             + (" (not contiguous)" if contiguous and not t.is_contiguous()
                                else ""))


def _check(cars: CarState, wheel_on_road: torch.Tensor):
    E, N = cars.hull_a.shape
    f32 = torch.float32
    float_shapes = dict(hull_c=(E, N, 2), hull_a=(E, N), hull_v=(E, N, 2),
                        hull_w=(E, N), wheel_c=(E, N, 4, 2), wheel_a=(E, N, 4),
                        wheel_v=(E, N, 4, 2), wheel_w=(E, N, 4),
                        joint_impulse=(E, N, 4, 3), motor_impulse=(E, N, 4),
                        gas=(E, N, 4), brake=(E, N, 4), steer=(E, N, 4),
                        spin=(E, N, 4), phase=(E, N, 4), fuel_spent=(E, N))
    _check_tensors("island_step", cars.hull_a.device, [
        *((name, getattr(cars, name), f32, shape) for name, shape in float_shapes.items()),
        ("limit_state", cars.limit_state, torch.int32, (E, N, 4)),
        ("wheel_on_road", wheel_on_road, torch.bool, (E, N, 4))], contiguous=False)
    return E, N


def pack_inputs(cars: CarState, wheel_on_road: torch.Tensor):
    """CarState -> the kernel's (71, E*N) float32 rows and (4, E*N) int32
    limit states, both contiguous, car index e*N + n."""
    E, N = cars.hull_a.shape

    def w4(x):                                   # (E, N, 4) -> (4, E, N)
        return x.permute(2, 0, 1)

    fin = torch.cat([
        cars.hull_v.permute(2, 0, 1), cars.hull_w[None],
        cars.hull_c.permute(2, 0, 1), cars.hull_a[None],
        w4(cars.wheel_v[..., 0]), w4(cars.wheel_v[..., 1]), w4(cars.wheel_w),
        w4(cars.wheel_c[..., 0]), w4(cars.wheel_c[..., 1]), w4(cars.wheel_a),
        w4(cars.gas), w4(cars.brake), w4(cars.steer), w4(cars.spin),
        w4(cars.phase), cars.fuel_spent[None],
        w4(wheel_on_road.to(torch.float32)),
        w4(cars.joint_impulse[..., 0]), w4(cars.joint_impulse[..., 1]),
        w4(cars.joint_impulse[..., 2]), w4(cars.motor_impulse),
    ]).reshape(IN_ROWS["N_IN"], E * N)
    ls_in = w4(cars.limit_state).reshape(4, E * N).contiguous()
    return fin.contiguous(), ls_in


def _solved_fields(fout: torch.Tensor, ls_out: torch.Tensor, E: int, N: int) -> dict:
    """The CarState fields of the solved rows OUT_HULL..OUT_JNT and the limit
    states of a kernel's (rows, E*N) outputs."""
    fo = fout.view(-1, E, N)

    def w4(r):                                   # rows r..r+3 -> (E, N, 4)
        return fo[r:r + 4].permute(1, 2, 0)

    def w4x2(r):                                 # rows r..r+7 -> (E, N, 4, 2)
        return fo[r:r + 8].view(2, 4, E, N).permute(2, 3, 1, 0)

    h, w, j = OUT_ROWS["OUT_HULL"], OUT_ROWS["OUT_WHEEL"], OUT_ROWS["OUT_JNT"]
    return dict(
        hull_v=fo[h:h + 2].permute(1, 2, 0), hull_w=fo[h + 2],
        hull_c=fo[h + 3:h + 5].permute(1, 2, 0), hull_a=fo[h + 5],
        wheel_v=w4x2(w), wheel_w=w4(w + 8),
        wheel_c=w4x2(w + 12), wheel_a=w4(w + 20),
        joint_impulse=fo[j:j + 12].view(3, 4, E, N).permute(2, 3, 1, 0),
        motor_impulse=w4(j + 12),
        limit_state=ls_out.view(4, E, N).permute(1, 2, 0),
    )


def unpack_outputs(cars: CarState, fout: torch.Tensor, ls_out: torch.Tensor):
    """The kernel's output rows -> (new CarState, skid (E, N, 4) bool)."""
    E, N = cars.hull_a.shape
    fo = fout.view(OUT_ROWS["N_OUT"], E, N)

    def w4(r):                                   # rows r..r+3 -> (E, N, 4)
        return fo[r:r + 4].permute(1, 2, 0)

    t = OUT_ROWS["OUT_TIRE"]
    new = cars.replace(**_solved_fields(fout, ls_out, E, N), spin=w4(t), phase=w4(t + 4),
                       fuel_spent=fo[OUT_ROWS["OUT_FUEL"]])
    return new, w4(t + 8) > 0.5


def launch(fin: torch.Tensor, ls_in: torch.Tensor, n_cars: int,
           velocity_iters: int = C.VELOCITY_ITERS,
           position_iters: int = C.POSITION_ITERS):
    """Launch the kernel on packed rows (from :func:`pack_inputs`) on the
    current stream; returns the packed outputs (fout (59, n), ls_out (4, n)).
    Counts the launch in ``island_step.launches``."""
    dev = fin.device
    if (fin.dtype != torch.float32 or ls_in.dtype != torch.int32 or dev.type != "cuda"
            or ls_in.device != dev or not fin.is_contiguous() or not ls_in.is_contiguous()
            or tuple(fin.shape) != (IN_ROWS["N_IN"], n_cars)
            or tuple(ls_in.shape) != (4, n_cars)):
        raise ValueError("launch: expects contiguous CUDA float32 (71, n) rows and "
                         "int32 (4, n) limit states")
    lib = _library()
    fout = torch.empty((OUT_ROWS["N_OUT"], n_cars), dtype=torch.float32, device=dev)
    ls_out = torch.empty((4, n_cars), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):      # the stream and the launch belong to dev
        rc = lib.joints_island_launch(
            fin.data_ptr(), ls_in.data_ptr(), fout.data_ptr(), ls_out.data_ptr(),
            _params(dev).data_ptr(), n_cars, int(velocity_iters), int(position_iters),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.joints_island_error_string(rc).decode()
        raise RuntimeError(f"joints_island launch failed: {msg} ({rc})")
    island_step.launches += 1
    return fout, ls_out


def _check_contacts(cs: ContactState, E: int, N: int, dev: torch.device):
    mm = len(collide.car_pairs(N)) * collide.M_PER_PAIR
    _check_tensors("island_step", dev, (
        ("contacts.normal_imp", cs.normal_imp, torch.float32, (E, mm, 2)),
        ("contacts.tangent_imp", cs.tangent_imp, torch.float32, (E, mm, 2)),
        ("contacts.ids", cs.ids, torch.int32, (E, mm))), contiguous=False)
    return mm


def launch_contacts(fin: torch.Tensor, ls_in: torch.Tensor, cs: ContactState,
                    num_cars: int, velocity_iters: int = C.VELOCITY_ITERS,
                    position_iters: int = C.POSITION_ITERS):
    """Launch K2 on packed car rows (from :func:`pack_inputs`, car index
    e*num_cars + n) and the contact carry, on the current stream; returns
    (fout (59, n), ls_out (4, n), new ContactState). Counts the launch in
    ``island_step.contact_launches``.

    K2 is two kernels on the stream: the far pass (one thread per car) and
    the near pass (one warp per near env, from a list the far pass fills on
    the card). The list's count stays on the card, in the int32 tensor
    ``launch_contacts.near_count`` of the last call; nothing here reads it."""
    dev = fin.device
    n_cars = fin.shape[1]
    E = n_cars // num_cars
    if (fin.dtype != torch.float32 or ls_in.dtype != torch.int32 or dev.type != "cuda"
            or ls_in.device != dev or not fin.is_contiguous() or not ls_in.is_contiguous()
            or num_cars < 2 or E * num_cars != n_cars
            or tuple(fin.shape) != (IN_ROWS["N_IN"], n_cars)
            or tuple(ls_in.shape) != (4, n_cars)):
        raise ValueError("launch_contacts: expects contiguous CUDA float32 (71, E*N) rows "
                         "and int32 (4, E*N) limit states, N >= 2")
    mm = _check_contacts(cs, E, num_cars, dev)
    pni, pti, pids = (cs.normal_imp.contiguous(), cs.tangent_imp.contiguous(),
                      cs.ids.contiguous())
    lib = _library(CONTACT_KERNEL)
    ctab, itab = _contact_tables(dev, num_cars)
    fout = torch.empty((OUT_ROWS["N_OUT"], n_cars), dtype=torch.float32, device=dev)
    ls_out = torch.empty((4, n_cars), dtype=torch.int32, device=dev)
    new = ContactState(normal_imp=torch.empty_like(pni), tangent_imp=torch.empty_like(pti),
                       ids=torch.empty_like(pids))
    near_list = torch.empty(E, dtype=torch.int32, device=dev)
    near_count = torch.empty(1, dtype=torch.int32, device=dev)
    k_vel = min(C.CONTACT_VELOCITY_ITERS, velocity_iters)
    k_pos = min(C.CONTACT_POSITION_ITERS, position_iters)
    with torch.cuda.device(dev):      # the stream and the launch belong to dev
        rc = lib.contact_island_launch(
            fin.data_ptr(), ls_in.data_ptr(), pni.data_ptr(), pti.data_ptr(),
            pids.data_ptr(), fout.data_ptr(), ls_out.data_ptr(),
            new.normal_imp.data_ptr(), new.tangent_imp.data_ptr(), new.ids.data_ptr(),
            _params(dev).data_ptr(), ctab.data_ptr(), itab.data_ptr(),
            near_list.data_ptr(), near_count.data_ptr(),
            E, num_cars, mm, int(velocity_iters), int(position_iters), k_vel, k_pos,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.contact_island_error_string(rc).decode()
        raise RuntimeError(f"contact_island launch failed: {msg} ({rc})")
    island_step.contact_launches += 1
    launch_contacts.near_count = near_count
    return fout, ls_out, new


def island_step(cars: CarState, wheel_on_road: torch.Tensor,
                contact_state: ContactState,
                velocity_iters: int = C.VELOCITY_ITERS,
                position_iters: int = C.POSITION_ITERS):
    """The island for every (env, car): K1 (one car per env) or K2 (two or
    more) on CUDA tensors, ``island_step_plain`` on CPU tensors.

    Returns (new CarState, skid (E, N, 4) bool, new ContactState)."""
    dev = cars.hull_a.device
    if dev.type == "cpu":
        return island_step_plain(cars, wheel_on_road, contact_state, velocity_iters,
                                 position_iters)
    if dev.type != "cuda":
        raise ValueError(f"island_step: unsupported device {dev}")
    E, N = _check(cars, wheel_on_road)
    fin, ls_in = pack_inputs(cars, wheel_on_road)
    if N == 1:
        fout, ls_out = launch(fin, ls_in, E * N, velocity_iters, position_iters)
        new_cs = contact_state
    else:
        fout, ls_out, new_cs = launch_contacts(fin, ls_in, contact_state, N,
                                               velocity_iters, position_iters)
    new_cars, skid = unpack_outputs(cars, fout, ls_out)
    return new_cars, skid, new_cs


island_step.launches = 0
island_step.contact_launches = 0
launch_contacts.near_count = None


# ---------------------------------------------------------------------------
# K3 (csrc/solve_island.cu): the solve alone, from a ContactBundle.
# ---------------------------------------------------------------------------

SOLVE_KERNEL = "solve_island"

# Row offsets of K3's packed (rows, E*N) input, a car after the tire model;
# equal to the constexprs SIN_* in csrc/car_chain.cuh. Its output is the
# first N_SOLVE_OUT rows of OUT_ROWS (hull, wheels, joints).
SOLVE_IN_ROWS = dict(SIN_HULL=0, SIN_WHEEL=6, SIN_FORCE=30, SIN_MSPEED=38, SIN_JNT=42,
                     N_SIN=58)
N_SOLVE_OUT = OUT_ROWS["OUT_TIRE"]
FLOPS_FORCE_INTEGRATION = 4 * 4     # per car: wv += (dt * MB) * force, 4 wheels x 2 axes


def solve_island_flops(n_cars: int, n_limit_joints: int, n_live_points: int,
                       n_touched_bodies: int, velocity_iters: int = C.VELOCITY_ITERS,
                       position_iters: int = C.POSITION_ITERS,
                       contact_velocity_iters: int = C.CONTACT_VELOCITY_ITERS,
                       contact_position_iters: int = C.CONTACT_POSITION_ITERS) -> int:
    """fp32 operations of one K3 call on this call's data
    (:func:`solve_island_work` counts the last two arguments): K2's count
    without the tire model, the broadphase and the Collide pass, with the
    force integration."""
    k_vel = min(contact_velocity_iters, velocity_iters)
    k_pos = min(contact_position_iters, position_iters)
    return (island_flops(n_cars, n_limit_joints, velocity_iters, position_iters)
            - n_cars * 4 * 117 + n_cars * FLOPS_FORCE_INTEGRATION
            + n_live_points * (FLOPS_POINT_BUNDLE + FLOPS_POINT_WARM
                               + k_vel * FLOPS_POINT_VEL + k_pos * FLOPS_POINT_POS)
            + n_touched_bodies * FLOPS_BODY_UPDATE * (1 + 2 * k_vel + k_pos))


def solve_live_envs(bundle: collide.ContactBundle | None, num_envs: int) -> torch.Tensor:
    """(E,) bool: the envs whose bundle rows hold a live contact point (any
    point_ok set), which K3's list pass lists for its solve pass; all
    False (on the CPU) without a bundle. The plain version of the list
    pass's test, for tests and chip_smoke.py; the card path never calls it."""
    if bundle is None:
        return torch.zeros(num_envs, dtype=torch.bool)
    return bundle.man.point_ok.reshape(num_envs, -1).any(1)


def solve_island_work(bundle: collide.ContactBundle | None, num_cars: int) -> dict:
    """What K3's contact work depends on in this bundle: live contact points
    and, per point index, the bodies that they touch (zero without one)."""
    if bundle is None:
        return dict(n_live_points=0, n_touched_bodies=0)
    counts = _live_counts(bundle.man.point_ok, num_cars)
    return dict(n_live_points=counts["n_live_points"],
                n_touched_bodies=counts["n_touched_bodies"])


# Bytes of one bundle row that K3 reads (normal 2, points 4, separations 2,
# warm impulses 4 floats; point_ok 2 bytes) and writes (4 impulse floats).
SOLVE_ROW_BYTES = 12 * 4 + 2 + 4 * 4


def solve_island_bytes(n_cars: int, n_rows: int) -> int:
    """Bytes K3 must move: each car's packed input rows and limit states read
    once and its solved rows and limit states written once, and each of the
    ``n_rows`` = E * MM bundle rows read once and its impulses written once."""
    return (n_cars * 4 * (SOLVE_IN_ROWS["N_SIN"] + 4 + N_SOLVE_OUT + 4)
            + n_rows * SOLVE_ROW_BYTES)


def pack_solve_inputs(cars: CarState, wheel_force: torch.Tensor, motor_speed: torch.Tensor):
    """A car after the tire model, its wheel forces (E, N, 4, 2) and servo
    speeds (E, N, 4) -> K3's (58, E*N) float32 rows and (4, E*N) int32 limit
    states, both contiguous, car index e*N + n."""
    E, N = cars.hull_a.shape

    def w4(x):                                   # (E, N, 4) -> (4, E, N)
        return x.permute(2, 0, 1)

    fin = torch.cat([
        cars.hull_v.permute(2, 0, 1), cars.hull_w[None],
        cars.hull_c.permute(2, 0, 1), cars.hull_a[None],
        w4(cars.wheel_v[..., 0]), w4(cars.wheel_v[..., 1]), w4(cars.wheel_w),
        w4(cars.wheel_c[..., 0]), w4(cars.wheel_c[..., 1]), w4(cars.wheel_a),
        w4(wheel_force[..., 0]), w4(wheel_force[..., 1]), w4(motor_speed),
        w4(cars.joint_impulse[..., 0]), w4(cars.joint_impulse[..., 1]),
        w4(cars.joint_impulse[..., 2]), w4(cars.motor_impulse),
    ]).reshape(SOLVE_IN_ROWS["N_SIN"], E * N)
    ls_in = w4(cars.limit_state).reshape(4, E * N).contiguous()
    return fin.contiguous(), ls_in


def _bundle_specs(bundle: collide.ContactBundle, E: int, mm: int):
    f32 = torch.float32
    man = bundle.man
    return (("normal", man.normal, f32, (E, mm, 2)),
            ("point", man.point, f32, (E, mm, 2, 2)),
            ("separation", man.separation, f32, (E, mm, 2)),
            ("point_ok", man.point_ok, torch.bool, (E, mm, 2)),
            ("normal_imp", bundle.normal_imp, f32, (E, mm, 2)),
            ("tangent_imp", bundle.tangent_imp, f32, (E, mm, 2)))


def launch_solve(fin: torch.Tensor, ls_in: torch.Tensor,
                 bundle: collide.ContactBundle | None, num_cars: int,
                 velocity_iters: int = C.VELOCITY_ITERS,
                 position_iters: int = C.POSITION_ITERS,
                 contact_velocity_iters: int = C.CONTACT_VELOCITY_ITERS,
                 contact_position_iters: int = C.CONTACT_POSITION_ITERS,
                 dt: float = C.DT):
    """Launch K3 on packed car rows (from :func:`pack_solve_inputs`, car
    index e*num_cars + n) and a bundle's rows (or none: the joints-only
    island), on the current stream. Every input must already be contiguous
    on the card, and point_ok on a 16-byte boundary (as the allocator
    places a tensor): the wrapper raises rather than copying. Returns (fout
    (46, n), ls_out (4, n), normal_imp, tangent_imp), the impulses (E, MM, 2)
    or None without a bundle. Counts the call in
    ``world_step_batched.launches``.

    K3 is two kernels on the stream: with a bundle, the list pass (one
    thread per env: the envs with a live contact point, listed on the card),
    then the solve pass (the joints-only chain of every car of the other
    envs, one thread per car, beside one warp per listed env). The last
    call's list and count stay on the card, in the int32 tensors
    ``launch_solve.live_list`` (E) and ``launch_solve.live_count`` (1; the
    list's first count entries are the live envs, in no fixed order);
    nothing here reads them."""
    dev = fin.device
    n_cars = fin.shape[1] if fin.dim() == 2 else -1
    E = n_cars // num_cars if num_cars > 0 else 0
    if dev.type != "cuda" or num_cars < 1 or E * num_cars != n_cars:
        raise ValueError("launch_solve: expects CUDA (58, E*N) rows with N >= 1 cars per env")
    _check_tensors("launch_solve", dev, (
        ("fin", fin, torch.float32, (SOLVE_IN_ROWS["N_SIN"], n_cars)),
        ("ls_in", ls_in, torch.int32, (4, n_cars))))
    mm = 0
    if bundle is not None:
        if num_cars < 2:
            raise ValueError("launch_solve: car-car contacts need two or more cars per env")
        mm = len(collide.car_pairs(num_cars)) * collide.M_PER_PAIR
        _check_tensors("launch_solve", dev, _bundle_specs(bundle, E, mm))
        if bundle.man.point_ok.data_ptr() % 16:     # K3 reads it in 16-byte words
            raise ValueError("launch_solve: point_ok must start on a 16-byte boundary")
    lib = _library(SOLVE_KERNEL)
    fout = torch.empty((N_SOLVE_OUT, n_cars), dtype=torch.float32, device=dev)
    ls_out = torch.empty((4, n_cars), dtype=torch.int32, device=dev)
    live_list = torch.empty(E, dtype=torch.int32, device=dev)
    live_count = torch.empty(1, dtype=torch.int32, device=dev)
    if bundle is None:
        ni = ti = None
        rows = [0] * 6
        ctab_p = itab_p = ni_p = ti_p = 0
    else:
        man = bundle.man
        ni = torch.empty((E, mm, 2), dtype=torch.float32, device=dev)
        ti = torch.empty_like(ni)
        rows = [t.data_ptr() for t in (man.normal, man.point, man.separation, man.point_ok,
                                       bundle.normal_imp, bundle.tangent_imp)]
        ctab, itab = _contact_tables(dev, num_cars)
        ctab_p, itab_p, ni_p, ti_p = ctab.data_ptr(), itab.data_ptr(), ni.data_ptr(), ti.data_ptr()
    k_vel = min(contact_velocity_iters, velocity_iters)
    k_pos = min(contact_position_iters, position_iters)
    with torch.cuda.device(dev):      # the stream and the launch belong to dev
        rc = lib.solve_island_launch(
            fin.data_ptr(), ls_in.data_ptr(), *rows, fout.data_ptr(), ls_out.data_ptr(),
            ni_p, ti_p, _params(dev, dt).data_ptr(), ctab_p, itab_p,
            live_list.data_ptr(), live_count.data_ptr(),
            E, num_cars, mm, int(velocity_iters), int(position_iters), int(k_vel), int(k_pos),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        msg = lib.solve_island_error_string(rc).decode()
        raise RuntimeError(f"solve_island launch failed: {msg} ({rc})")
    world_step_batched.launches += 1
    launch_solve.live_list, launch_solve.live_count = live_list, live_count
    return fout, ls_out, ni, ti


def world_step_batched(cars: CarState, wheel_force: torch.Tensor, motor_speed: torch.Tensor,
                       bundle: collide.ContactBundle | None, num_cars: int,
                       velocity_iters: int = C.VELOCITY_ITERS,
                       position_iters: int = C.POSITION_ITERS,
                       contact_velocity_iters: int = C.CONTACT_VELOCITY_ITERS,
                       contact_position_iters: int = C.CONTACT_POSITION_ITERS,
                       dt: float = C.DT):
    """The island solve of every env from manifolds computed outside: cars
    after the tire model (E, N, ...), their wheel forces (E, N, 4, 2) and
    servo speeds (E, N, 4), and a ContactBundle (E, MM, ...) or None. K3 on
    CUDA tensors, ``world.world_step`` on the same bundle on CPU tensors.

    Returns (new CarState, (normal_imp, tangent_imp) (E, MM, 2) or None):
    the same results as the JAX package's ``pallas_world.world_step_batched``
    and ``vmap(world.world_step)`` up to float noise. A call on the card
    makes two launches with a bundle (K3's list pass and solve pass) and
    one without (the solve pass); ``world_step_batched.launches`` counts
    calls."""
    dev = cars.hull_a.device
    if cars.hull_a.shape[1] != num_cars:
        raise ValueError(f"world_step_batched: cars hold {cars.hull_a.shape[1]} cars per "
                         f"env, num_cars is {num_cars}")
    if dev.type == "cpu":
        new, out = world.world_step(cars, wheel_force, motor_speed, dt, velocity_iters,
                                    position_iters, contacts=bundle,
                                    contact_velocity_iters=contact_velocity_iters,
                                    contact_position_iters=contact_position_iters)
        return new, None if out is None else (out.normal_imp, out.tangent_imp)
    if dev.type != "cuda":
        raise ValueError(f"world_step_batched: unsupported device {dev}")
    E, N = cars.hull_a.shape
    f32 = torch.float32
    _check_tensors("world_step_batched", dev, (
        ("wheel_force", wheel_force, f32, (E, N, 4, 2)),
        ("motor_speed", motor_speed, f32, (E, N, 4))), contiguous=False)
    fin, ls_in = pack_solve_inputs(cars, wheel_force, motor_speed)
    fout, ls_out, ni, ti = launch_solve(fin, ls_in, bundle, num_cars, velocity_iters,
                                        position_iters, contact_velocity_iters,
                                        contact_position_iters, dt)
    new = cars.replace(**_solved_fields(fout, ls_out, E, N))
    return new, None if bundle is None else (ni, ti)


world_step_batched.launches = 0
launch_solve.live_list = launch_solve.live_count = None
