"""Revolute steering-joint solver (Box2D 2.3.5 ``b2RevoluteJoint`` semantics).

Port of the JAX package's ``physics/joints.py`` over ``(E, N, 4)`` joints.
Each car is a 5-body island: hull (A) + 4 wheels (B_k), joined by revolute
joints at ``WHEELPOS*SIZE`` with motor (torque cap 64.8) and angle limits
±0.4 (cd:122-134). Warm starting, the motor impulse clamp, the 2x2 point
solve, the 3x3 point+limit solve with the accumulated-z clamp, and the
slop/Baumgarte position correction run with Gauss-Seidel ordering across a
car's four joints (hull state updates between joints).

The wheel's local anchor and local center are both the wheel origin, so
rB == 0 everywhere.

Eager PyTorch pays a dispatch per operation, so the iteration loops work on
per-joint component tensors (``x``/``y`` split, one tensor per joint) and the
terms that are fixed for a whole velocity phase (the K matrix, its cofactors
and inverse determinants, the limit masks) are computed once per step in
:func:`init_constraints`. Both are the same arithmetic as the JAX version,
which recomputes them every iteration.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import config as C
from . import shapes
from .state import CarState

_MA = float(shapes.HULL_INV_MASS)
_IA = float(shapes.HULL_INV_I)
_MB = float(shapes.WHEEL_INV_MASS)
_IB = float(shapes.WHEEL_INV_I)
_MOTOR_MASS = 1.0 / (_IA + _IB)

INACTIVE, AT_LOWER, AT_UPPER = 0, 1, 2

# Hull anchor arms in the hull's local frame, evaluated in float32 as the JAX
# solver does (anchor - local center, both cast first).
_ARM = (shapes.WHEEL_POS.astype(np.float32)
        - shapes.HULL_LOCAL_CENTER.astype(np.float32)[None, :])
ARM_X = tuple(float(v) for v in _ARM[:, 0])
ARM_Y = tuple(float(v) for v in _ARM[:, 1])


class _Consts(NamedTuple):
    """The constants of the iteration loops as 0-dim float32 tensors on the
    solver's device: an eager op with one costs about half what it costs
    with a Python float (wrapped anew on every call), for the same float32
    arithmetic."""
    ma: torch.Tensor
    ia: torch.Tensor
    mb: torch.Tensor
    ib: torch.Tensor
    ma_mb: torch.Tensor
    neg_ia: torch.Tensor
    neg_motor_mass: torch.Tensor
    arm_x: tuple
    arm_y: tuple


_consts_cache: dict = {}


def _consts(device: torch.device) -> _Consts:
    key = str(device)
    if key not in _consts_cache:
        def f(v):
            return torch.tensor(v, dtype=torch.float32, device=device)
        _consts_cache[key] = _Consts(
            ma=f(_MA), ia=f(_IA), mb=f(_MB), ib=f(_IB), ma_mb=f(_MA + _MB),
            neg_ia=f(-_IA), neg_motor_mass=f(-_MOTOR_MASS),
            arm_x=tuple(f(v) for v in ARM_X), arm_y=tuple(f(v) for v in ARM_Y),
        )
    return _consts_cache[key]


class Velocities(NamedTuple):
    hull_v: torch.Tensor   # (E, N, 2)
    hull_w: torch.Tensor   # (E, N)
    wheel_v: torch.Tensor  # (E, N, 4, 2)
    wheel_w: torch.Tensor  # (E, N, 4)


class Positions(NamedTuple):
    hull_c: torch.Tensor   # (E, N, 2)
    hull_a: torch.Tensor   # (E, N)
    wheel_c: torch.Tensor  # (E, N, 4, 2)
    wheel_a: torch.Tensor  # (E, N, 4)


class _Coef(NamedTuple):
    """Per-joint terms that stay fixed over a velocity phase, each (E, N)."""
    rax: torch.Tensor
    ray: torch.Tensor
    k11: torch.Tensor
    k12: torch.Tensor
    k22: torch.Tensor
    ez_x: torch.Tensor
    ez_y: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    cz: torch.Tensor
    inv_det: torch.Tensor
    cy2x: torch.Tensor
    cy2y: torch.Tensor
    cy2z: torch.Tensor
    cz3x: torch.Tensor
    cz3y: torch.Tensor
    cz3z: torch.Tensor
    inv22: torch.Tensor
    at_lower: torch.Tensor   # bool
    at_upper: torch.Tensor   # bool
    active: torch.Tensor     # bool
    any_active: bool         # some car has this joint's limit active
    motor_speed: torch.Tensor


class JointData(NamedTuple):
    """Per-step constants computed by InitVelocityConstraints."""
    r_a: torch.Tensor          # (E, N, 4, 2) hull anchor arm (world frame)
    limit_state: torch.Tensor  # (E, N, 4) int32
    motor_speed: torch.Tensor  # (E, N, 4)
    coef: tuple                # 4 x _Coef, one per joint


def _inv(det):
    """``where(det != 0, 1/det, 0)`` — a select, never a masked division."""
    return torch.where(det != 0.0, torch.reciprocal(det), torch.zeros_like(det))


def _k_matrix(rx, ry):
    """Point-constraint effective-mass 2x2 (symmetric) given rB = 0."""
    k11 = _MA + _MB + _IA * ry * ry
    k12 = -_IA * rx * ry
    k22 = _MA + _MB + _IA * rx * rx
    return k11, k12, k22


def _coef(rax, ray, ls, motor_speed) -> _Coef:
    k11, k12, k22 = _k_matrix(rax, ray)
    active = ls != INACTIVE
    ez_x = -_IA * ray
    ez_y = _IA * rax
    ez_z = _IA + _IB
    cx = k22 * ez_z - ez_y * ez_y
    cy = ez_y * ez_x - k12 * ez_z
    cz = k12 * ez_y - k22 * ez_x
    det = k11 * cx + k12 * cy + ez_x * cz
    return _Coef(
        rax=rax, ray=ray, k11=k11, k12=k12, k22=k22, ez_x=ez_x, ez_y=ez_y,
        cx=cx, cy=cy, cz=cz, inv_det=_inv(det),
        cy2x=ez_x * ez_y - k12 * ez_z,
        cy2y=k11 * ez_z - ez_x * ez_x,
        cy2z=k12 * ez_x - k11 * ez_y,
        cz3x=k12 * ez_y - k22 * ez_x,
        cz3y=k12 * ez_x - k11 * ez_y,
        cz3z=k11 * k22 - k12 * k12,
        inv22=_inv(k11 * k22 - k12 * k12),
        at_lower=ls == AT_LOWER, at_upper=ls == AT_UPPER,
        active=active, any_active=bool(active.any()), motor_speed=motor_speed,
    )


def init_constraints(state: CarState, motor_speed: torch.Tensor):
    """b2RevoluteJoint::InitVelocityConstraints (the parts that persist):
    anchor arms, limit-state transition (zeroing the accumulated limit
    impulse on entry/exit), over all (E, N, 4) joints."""
    s = torch.sin(state.hull_a)[..., None]
    c = torch.cos(state.hull_a)[..., None]
    ax = torch.tensor(ARM_X, dtype=s.dtype, device=s.device)
    ay = torch.tensor(ARM_Y, dtype=s.dtype, device=s.device)
    rax = c * ax - s * ay
    ray = s * ax + c * ay
    r_a = torch.stack([rax, ray], dim=-1)                   # (E, N, 4, 2)

    joint_angle = state.wheel_a - state.hull_a[..., None]
    new_ls = torch.where(
        joint_angle <= C.STEER_JOINT_LOWER, AT_LOWER,
        torch.where(joint_angle >= C.STEER_JOINT_UPPER, AT_UPPER, INACTIVE),
    ).to(torch.int32)
    # impulse.z survives only while staying in the same active limit state.
    keep_z = (new_ls == state.limit_state) & (new_ls != INACTIVE)
    imp = state.joint_impulse
    z = torch.where(keep_z, imp[..., 2], torch.zeros_like(imp[..., 2]))
    imp = torch.cat([imp[..., 0:2], z[..., None]], dim=-1)

    coef = tuple(
        _coef(rax[..., k], ray[..., k], new_ls[..., k], motor_speed[..., k])
        for k in range(4)
    )
    state = state.replace(limit_state=new_ls, joint_impulse=imp)
    return state, JointData(r_a=r_a, limit_state=new_ls,
                            motor_speed=motor_speed, coef=coef)


def warm_start(vel: Velocities, data: JointData, joint_imp, motor_imp) -> Velocities:
    """Apply accumulated impulses (dtRatio == 1: fixed dt)."""
    hull_v, hull_w, wheel_v, wheel_w = vel
    p = joint_imp[..., 0:2]                              # (E, N, 4, 2)
    ang = motor_imp + joint_imp[..., 2]
    cross = data.r_a[..., 0] * p[..., 1] - data.r_a[..., 1] * p[..., 0]
    hull_v = hull_v - _MA * torch.sum(p, dim=-2)
    hull_w = hull_w - _IA * torch.sum(cross + ang, dim=-1)
    wheel_v = wheel_v + _MB * p
    wheel_w = wheel_w + _IB * ang
    return Velocities(hull_v, hull_w, wheel_v, wheel_w)


# ---------------------------------------------------------------------------
# Component form used inside the iteration loops. A velocity carry is
# [hvx, hvy, hw, wvx[4], wvy[4], ww[4], jix[4], jiy[4], jiz[4], mimp[4]].
# ---------------------------------------------------------------------------

def split_velocities(vel: Velocities, joint_imp, motor_imp):
    return [
        vel.hull_v[..., 0], vel.hull_v[..., 1], vel.hull_w,
        list(vel.wheel_v[..., 0].unbind(-1)), list(vel.wheel_v[..., 1].unbind(-1)),
        list(vel.wheel_w.unbind(-1)),
        list(joint_imp[..., 0].unbind(-1)), list(joint_imp[..., 1].unbind(-1)),
        list(joint_imp[..., 2].unbind(-1)), list(motor_imp.unbind(-1)),
    ]


def join_velocities(carry):
    hvx, hvy, hw, wvx, wvy, ww, jix, jiy, jiz, mimp = carry
    vel = Velocities(
        hull_v=torch.stack([hvx, hvy], dim=-1), hull_w=hw,
        wheel_v=torch.stack([torch.stack(wvx, -1), torch.stack(wvy, -1)], dim=-1),
        wheel_w=torch.stack(ww, -1),
    )
    joint_imp = torch.stack(
        [torch.stack(jix, -1), torch.stack(jiy, -1), torch.stack(jiz, -1)], dim=-1
    )
    return vel, joint_imp, torch.stack(mimp, -1)


def velocity_iteration(carry, data: JointData, dt: float):
    """One velocity iteration on a component carry, joints in order."""
    hvx, hvy, hw, wvx, wvy, ww, jix, jiy, jiz, mimp = carry
    wvx, wvy, ww = list(wvx), list(wvy), list(ww)
    jix, jiy, jiz, mimp = list(jix), list(jiy), list(jiz), list(mimp)
    K = _consts(hvx.device)
    max_motor = dt * C.STEER_JOINT_MAX_MOTOR_TORQUE
    for k in range(4):
        c = data.coef[k]
        # --- Motor (always enabled; limits are not equal).
        cdot = ww[k] - hw - c.motor_speed
        imp = K.neg_motor_mass * cdot
        old = mimp[k]
        new = torch.clamp(old + imp, -max_motor, max_motor)
        imp = new - old
        mimp[k] = new
        hw = hw - K.ia * imp
        ww[k] = ww[k] + K.ib * imp

        # --- Point + (maybe) limit; cdot1 = w_v - hull_v - hull_w x r_a.
        bx = wvx[k] - hvx + hw * c.ray
        by = wvy[k] - hvy - hw * c.rax
        # 2x2 point-only solve (limit inactive); k22*-bx - k12*-by is
        # k12*by - k22*bx exactly.
        pt_x = c.inv22 * (c.k12 * by - c.k22 * bx)
        pt_y = c.inv22 * (c.k12 * bx - c.k11 * by)
        if c.any_active:
            bz = ww[k] - hw
            ix = -c.inv_det * (bx * c.cx + by * c.cy + bz * c.cz)
            iy = -c.inv_det * (bx * c.cy2x + by * c.cy2y + bz * c.cy2z)
            iz = -c.inv_det * (bx * c.cz3x + by * c.cz3y + bz * c.cz3z)

            acc_z = jiz[k]
            new_z = acc_z + iz
            clampdown = (c.at_lower & (new_z < 0.0)) | (c.at_upper & (new_z > 0.0))
            # Reduced solve when the limit impulse unwinds to zero.
            rhs_x = -bx + acc_z * c.ez_x
            rhs_y = -by + acc_z * c.ez_y
            red_x = c.inv22 * (c.k22 * rhs_x - c.k12 * rhs_y)
            red_y = c.inv22 * (c.k11 * rhs_y - c.k12 * rhs_x)

            imp_x = torch.where(c.active, torch.where(clampdown, red_x, ix), pt_x)
            imp_y = torch.where(c.active, torch.where(clampdown, red_y, iy), pt_y)
            imp_z = torch.where(
                c.active, torch.where(clampdown, -acc_z, iz), torch.zeros_like(iz)
            )
            jiz[k] = torch.where(
                c.active, torch.where(clampdown, torch.zeros_like(new_z), new_z), acc_z
            )
            hw = hw - K.ia * (c.rax * imp_y - c.ray * imp_x + imp_z)
            ww[k] = ww[k] + K.ib * imp_z
        else:
            # No car has this limit active: every select above picks the
            # point-only solve and imp_z == 0, so those terms drop out.
            imp_x, imp_y = pt_x, pt_y
            hw = hw - K.ia * (c.rax * imp_y - c.ray * imp_x)
        jix[k] = jix[k] + imp_x
        jiy[k] = jiy[k] + imp_y
        hvx = hvx - K.ma * imp_x
        hvy = hvy - K.ma * imp_y
        wvx[k] = wvx[k] + K.mb * imp_x
        wvy[k] = wvy[k] + K.mb * imp_y
    return [hvx, hvy, hw, wvx, wvy, ww, jix, jiy, jiz, mimp]


def solve_velocity(vel: Velocities, data: JointData, joint_imp, motor_imp, dt: float):
    """One velocity iteration: the four joints of each car solved
    sequentially (Gauss-Seidel), all cars in parallel."""
    carry = velocity_iteration(split_velocities(vel, joint_imp, motor_imp), data, dt)
    return join_velocities(carry)


def split_positions(pos: Positions):
    return [
        pos.hull_c[..., 0], pos.hull_c[..., 1], pos.hull_a,
        list(pos.wheel_c[..., 0].unbind(-1)), list(pos.wheel_c[..., 1].unbind(-1)),
        list(pos.wheel_a.unbind(-1)),
    ]


def join_positions(carry) -> Positions:
    hcx, hcy, ha, wcx, wcy, wa = carry
    return Positions(
        hull_c=torch.stack([hcx, hcy], dim=-1), hull_a=ha,
        wheel_c=torch.stack([torch.stack(wcx, -1), torch.stack(wcy, -1)], dim=-1),
        wheel_a=torch.stack(wa, -1),
    )


def position_iteration(carry, data: JointData):
    """One position iteration (b2RevoluteJoint::SolvePositionConstraints) on
    a component carry [hcx, hcy, ha, wcx[4], wcy[4], wa[4]]."""
    hcx, hcy, ha, wcx, wcy, wa = carry
    wcx, wcy, wa = list(wcx), list(wcy), list(wa)
    K = _consts(hcx.device)
    for k in range(4):
        c = data.coef[k]
        # --- Limit correction (a zero impulse where no limit is active, so
        # it is skipped when no car has this joint's limit active).
        if c.any_active:
            angle = wa[k] - ha
            c_low = torch.clamp(
                angle - C.STEER_JOINT_LOWER + C.B2_ANGULAR_SLOP,
                -C.B2_MAX_ANGULAR_CORRECTION, 0.0,
            )
            c_up = torch.clamp(
                angle - C.STEER_JOINT_UPPER - C.B2_ANGULAR_SLOP,
                0.0, C.B2_MAX_ANGULAR_CORRECTION,
            )
            c_lim = torch.where(
                c.at_lower, c_low, torch.where(c.at_upper, c_up, torch.zeros_like(c_up))
            )
            limit_impulse = -_MOTOR_MASS * c_lim
            ha = ha - _IA * limit_impulse
            wa[k] = wa[k] + _IB * limit_impulse

        # --- Point correction (anchors re-derived from updated angles).
        s, co = torch.sin(ha), torch.cos(ha)
        rax = co * K.arm_x[k] - s * K.arm_y[k]
        ray = s * K.arm_x[k] + co * K.arm_y[k]
        cvx = wcx[k] - hcx - rax
        cvy = wcy[k] - hcy - ray
        k11 = K.ma_mb + K.ia * ray * ray          # _k_matrix(rax, ray)
        k12 = K.neg_ia * rax * ray
        k22 = K.ma_mb + K.ia * rax * rax
        inv = _inv(k11 * k22 - k12 * k12)
        px = inv * (k12 * cvy - k22 * cvx)      # k22*-cvx - k12*-cvy, exactly
        py = inv * (k12 * cvx - k11 * cvy)
        hcx = hcx - K.ma * px
        hcy = hcy - K.ma * py
        ha = ha - K.ia * (rax * py - ray * px)
        wcx[k] = wcx[k] + K.mb * px
        wcy[k] = wcy[k] + K.mb * py
        # wheel angle unchanged: cross(rB, P) = 0.
    return [hcx, hcy, ha, wcx, wcy, wa]


def solve_position(pos: Positions, data: JointData) -> Positions:
    """One position iteration, joints of a car sequential, cars parallel."""
    return join_positions(position_iteration(split_positions(pos), data))
