"""World step: velocity integration + constraint solve + position integration.

Port of the JAX package's ``physics/world.py``: the equivalent of
``world.Step(1/50, 180, 60)`` (mcr:428) for one hull and four wheels per car
joined by revolute joints, car-car polygon contacts (``collide.py``) at two
or more cars per env, and *no* collision response with track tiles (they are
sensors). Gravity and body damping are zero.

Box2D's b2Island order is preserved:
  1. v += dt * invM * F (tire forces on wheels only; hulls receive none)
  2. contact warm start, then joint init/warm-start
  3. velocity iterations: joints (Gauss-Seidel per car), then contacts
  4. position integration with maxTranslation/maxRotation clamps
  5. position iterations: contacts, then joints
"""

from __future__ import annotations

import torch

from .. import config as C
from . import collide, joints, shapes
from .state import CarState
from .joints import Velocities


def _clamp_v(v, w, dt):
    """Box2D's per-step translation/rotation clamps on (v (...,2), w (...))."""
    tr = dt * v
    tr2 = torch.sum(tr * tr, dim=-1)
    scale_t = torch.where(
        tr2 > C.B2_MAX_TRANSLATION ** 2,
        C.B2_MAX_TRANSLATION / torch.sqrt(torch.clamp(tr2, min=1e-30)),
        torch.ones_like(tr2),
    )
    rot = dt * w
    scale_r = torch.where(
        rot * rot > C.B2_MAX_ROTATION ** 2,
        C.B2_MAX_ROTATION / torch.clamp(torch.abs(rot), min=1e-30),
        torch.ones_like(rot),
    )
    return v * scale_t[..., None], w * scale_r


def world_step(
    state: CarState,
    wheel_force: torch.Tensor,    # (E, N, 4, 2) from the tire model
    motor_speed: torch.Tensor,    # (E, N, 4) steering servo speeds
    dt: float = C.DT,
    velocity_iters: int = C.VELOCITY_ITERS,
    position_iters: int = C.POSITION_ITERS,
    contacts: collide.ContactBundle | None = None,
    contact_velocity_iters: int = C.CONTACT_VELOCITY_ITERS,
    contact_position_iters: int = C.CONTACT_POSITION_ITERS,
) -> tuple[CarState, collide.ContactBundle | None]:
    """Returns (new CarState, ``contacts`` with the solved impulses for the
    warm-start carry); ``contacts`` is a ContactBundle at two or more cars
    per env, or None for the joints-only island (returned as None).

    The first ``contact_velocity_iters`` velocity iterations run joints then
    contacts, the rest joints only; the first ``contact_position_iters``
    position iterations run contacts then joints (both default to the full
    counts, ``C.CONTACT_*_ITERS``: contacts interleave throughout)."""
    n_cars = state.hull_a.shape[1]
    if contacts is not None and n_cars < 2:
        raise ValueError("world_step: car-car contacts need two or more cars per env")
    # --- 1. integrate velocities (forces only on wheels).
    vel = Velocities(
        hull_v=state.hull_v,
        hull_w=state.hull_w,
        wheel_v=state.wheel_v + dt * float(shapes.WHEEL_INV_MASS) * wheel_force,
        wheel_w=state.wheel_w,
    )

    # --- 2. init + warm start (contacts first, then joints: b2Island order).
    if contacts is not None:
        vel = collide.warm_start(vel, contacts, n_cars)
    state, jdata = joints.init_constraints(state, motor_speed)
    vel = joints.warm_start(vel, jdata, state.joint_impulse, state.motor_impulse)

    # --- 3. velocity iterations.
    k_vel = min(contact_velocity_iters, velocity_iters) if contacts is not None else 0
    carry = joints.split_velocities(vel, state.joint_impulse, state.motor_impulse)
    if k_vel:
        n_imp, t_imp = contacts.normal_imp, contacts.tangent_imp
        for _ in range(k_vel):
            carry = joints.velocity_iteration(carry, jdata, dt)
            vel, j_imp, m_imp = joints.join_velocities(carry)
            vel, n_imp, t_imp = collide.velocity_pass(vel, n_imp, t_imp, contacts, n_cars)
            carry = joints.split_velocities(vel, j_imp, m_imp)
        contacts = contacts.replace(normal_imp=n_imp, tangent_imp=t_imp)
    for _ in range(velocity_iters - k_vel):
        carry = joints.velocity_iteration(carry, jdata, dt)
    vel, j_imp, m_imp = joints.join_velocities(carry)

    # --- 4. integrate positions with Box2D's translation/rotation clamps.
    hv, hw = _clamp_v(vel.hull_v, vel.hull_w, dt)
    wv, ww = _clamp_v(vel.wheel_v, vel.wheel_w, dt)
    pos = joints.Positions(
        hull_c=state.hull_c + dt * hv,
        hull_a=state.hull_a + dt * hw,
        wheel_c=state.wheel_c + dt * wv,
        wheel_a=state.wheel_a + dt * ww,
    )

    # --- 5. position iterations (contacts then joints, like b2Island).
    k_pos = min(contact_position_iters, position_iters) if contacts is not None else 0
    for _ in range(k_pos):
        pos = collide.position_pass(pos, contacts, n_cars)
        pos = joints.join_positions(
            joints.position_iteration(joints.split_positions(pos), jdata))
    pcarry = joints.split_positions(pos)
    for _ in range(position_iters - k_pos):
        pcarry = joints.position_iteration(pcarry, jdata)
    pos = joints.join_positions(pcarry)

    return state.replace(
        hull_c=pos.hull_c, hull_a=pos.hull_a, hull_v=hv, hull_w=hw,
        wheel_c=pos.wheel_c, wheel_a=pos.wheel_a, wheel_v=wv, wheel_w=ww,
        joint_impulse=j_imp, motor_impulse=m_imp,
    ), contacts
