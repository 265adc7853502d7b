"""World step: velocity integration + constraint solve + position integration.

Port of the JAX package's ``physics/world.py``, joints-only branch: the
equivalent of ``world.Step(1/50, 180, 60)`` (mcr:428) for one hull and four
wheels per car joined by revolute joints, with *no* collision response with
track tiles (they are sensors). Gravity and body damping are zero.

Box2D's b2Island order is preserved:
  1. v += dt * invM * F (tire forces on wheels only; hulls receive none)
  2. joint init/warm-start
  3. velocity iterations: joints (Gauss-Seidel per car)
  4. position integration with maxTranslation/maxRotation clamps
  5. position iterations: joints
Car-car contacts (N >= 2) belong to the next slice of the port.
"""

from __future__ import annotations

import torch

from .. import config as C
from . import joints, shapes
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
    contacts=None,
) -> CarState:
    """Returns the new CarState (joints-only island)."""
    if contacts is not None:
        raise NotImplementedError(
            "car-car contacts are the next slice of the PyTorch port "
            "(collide.py and the full-contact island kernel); this slice "
            "steps one car per env"
        )
    # --- 1. integrate velocities (forces only on wheels).
    vel = Velocities(
        hull_v=state.hull_v,
        hull_w=state.hull_w,
        wheel_v=state.wheel_v + dt * float(shapes.WHEEL_INV_MASS) * wheel_force,
        wheel_w=state.wheel_w,
    )

    # --- 2. init + warm start.
    state, jdata = joints.init_constraints(state, motor_speed)
    vel = joints.warm_start(vel, jdata, state.joint_impulse, state.motor_impulse)

    # --- 3. velocity iterations.
    carry = joints.split_velocities(vel, state.joint_impulse, state.motor_impulse)
    for _ in range(velocity_iters):
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

    # --- 5. position iterations.
    pcarry = joints.split_positions(pos)
    for _ in range(position_iters):
        pcarry = joints.position_iteration(pcarry, jdata)
    pos = joints.join_positions(pcarry)

    return state.replace(
        hull_c=pos.hull_c, hull_a=pos.hull_a, hull_v=hv, hull_w=hw,
        wheel_c=pos.wheel_c, wheel_a=pos.wheel_a, wheel_v=wv, wheel_w=ww,
        joint_impulse=j_imp, motor_impulse=m_imp,
    )
