"""Friction-circle tire / engine / brake model — ``Car.step`` (cd:172-266).

Port of the JAX package's ``physics/tire.py`` over ``(E, N, 4)`` wheels.
Consumes current wheel velocities and the on-road mask (from the previous
sensor pass — Box2D updates contacts at the *start* of ``world.Step``, so the
friction limit a tire sees lags geometry by one step), produces per-wheel
world forces for the integrator plus updated rolling state and the joint
servo speeds.
"""

from __future__ import annotations

import torch

from .. import config as C
from . import shapes
from .state import CarState, wheel_forward_side

_WHEEL_RAD = float(shapes.WHEEL_RAD)


def tire_step(state: CarState, wheel_on_road: torch.Tensor, dt: float = C.DT):
    """Returns (state', wheel_force (E,N,4,2), motor_speed (E,N,4),
    skid (E,N,4) bool).

    ``skid`` flags |force| > 2*friction_limit before the circle clamp
    (cd:233) — used by the renderer for skid particles, not by physics.
    """
    # 1. Steering servo command (cd:174-177).
    err = state.steer - state.joint_angle
    motor_speed = torch.sign(err) * torch.clamp(
        C.STEER_SERVO_GAIN * torch.abs(err), max=C.STEER_SERVO_MAX_SPEED
    )

    # 2. Friction limit (cd:180-186): binary grass/road via the sensor tiles.
    friction_limit = torch.where(
        wheel_on_road,
        torch.full_like(state.spin, C.FRICTION_LIMIT),
        torch.full_like(state.spin, C.FRICTION_LIMIT * C.GRASS_FRICTION_FACTOR),
    )

    # 3. Wheel-frame velocities (cd:189-193).
    forw, side = wheel_forward_side(state)
    vf = torch.sum(forw * state.wheel_v, dim=-1)
    vs = torch.sum(side * state.wheel_v, dim=-1)

    # 4. Engine spin-up (cd:199-207): domega = dt*P*gas / (I*(|omega|+5)).
    spin = state.spin + (
        dt * C.ENGINE_POWER * state.gas
        / (C.WHEEL_MOMENT_OF_INERTIA * (torch.abs(state.spin) + 5.0))
    )
    fuel_spent = state.fuel_spent + torch.sum(dt * C.ENGINE_POWER * state.gas, dim=-1)

    # 5. Brake (cd:209-217): >= 0.9 locks the wheel; else bleed omega toward 0.
    bleed = torch.sign(spin) * torch.minimum(C.BRAKE_FORCE * state.brake, torch.abs(spin))
    spin = torch.where(
        state.brake >= 0.9,
        torch.zeros_like(spin),
        torch.where(state.brake > 0.0, spin - bleed, spin),
    )
    phase = state.phase + spin * dt

    # 6. Slip forces (cd:220-229) + friction circle (cd:251-256).
    vr = spin * _WHEEL_RAD
    f_force = (-vf + vr) * C.TIRE_STIFFNESS
    p_force = -vs * C.TIRE_STIFFNESS
    force = torch.sqrt(torch.square(f_force) + torch.square(p_force))
    skid = torch.abs(force) > 2.0 * friction_limit

    over = torch.abs(force) > friction_limit
    scale = torch.where(
        over, friction_limit / torch.clamp(force, min=1e-30), torch.ones_like(force)
    )
    f_force = f_force * scale
    p_force = p_force * scale

    # 7. Spin feedback (cd:258) + world-frame force at the wheel COM (cd:260-266).
    spin = spin - dt * f_force * _WHEEL_RAD / C.WHEEL_MOMENT_OF_INERTIA
    wheel_force = p_force[..., None] * side + f_force[..., None] * forw

    new_state = state.replace(spin=spin, phase=phase, fuel_spent=fuel_spent)
    return new_state, wheel_force, motor_speed, skid
