"""Car rigid-body + tire state, batched over envs and cars: ``(E, N, ...)``.

Port of the JAX package's ``physics/state.py``. Every field carries the env
axis first, then the car axis; the JAX package's single-env shapes follow.
Positions are stored Box2D-solver style: ``hull_c`` is the world position of
the *center of mass* and ``hull_a`` the angle; the body-origin position (what
Box2D exposes as ``body.position``) is derived.
"""

from __future__ import annotations

import dataclasses

import torch

from . import shapes


@dataclasses.dataclass(frozen=True)
class CarState:
    # Rigid bodies (hull + 4 wheels per car).
    hull_c: torch.Tensor      # (E, N, 2) COM position
    hull_a: torch.Tensor      # (E, N) angle
    hull_v: torch.Tensor      # (E, N, 2) linear velocity (at COM)
    hull_w: torch.Tensor      # (E, N) angular velocity
    wheel_c: torch.Tensor     # (E, N, 4, 2)
    wheel_a: torch.Tensor     # (E, N, 4)
    wheel_v: torch.Tensor     # (E, N, 4, 2)
    wheel_w: torch.Tensor     # (E, N, 4)

    # Revolute joint solver state (warm-start accumulators, cd:122-134).
    joint_impulse: torch.Tensor   # (E, N, 4, 3) point x/y + limit z impulse
    motor_impulse: torch.Tensor   # (E, N, 4)
    limit_state: torch.Tensor     # (E, N, 4) int32: 0 inactive, 1 lower, 2 upper

    # Tire / control state (cd:113-119).
    gas: torch.Tensor         # (E, N, 4) — only rear wheels receive gas
    brake: torch.Tensor       # (E, N, 4)
    steer: torch.Tensor       # (E, N, 4) — servo target, only front wheels set
    spin: torch.Tensor        # (E, N, 4) — rolling angular velocity w.omega
    phase: torch.Tensor       # (E, N, 4) — rolling angle (render)
    fuel_spent: torch.Tensor  # (E, N)

    def replace(self, **updates) -> "CarState":
        return dataclasses.replace(self, **updates)

    @property
    def hull_origin(self) -> torch.Tensor:
        """Box2D ``hull.position`` (body origin), (E, N, 2)."""
        s, c = torch.sin(self.hull_a), torch.cos(self.hull_a)
        lc0, lc1 = (float(v) for v in shapes.HULL_LOCAL_CENTER)
        off = torch.stack([c * lc0 - s * lc1, s * lc0 + c * lc1], dim=-1)
        return self.hull_c - off

    @property
    def joint_angle(self) -> torch.Tensor:
        """Revolute joint angles (wheel - hull), (E, N, 4)."""
        return self.wheel_a - self.hull_a[..., None]


def create_cars(pos: torch.Tensor, angle: torch.Tensor) -> CarState:
    """Spawn cars like ``Car.__init__`` (cd:54-139); ``pos`` (E, N, 2),
    ``angle`` (E, N), both float32.

    Quirk kept for parity: wheel bodies are created at ``origin + WHEELPOS``
    *without rotating the offset by the spawn angle* (cd:98) — the joints pull
    them into place during the first solver steps.
    """
    E, n = angle.shape
    s, c = torch.sin(angle), torch.cos(angle)
    lc0, lc1 = (float(v) for v in shapes.HULL_LOCAL_CENTER)
    hull_c = pos + torch.stack([c * lc0 - s * lc1, s * lc0 + c * lc1], dim=-1)

    wheel_off = torch.as_tensor(shapes.WHEEL_POS, dtype=pos.dtype, device=pos.device)
    wheel_c = pos[:, :, None, :] + wheel_off
    wheel_a = angle[:, :, None].expand(E, n, 4).clone()

    def z(*shape, dtype=pos.dtype):
        return torch.zeros((E, n) + shape, dtype=dtype, device=pos.device)

    return CarState(
        hull_c=hull_c, hull_a=angle.clone(), hull_v=z(2), hull_w=z(),
        wheel_c=wheel_c, wheel_a=wheel_a, wheel_v=z(4, 2), wheel_w=z(4),
        joint_impulse=z(4, 3), motor_impulse=z(4),
        limit_state=z(4, dtype=torch.int32),
        gas=z(4), brake=z(4), steer=z(4), spin=z(4), phase=z(4),
        fuel_spent=z(),
    )


def apply_controls(state: CarState, action: torch.Tensor) -> CarState:
    """Apply ``(E, N, 3)`` actions with the reference's exact setter semantics:
    ``car.steer(-a[0]); car.gas(a[1]); car.brake(a[2])`` (mcr:421-424).

    - steer: sets the front-wheel servo target instantly (cd:163-170);
    - gas: clipped to [0,1], rear wheels only, increase rate-limited to
      +0.1 per call, decrease instant (cd:141-152);
    - brake: set on all four wheels (cd:154-161).
    """
    steer_t = -action[..., 0]
    gas_t = torch.clamp(action[..., 1], 0.0, 1.0)
    brake_t = action[..., 2]

    steer = torch.cat(
        [steer_t[..., None].expand(*steer_t.shape, 2), state.steer[..., 2:]], dim=-1
    )
    rear = state.gas[..., 2:4]
    diff = torch.clamp(gas_t[..., None] - rear, max=0.1)
    gas = torch.cat([state.gas[..., :2], rear + diff], dim=-1)
    brake = brake_t[..., None].expand(state.brake.shape).contiguous()
    return state.replace(steer=steer, gas=gas, brake=brake)


def wheel_forward_side(state: CarState):
    """World-frame forward (local (0,1)) and side (local (1,0)) unit vectors
    per wheel (cd:189-190)."""
    s, c = torch.sin(state.wheel_a), torch.cos(state.wheel_a)
    forw = torch.stack([-s, c], dim=-1)
    side = torch.stack([c, s], dim=-1)
    return forw, side
