"""Policy stand-in: the deterministic lane follower, batched over (env, car).

The benchmark's copy of ``follower_actions`` of ``multi_car_racing_tpu_torch/
oracle/episodes.py`` (commit 3d8d1d4): each car steers toward the track
heading 4 tiles ahead and back to its lane (a lateral offset from the
centreline), and holds a target speed that drops for the curvature 10
tiles ahead. It reads the state the way a policy network would be fed it,
in float64 on the state's device, and never reads the card from the host.

Parameters (a traffic mix's ``policy``): ``lanes``, one lateral offset in
metres per car, and ``max_speed`` in m/s.
"""

from __future__ import annotations

import math

import torch

TWO_PI = 2 * math.pi


def _py_mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """Python's float ``a % b`` for ``b > 0``: fmod, then moved into [0, b)."""
    m = torch.fmod(a, b)
    return torch.where(m < 0, m + b, m)


def make(params: dict, num_agents: int, device: torch.device):
    """The policy: state -> (E, N, 3) float32 actions (steer, gas, brake)."""
    lanes = torch.as_tensor(params["lanes"], dtype=torch.float64, device=device)
    if lanes.shape != (num_agents,):
        raise ValueError(f"follower: {lanes.numel()} lanes for {num_agents} cars")
    max_speed = float(params["max_speed"])

    def policy(state) -> torch.Tensor:
        track, cars = state.track, state.cars
        dev, f64 = cars.hull_c.device, torch.float64
        E, N = cars.hull_a.shape
        xy, beta = track.xy.to(f64), track.beta.to(f64)                  # (E, MT, 2), (E, MT)
        nt = track.n_tiles.to(torch.int64)[:, None]                       # (E, 1)
        cw = state.direction_cw[:, None]                                  # (E, 1)
        sgn = torch.where(cw, -1, 1).to(torch.int64)
        pos, vel, ang = cars.hull_c.to(f64), cars.hull_v.to(f64), cars.hull_a.to(f64)

        dx = xy[:, None, :, 0] - pos[..., 0, None]                        # (E, N, MT)
        dy = xy[:, None, :, 1] - pos[..., 1, None]
        d2 = dx * dx + dy * dy
        valid = torch.arange(xy.shape[1], device=dev)[None, None] < nt[:, :, None]
        i = torch.argmin(torch.where(valid, d2, torch.inf), dim=-1)      # (E, N)
        j = torch.remainder(i + sgn * 4, nt)
        kk = torch.remainder(i + sgn * 10, nt)
        beta_i, beta_j, beta_k = (torch.gather(beta, 1, idx) for idx in (i, j, kk))
        desired = beta_j + cw.to(f64) * math.pi
        err = _py_mod(desired - ang + math.pi, TWO_PI) - math.pi
        xi = torch.gather(xy, 1, i[..., None].expand(E, N, 2))
        lat = ((pos[..., 0] - xi[..., 0]) * torch.cos(beta_i)
               + (pos[..., 1] - xi[..., 1]) * torch.sin(beta_i)) - lanes
        steer = -2.0 * torch.sin(err) - 0.12 * torch.clamp(lat, -4.0, 4.0) * sgn
        speed = torch.hypot(vel[..., 0], vel[..., 1])
        curv = torch.abs(_py_mod(beta_k - beta_j + math.pi, TWO_PI) - math.pi)
        target = max_speed * (1.0 - torch.clamp(curv, max=1.0) * 0.65)
        zero = torch.zeros_like(speed)
        gas = torch.where(speed < target, zero + 0.25, zero)
        brake = torch.where(speed > target + 6.0, zero + 0.4, zero)
        return torch.stack([torch.clamp(steer, -1.0, 1.0), gas, brake],
                           dim=-1).to(torch.float32)

    return policy
