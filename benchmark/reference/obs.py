"""Observations in plain PyTorch.

Frozen copy of ``multi_car_racing_tpu_torch/obs.py`` (commit 3d8d1d4):
``state_observation``, the compact per-car feature vector, and the pixel
observation through the plain painter (``render/pixels.view_inputs`` then
``paint_views_plain``), which the port's kernel ``csrc/paint_view.cu`` (K6)
stands for.
"""

from __future__ import annotations

import math

import torch

from .env import EnvState
from .physics.track_stage import nearest_tile
from .render import pixels

STATE_OBS_DIM = 38

# Tile-index offsets of the lookahead waypoints (signed by episode direction:
# a CW episode traverses the track in decreasing index order). At the mean
# tile spacing of TRACK_DETAIL_STEP = 3.5 m the farthest point is ~157 m out
# — ~3 s of lookahead at racing speed, enough to set up for corners.
LOOKAHEAD_OFFSETS = (3, 6, 10, 15, 21, 28, 36, 45)


def state_observation(state: EnvState) -> torch.Tensor:
    """Per-car feature vector, (E, N, STATE_OBS_DIM), all roughly unit-scale.

    Features (documented order):
      0:2   hull velocity in the car frame (forward, lateral) / 40
      2     hull angular velocity / 3
      3     speed / 40
      4:8   wheel rolling speeds (omega) / 120
      8:10  front joint angles / 0.4
      10    steer target, 11 rear gas, 12 brake
      13:15 vector to nearest tile center, car frame / 10
      15:17 cos/sin of heading error vs track direction
      17    curvature ahead (signed beta[i±5] - beta[i], wrapped) / 0.5
      18    on-grass flag, 19 driving-backward flag
      20:36 8 lookahead waypoints (car-frame forward, lateral) / 40, at the
            direction-signed tile offsets LOOKAHEAD_OFFSETS
      36:38 cos/sin of the track tangent at the farthest waypoint relative to
            the car heading
    """
    cars, track = state.cars, state.track
    E, n = cars.hull_a.shape
    f = state.reward.dtype
    s, c = torch.sin(cars.hull_a), torch.cos(cars.hull_a)
    # car frame: forward = (-sin, cos), lateral = (cos, sin)
    fwd = torch.stack([-s, c], dim=-1)                          # (E, N, 2)
    lat = torch.stack([c, s], dim=-1)
    v_f = torch.sum(cars.hull_v * fwd, dim=-1)
    v_l = torch.sum(cars.hull_v * lat, dim=-1)
    speed = torch.sqrt(torch.sum(cars.hull_v * cars.hull_v, dim=-1))

    origin = cars.hull_origin                                   # (E, N, 2)
    nearest = nearest_tile(track, origin)

    def pick_xy(idx: torch.Tensor) -> torch.Tensor:             # (E, K) -> (E, K, 2)
        return torch.gather(track.xy, 1, idx[..., None].expand(*idx.shape, 2))

    nxy = pick_xy(nearest)
    nbeta = torch.gather(track.beta, 1, nearest)
    # Direction-signed "ahead": CW episodes run the track in decreasing
    # tile-index order.
    sign = torch.where(state.direction_cw, -1, 1)[:, None]     # (E, 1)
    n_tiles = track.n_tiles.to(torch.int64)[:, None]
    beta_ahead = torch.gather(track.beta, 1,
                              torch.remainder(nearest + 5 * sign, n_tiles))

    rel = nxy - origin
    rel_f = torch.sum(rel * fwd, dim=-1)
    rel_l = torch.sum(rel * lat, dim=-1)

    flip = torch.where(state.direction_cw, math.pi, 0.0).to(f)[:, None]
    err = nbeta + flip - cars.hull_a
    curv = sign * (torch.remainder(beta_ahead - nbeta + math.pi, 2 * math.pi) - math.pi)

    # Lookahead waypoints: car-frame positions of tiles ahead along the
    # driving direction.
    offs = torch.as_tensor(LOOKAHEAD_OFFSETS, dtype=torch.int64, device=nearest.device)
    wp_idx = torch.remainder(nearest[:, :, None] + offs * sign[:, :, None],
                             n_tiles[:, :, None])               # (E, N, K)
    wp_xy = pick_xy(wp_idx.reshape(E, -1)).reshape(E, n, len(LOOKAHEAD_OFFSETS), 2)
    wp_rel = wp_xy - origin[:, :, None, :]
    wp_f = torch.sum(wp_rel * fwd[:, :, None, :], dim=-1) / 40.0   # (E, N, K)
    wp_l = torch.sum(wp_rel * lat[:, :, None, :], dim=-1) / 40.0
    far_beta = torch.gather(track.beta, 1, wp_idx[..., -1])
    far_err = far_beta + flip - cars.hull_a

    joint = cars.joint_angle
    base = torch.stack([
        v_f / 40.0, v_l / 40.0, cars.hull_w / 3.0, speed / 40.0,
        cars.spin[..., 0] / 120.0, cars.spin[..., 1] / 120.0,
        cars.spin[..., 2] / 120.0, cars.spin[..., 3] / 120.0,
        joint[..., 0] / 0.4, joint[..., 1] / 0.4,
        cars.steer[..., 0], cars.gas[..., 2], cars.brake[..., 0],
        rel_f / 10.0, rel_l / 10.0,
        torch.cos(err), torch.sin(err), curv / 0.5,
        state.driving_on_grass.to(f), state.driving_backward.to(f),
    ], dim=-1)                                                  # (E, N, 20)
    wps = torch.stack([wp_f, wp_l], dim=-1).reshape(E, n, -1)   # (E, N, 2K)
    return torch.cat([base, wps, torch.cos(far_err)[..., None],
                      torch.sin(far_err)[..., None]], dim=-1)


def pixel_observation(cfg, state: EnvState) -> torch.Tensor:
    """Pixel observations (E, N, 96, 96, 3) uint8, one view per car
    (mcr:431), by the plain painter."""
    tr = state.track
    return pixels.paint_views_plain(*pixels.view_inputs(cfg, state), tr.quad, tr.curb_quad,
                                    state.tile_touched, tr.curb_red, tr.valid, tr.has_curb)
