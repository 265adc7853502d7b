# Frozen copy of multi_car_racing_tpu_torch/render/geometry.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Camera and scene geometry of the pixel observation, batched over envs.

Port of the JAX package's ``render/geometry.py``; the JAX functions take one
env and are ``vmap``-ed, these take E envs and every shape gains a leading
E. They reproduce the reference's per-agent view pipeline (mcr:520-604):

- zoom animates 0.1*SCALE -> ZOOM*SCALE over the first second (mcr:540);
- the view rotates so the car's velocity direction (speed > 0.5; else the
  hull heading) points up (mcr:544-549);
- the car sits horizontally centred at ``h_ratio`` window height
  (mcr:552-556);
- the 1000x800 window is squeezed anisotropically into the 96x96 viewport.

Window coords: ``win = trans + R(angle) @ (zoom * world)``; observation row 0
is the top of the window (the reference flips the GL readback, mcr:602).

Every constant that meets a float32 tensor is rounded to float32 first, as
JAX does with a weakly typed Python float, so each operation here rounds as
the JAX one does.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from ..physics import shapes


def f32(x: float) -> float:
    """``x`` rounded to float32, as a Python float."""
    return float(np.float32(x))


def camera(cfg, state):
    """Per-view camera parameters: zoom (E,), angle (E, N), trans (E, N, 2)."""
    t = state.t
    zoom = (f32(0.1 * C.SCALE) * torch.clamp(1.0 - t, min=0.0)
            + f32(C.ZOOM * C.SCALE) * torch.clamp(t, max=1.0))
    cars = state.cars
    scroll = cars.hull_origin                                   # (E, N, 2)
    vel = cars.hull_v
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    angle = torch.where(speed > 0.5, torch.atan2(vel[..., 0], vel[..., 1]), -cars.hull_a)
    ca, sa = torch.cos(angle), torch.sin(angle)
    z = zoom[:, None]
    tx = f32(C.WINDOW_W / 2) - z * (ca * scroll[..., 0] - sa * scroll[..., 1])
    ty = f32(C.WINDOW_H * cfg.h_ratio) - z * (sa * scroll[..., 0] + ca * scroll[..., 1])
    return zoom, angle, torch.stack([tx, ty], dim=-1)


def world_to_window(pts, zoom, angle, trans):
    """pts (..., 2) world -> window; zoom, angle and trans (..., 2)
    broadcast against the leading dims of pts."""
    ca, sa = torch.cos(angle), torch.sin(angle)
    x = pts[..., 0] * zoom
    y = pts[..., 1] * zoom
    return torch.stack(
        [trans[..., 0] + ca * x - sa * y, trans[..., 1] + sa * x + ca * y], dim=-1)


def window_to_world(wx, wy, zoom, angle, trans):
    """Inverse camera: window coords -> world coords."""
    dx = wx - trans[..., 0]
    dy = wy - trans[..., 1]
    ca, sa = torch.cos(angle), torch.sin(angle)
    inv = 1.0 / zoom
    return (ca * dx + sa * dy) * inv, (-sa * dx + ca * dy) * inv


# ---------------------------------------------------------------------------
# Car polygons (world space) in reference paint order
# ---------------------------------------------------------------------------

# Paint order within one car (gym-0.17 Car.draw, drawlist = wheels + [hull]):
# wheel poly + its phase marker for each of the 4 wheels, then the 4 hull
# fixtures. 12 polys + 4 markers per car.
_WHEEL_LOCAL = np.asarray(shapes.WHEEL_POLY, dtype=np.float32)        # (4, 2)


def _hull_locals_padded() -> np.ndarray:
    """The 4 hull fixtures padded to 8 vertices (the pad repeats the last)."""
    out = np.zeros((4, 8, 2), np.float32)
    for i, poly in enumerate(shapes.HULL_POLYS):
        p = np.asarray(poly, np.float32)
        out[i, :len(p)] = p
        out[i, len(p):] = p[-1]
    return out


_HULL_LOCALS = _hull_locals_padded()                                  # (4, 8, 2)


def _rot(points, angle):
    ca, sa = torch.cos(angle), torch.sin(angle)
    x, y = points[..., 0], points[..., 1]
    return torch.stack([ca * x - sa * y, sa * x + ca * y], dim=-1)


def wheel_marker_local(phase):
    """The rotating white stripe on each wheel (gymnasium cd:302-321).

    phase (...,) -> (verts (..., 4, 2), valid (...,))."""
    a1 = phase
    a2 = phase + f32(1.2)
    s1, s2 = torch.sin(a1), torch.sin(a2)
    c1, c2 = torch.cos(a1), torch.cos(a2)
    valid = ~((s1 > 0) & (s2 > 0))
    c1 = torch.where(s1 > 0, torch.sign(c1), c1)
    c2 = torch.where(s2 > 0, torch.sign(c2), c2)
    w = f32(C.WHEEL_W * C.SIZE)
    r = f32(C.WHEEL_R * C.SIZE)
    y1 = r * c1
    y2 = r * c2
    one = torch.ones_like(phase)
    verts = torch.stack([
        torch.stack([-w * one, y1], dim=-1),
        torch.stack([+w * one, y1], dim=-1),
        torch.stack([+w * one, y2], dim=-1),
        torch.stack([-w * one, y2], dim=-1),
    ], dim=-2)
    return verts, valid


def car_polys_world(cars):
    """World-space car polygons in paint order, for E envs of N cars:

      wheel_quads (E, N, 4, 4, 2), marker_quads (E, N, 4, 4, 2),
      marker_valid (E, N, 4), hull_polys (E, N, 4, 8, 2)
      (padded to 8 vertices; the pad repeats the last vertex)."""
    dev, dt = cars.hull_a.device, cars.hull_a.dtype
    wheel_local = torch.as_tensor(_WHEEL_LOCAL, device=dev, dtype=dt)
    wq = _rot(wheel_local, cars.wheel_a[..., None]) + cars.wheel_c[..., None, :]
    mk_local, mk_valid = wheel_marker_local(cars.phase)        # (E,N,4,4,2), (E,N,4)
    mq = _rot(mk_local, cars.wheel_a[..., None]) + cars.wheel_c[..., None, :]
    hull_local = torch.as_tensor(_HULL_LOCALS, device=dev, dtype=dt)
    hulls = (_rot(hull_local, cars.hull_a[..., None, None])
             + cars.hull_origin[..., None, None, :])           # (E, N, 4, 8, 2)
    return dict(wheel_quads=wq, marker_quads=mq, marker_valid=mk_valid,
                hull_polys=hulls)


# ---------------------------------------------------------------------------
# HUD (window coordinates, mcr:634-674)
# ---------------------------------------------------------------------------

HUD_S = C.WINDOW_W / 40.0    # 25
HUD_H = C.WINDOW_H / 40.0    # 20


def hud_values(state):
    """Per-view dynamic HUD scalars, each (E, N): speed, abs0..abs3, steer,
    gyro, score, backward."""
    cars = state.cars
    true_speed = torch.sqrt(torch.sum(cars.hull_v * cars.hull_v, dim=-1))
    return dict(
        speed=f32(0.02) * true_speed,
        abs0=f32(0.01) * cars.spin[..., 0],
        abs1=f32(0.01) * cars.spin[..., 1],
        abs2=f32(0.01) * cars.spin[..., 2],
        abs3=f32(0.01) * cars.spin[..., 3],
        steer=-10.0 * cars.joint_angle[..., 0],
        gyro=f32(-0.8) * cars.hull_w,
        score=state.reward,
        backward=state.driving_backward,
    )


# 5x7 bitmap digit font for the score label (the reference uses a pyglet
# 36 px font; glyph-exact parity is not achievable -- this is the JAX
# package's documented approximation at the matching position and size).
DIGIT_FONT = np.array(
    [
        [0b01110, 0b10001, 0b10011, 0b10101, 0b11001, 0b10001, 0b01110],  # 0
        [0b00100, 0b01100, 0b00100, 0b00100, 0b00100, 0b00100, 0b01110],  # 1
        [0b01110, 0b10001, 0b00001, 0b00010, 0b00100, 0b01000, 0b11111],  # 2
        [0b11111, 0b00010, 0b00100, 0b00010, 0b00001, 0b10001, 0b01110],  # 3
        [0b00010, 0b00110, 0b01010, 0b10010, 0b11111, 0b00010, 0b00010],  # 4
        [0b11111, 0b10000, 0b11110, 0b00001, 0b00001, 0b10001, 0b01110],  # 5
        [0b00110, 0b01000, 0b10000, 0b11110, 0b10001, 0b10001, 0b01110],  # 6
        [0b11111, 0b00001, 0b00010, 0b00100, 0b01000, 0b01000, 0b01000],  # 7
        [0b01110, 0b10001, 0b10001, 0b01110, 0b10001, 0b10001, 0b01110],  # 8
        [0b01110, 0b10001, 0b10001, 0b01111, 0b00001, 0b00010, 0b01100],  # 9
    ],
    dtype=np.uint8,
)

SCORE_X = 20.0           # label x (mcr:533-534)
SCORE_Y = C.WINDOW_H * 2.5 / 40.0   # 50, anchor centre
SCORE_DIGIT_W = 20.0
SCORE_DIGIT_H = 36.0
SCORE_SPACING = 24.0
