# Frozen copy of multi_car_racing_tpu_torch/render/particles.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Skid particles (cd:232-249, 337-349): render-only tire marks, batched over envs.

Port of the JAX package's ``render/particles.py``. The reference grows
per-wheel polylines while ``|tire force| > 2 * friction_limit`` (black on
road, mud-coloured on grass) and keeps the last 30 particles of up to 30
points; they are drawn as width-2 polylines only in the non-state_pixels
render modes, so they never appear in the training observation. Here the
same trails are a fixed-shape per-car ring of line segments (consecutive
skidding positions chain into the same visual polyline), updated by the env
when ``EnvConfig.track_skid`` is on (the Gym facade turns it on; batched
training leaves it off, as the reference would not draw them there).

Every tensor carries the env axis first; the JAX package's shapes follow it.
"""

from __future__ import annotations

import dataclasses

import torch

from .. import config as C

MAX_SEGMENTS = 256   # per car (reference cap: 30 particles x <= 30 points)


@dataclasses.dataclass(frozen=True)
class SkidState:
    seg: torch.Tensor      # (E, N, K, 4) [x1, y1, x2, y2] world coords
    grass: torch.Tensor    # (E, N, K) bool: mud colour vs wheel colour
    valid: torch.Tensor    # (E, N, K) bool
    head: torch.Tensor     # (E, N) int32 ring position
    prev: torch.Tensor     # (E, N, 4, 2) wheel positions last step
    active: torch.Tensor   # (E, N, 4) bool: the wheel was skidding last step


def init(num_envs: int, num_cars: int, device=None, dtype=torch.float32) -> SkidState:
    """Empty trails for E envs of N cars."""
    k = MAX_SEGMENTS

    def z(*shape, dt=dtype):
        return torch.zeros((num_envs,) + shape, dtype=dt, device=device)

    return SkidState(seg=z(num_cars, k, 4), grass=z(num_cars, k, dt=torch.bool),
                     valid=z(num_cars, k, dt=torch.bool), head=z(num_cars, dt=torch.int32),
                     prev=z(num_cars, 4, 2), active=z(num_cars, 4, dt=torch.bool))


def update(state: SkidState, wheel_pos: torch.Tensor, skidding: torch.Tensor,
           on_road: torch.Tensor) -> SkidState:
    """Advance trails: a wheel skidding on consecutive steps contributes the
    segment between its previous and current position.

    wheel_pos (E, N, 4, 2); skidding (E, N, 4), the tire model's
    |force| > 2*limit flag (cd:233); on_road (E, N, 4)."""
    emit = skidding & state.active                                  # (E, N, 4)
    new_seg = torch.cat([state.prev, wheel_pos.to(state.prev.dtype)], dim=-1)   # (E, N, 4, 4)

    # Ring-write the (up to 4) new segments per car at head, head+1, ...
    # Only emitting wheels write: the others aim at a spare slot K that is
    # dropped after. (In JAX every wheel writes, a non-emitting one its
    # slot's old value; such a wheel shares its slot only with a later,
    # emitting wheel, whose write lands last, so the results agree.)
    K = MAX_SEGMENTS
    e32 = emit.to(torch.int32)
    offset = torch.cumsum(e32, dim=-1) - e32
    slot = torch.remainder(state.head[..., None] + offset, K).to(torch.int64)
    slot = torch.where(emit, slot, K)

    def ring_write(ring, new):
        pad = torch.zeros_like(ring[:, :, :1])
        idx = slot if ring.dim() == 3 else slot[..., None].expand(*slot.shape, ring.shape[-1])
        return torch.cat([ring, pad], dim=2).scatter(2, idx, new)[:, :, :K]

    seg = ring_write(state.seg, new_seg)
    grass = ring_write(state.grass, ~on_road)
    valid = ring_write(state.valid, torch.ones_like(emit))
    head = torch.remainder(state.head + e32.sum(-1, dtype=torch.int32), K)
    return SkidState(seg=seg, grass=grass, valid=valid, head=head.to(torch.int32),
                     prev=wheel_pos.to(state.prev.dtype), active=skidding)


def segments_window(state: SkidState, to_win):
    """All cars' segments of each env in window coords for one view
    transform: (E, N_cars*K, 4), colours (E, N_cars*K, 3) and valid
    (E, N_cars*K)."""
    E = state.seg.shape[0]
    a = to_win(state.seg[..., 0:2].reshape(E, -1, 2))
    b = to_win(state.seg[..., 2:4].reshape(E, -1, 2))
    grass = state.grass.reshape(E, -1)
    dev = state.seg.device
    color = torch.where(grass[..., None],
                        torch.tensor(C.MUD_COLOR, dtype=torch.float32, device=dev),
                        torch.tensor(C.WHEEL_COLOR, dtype=torch.float32, device=dev))
    return torch.cat([a, b], dim=-1), color, state.valid.reshape(E, -1)


def coverage(segs: torch.Tensor, px: torch.Tensor, py: torch.Tensor,
             half_width: float = 1.0) -> torch.Tensor:
    """Pixel coverage of width-2*half_width segments: segs (S, 4) window
    coords; px/py (P,) -> (S, P) bool."""
    ax, ay, bx, by = segs[:, 0:1], segs[:, 1:2], segs[:, 2:3], segs[:, 3:4]
    dx, dy = bx - ax, by - ay
    len2 = dx * dx + dy * dy
    t = torch.clamp(((px[None] - ax) * dx + (py[None] - ay) * dy)
                    / torch.clamp(len2, min=1e-9), 0.0, 1.0)
    cx = ax + t * dx
    cy = ay + t * dy
    d2 = (px[None] - cx) ** 2 + (py[None] - cy) ** 2
    return d2 <= half_width * half_width
