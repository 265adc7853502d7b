# Frozen copy of multi_car_racing_tpu_torch/track/common.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""Padded fixed-shape track representation, batched over envs.

Port of the JAX package's ``track/common.py``. A track is padded to
``max_tiles`` with a validity mask; :class:`Track` holds the tensors of E
tracks, env axis first, so thousands of envs carry their tracks in lockstep.
The packing itself is the JAX package's float64 numpy code, unchanged, so the
two packages produce the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as C
from ..util import resolve_device


@dataclasses.dataclass(frozen=True)
class Track:
    """E tracks, each padded to MT = max_tiles.

    Index ``i`` corresponds 1:1 with the reference's ``track[i]`` /
    ``self.road[i]`` tile (mcr:309-334). Invalid (padding) entries have
    ``valid == False`` and quads collapsed far outside the playfield so that
    point/overlap tests fail without extra masking.
    """

    n_tiles: torch.Tensor        # (E,) int32 — actual tile count
    valid: torch.Tensor          # (E, MT) bool
    xy: torch.Tensor             # (E, MT, 2) f32 — centerline point of tile i
    beta: torch.Tensor           # (E, MT) f32 — tile heading
    quad: torch.Tensor           # (E, MT, 4, 2) f32 — road quad [r1_l, r1_r, r2_r, r2_l]
    color0: torch.Tensor         # (E, MT, 3) f32 — initial color with 0.01*(i%3) dither
    has_curb: torch.Tensor       # (E, MT) bool — red/white curb present (mcr:328)
    curb_quad: torch.Tensor      # (E, MT, 4, 2) f32
    curb_red: torch.Tensor       # (E, MT) bool — red if i%2 else white (mcr:334)
    # Tiles-last layouts for the per-step contact pass.
    quad_T: torch.Tensor         # (E, 4, 2, MT) — road quad verts, tiles last
    quad_ax_T: torch.Tensor      # (E, 4, 2, MT) — unit edge normals, tiles last
    quad_lo: torch.Tensor        # (E, 4, MT) — own-axis interval lo (precomputed)
    quad_hi: torch.Tensor        # (E, 4, MT) — own-axis interval hi
    curb_quad_T: torch.Tensor    # (E, 4, 2, MT) — curb quad verts, tiles last

    @property
    def max_tiles(self) -> int:
        return self.xy.shape[-2]


# Padding quads live far outside the playfield so overlap/point tests miss.
_PAD_FAR = 1.0e6


def pack_track_arrays(
    track_pts: np.ndarray,      # (T, 4) float — (alpha, beta, x, y) rows
    border: np.ndarray,         # (T,) bool
    max_tiles: int,
    dtype=np.float32,
) -> dict:
    """The padded arrays of one track (numpy, no env axis), by field name.

    Reproduces the tile/curb geometry of mcr:309-334 exactly: the quad for
    tile i spans +-TRACK_WIDTH along (cos beta, sin beta) — the *radial*
    direction, since (-sin b, cos b) is forward — between centerline points
    i and i-1 (wrapping to the last point for i=0).
    """
    t = np.asarray(track_pts, dtype=np.float64)
    T = t.shape[0]
    if T > max_tiles:
        raise ValueError(f"track has {T} tiles > max_tiles={max_tiles}")
    border = np.asarray(border, dtype=bool)

    beta1 = t[:, 1]
    xy1 = t[:, 2:4]
    prev = np.roll(np.arange(T), 1)           # i-1 with Python wrap (mcr:312)
    beta2 = t[prev, 1]
    xy2 = t[prev, 2:4]

    def offs(beta, k):
        return np.stack([k * np.cos(beta), k * np.sin(beta)], axis=-1)

    w = C.TRACK_WIDTH
    road1_l = xy1 - offs(beta1, w)
    road1_r = xy1 + offs(beta1, w)
    road2_l = xy2 - offs(beta2, w)
    road2_r = xy2 + offs(beta2, w)
    quad = np.stack([road1_l, road1_r, road2_r, road2_l], axis=1)  # (T,4,2)

    i = np.arange(T)
    dither = 0.01 * (i % 3)
    color0 = np.asarray(C.ROAD_COLOR)[None, :] + dither[:, None]

    # Curbs (mcr:328-334): side = sign(beta2-beta1); quad between
    # side*TRACK_WIDTH and side*(TRACK_WIDTH+BORDER) radial offsets.
    side = np.sign(beta2 - beta1)
    b1_l = xy1 + offs(beta1, side * w)
    b1_r = xy1 + offs(beta1, side * (w + C.BORDER))
    b2_l = xy2 + offs(beta2, side * w)
    b2_r = xy2 + offs(beta2, side * (w + C.BORDER))
    curb_quad = np.stack([b1_l, b1_r, b2_r, b2_l], axis=1)
    curb_red = (i % 2) != 0

    MT = max_tiles
    pad = MT - T

    def padded(a, fill=0.0):
        out = np.full((MT,) + a.shape[1:], fill, dtype=np.float64)
        out[:T] = a
        return out

    quad_p = padded(quad, _PAD_FAR)
    curb_quad_p = padded(curb_quad, _PAD_FAR)
    # Invalid curb quads also pushed far away.
    curb_quad_p[:T][~border] = _PAD_FAR

    valid = np.zeros(MT, dtype=bool)
    valid[:T] = True
    has_curb = np.zeros(MT, dtype=bool)
    has_curb[:T] = border

    # Tiles-last layouts + per-tile SAT precomputation. Degenerate padding
    # quads get zero-length edges; their normals are replaced by a dummy unit
    # axis, and since the verts are at _PAD_FAR every interval test misses.
    quad_T = np.transpose(quad_p, (1, 2, 0))                  # (4, 2, MT)
    edges = np.roll(quad_p, -1, axis=1) - quad_p              # (MT, 4, 2)
    nrm = np.stack([edges[..., 1], -edges[..., 0]], axis=-1)
    ln = np.linalg.norm(nrm, axis=-1, keepdims=True)
    nrm = np.where(ln > 1e-12, nrm / np.maximum(ln, 1e-12), np.asarray([1.0, 0.0]))
    proj = np.einsum("tac,tvc->tav", nrm, quad_p)             # (MT, 4ax, 4v)
    quad_lo = proj.min(-1)
    quad_hi = proj.max(-1)

    return dict(
        n_tiles=np.asarray(T, dtype=np.int32),
        valid=valid,
        xy=padded(xy1, _PAD_FAR).astype(dtype),
        beta=padded(beta1[:, None])[:, 0].astype(dtype),
        quad=quad_p.astype(dtype),
        color0=padded(color0).astype(dtype),
        has_curb=has_curb,
        curb_quad=curb_quad_p.astype(dtype),
        curb_red=np.pad(curb_red, (0, pad)),
        quad_T=quad_T.astype(dtype),
        quad_ax_T=np.transpose(nrm, (1, 2, 0)).astype(dtype),
        quad_lo=np.transpose(quad_lo).astype(dtype),
        quad_hi=np.transpose(quad_hi).astype(dtype),
        curb_quad_T=np.transpose(curb_quad_p, (1, 2, 0)).astype(dtype),
    )


def track_from_arrays(arrays: list, device=None) -> Track:
    """Stack per-track numpy arrays (from :func:`pack_track_arrays`) into a
    Track of E = len(arrays) envs on ``device`` (default CUDA). Every tensor
    is contiguous in its documented layout (the tiles-last tables are
    transposes in numpy), as the track-pass kernel reads them."""
    dev = resolve_device(device)
    return Track(**{
        f.name: torch.from_numpy(np.ascontiguousarray(np.stack([a[f.name] for a in arrays])))
        .to(dev)
        for f in dataclasses.fields(Track)
    })


def pack_track(track_pts, border, max_tiles: int, device=None) -> Track:
    """One packed track as a Track of E = 1 on ``device`` (default CUDA)."""
    return track_from_arrays([pack_track_arrays(track_pts, border, max_tiles)], device)


def spawn_poses(
    track_xy: np.ndarray,        # (T, 2)
    track_beta: np.ndarray,      # (T,)
    n_tiles: int,
    car_order: np.ndarray,       # (N,) spawn-slot id per car
    direction_cw: bool,
) -> tuple[np.ndarray, np.ndarray]:
    """Starting grid placement (mcr:366-401), host version.

    Cars are placed in pairs: ``line_number = floor(order/2)`` rows back along
    the track (LINE_SPACING tiles per row, via Python negative indexing →
    wraps to the track tail), offset laterally by +-LATERAL_SPACING along
    ``(sin, cos)`` of ``(angle - pi/2)`` — the reference's exact (slightly
    unusual) axis convention, kept verbatim for parity.

    Returns (pos (N,2), angle (N,)).
    """
    N = len(car_order)
    pos = np.zeros((N, 2))
    ang = np.zeros(N)
    # pos_x/pos_y and the dx/dy detour are kept (instead of indexing the row
    # directly) to match the reference's floating-point evaluation order.
    pos_x, pos_y = float(track_xy[0, 0]), float(track_xy[0, 1])
    for car_id in range(N):
        line_number = int(car_order[car_id]) // 2
        side = (2 * (int(car_order[car_id]) % 2)) - 1
        idx = (-line_number * C.LINE_SPACING) % n_tiles
        dx = float(track_xy[idx, 0]) - pos_x
        dy = float(track_xy[idx, 1]) - pos_y
        angle = float(track_beta[idx])
        if direction_cw:
            angle -= np.pi
        norm_theta = angle - np.pi / 2
        pos[car_id, 0] = pos_x + dx + C.LATERAL_SPACING * np.sin(norm_theta) * side
        pos[car_id, 1] = pos_y + dy + C.LATERAL_SPACING * np.cos(norm_theta) * side
        ang[car_id] = angle
    return pos, ang
