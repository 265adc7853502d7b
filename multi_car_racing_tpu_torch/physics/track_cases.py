"""Inputs of the track pass where the kernel's cull has its edges.

``csrc/track_pass.cu`` visits, for each car, only the tiles of
``track_engine.track_candidates``. These inputs, made from a numpy seed on
any packed track, put cars where that cull could go wrong:

- ``cull_cases``: cars on real track geometry, where the cull must keep
  every tile the plain pass marks (``track_engine.plain_marks``);
- ``cull_probes``: the same cars on a track whose centreline points are
  shifted off its quads, so that the cull drops tiles the plain pass marks.
  There the kernel must equal ``track_engine.track_pass_culled_plain``
  exactly, which pins its cull radii to the plain predicate's.

Used by the tests and chip_smoke.py only.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import config as C
from . import shapes
from .state import create_cars

CULL_SEED = 7                  # the default seed of both families
OFF_ROAD_M = 30.0              # 'off-road': hull origins this far off the centreline
SELF_GAP_TILES = 12            # 'self-approach': points at least this far apart along the loop
LIFT_M = 1000.0                # a car part moved this far in x and in y is off every tile
PROBE_SHIFT_M = 12.0           # the probes' centreline shift, about a tile's reach


def _nearest_self_pair(xy: np.ndarray, n_tiles: int) -> tuple[int, int]:
    """The two centreline points, at least SELF_GAP_TILES apart along the
    loop, that lie nearest to each other."""
    p = xy[:n_tiles]
    d2 = ((p[:, None] - p[None]) ** 2).sum(-1)
    gap = np.abs(np.arange(n_tiles)[:, None] - np.arange(n_tiles)[None])
    d2[np.minimum(gap, n_tiles - gap) < SELF_GAP_TILES] = np.inf
    a = int(np.argmin(d2))
    return a // n_tiles, a % n_tiles


def cull_cases(track, n: int, seed: int = CULL_SEED) -> dict:
    """The track pass's inputs on ``track`` (E envs of n cars): name ->
    (pre-solve cars, post-solve origin, visited, tile_touched). Hull origins
    'on-road' (a random tile, up to 1 m past the kerb's outer edge), across
    the start 'seam' (tile 0 spans centreline points n_tiles - 1 and 0), on a
    'kerb' quad, 'off-road' (OFF_ROAD_M off the centreline) and at the
    'self-approach' (between the two points where the loop comes nearest to
    itself); headings near the track's or random, wheels in place (rotated
    anchors) with the front pair steered. 'wheels-only' is 'on-road' with
    both hull origins LIFT_M away, so that only the cull's wheel term can
    keep the wheels' tiles. Post-solve origins within ~0.3 m of the
    pre-solve ones, visited and touched masks random."""
    rng = np.random.RandomState(seed + 17 * n)
    dev = track.xy.device
    xy = track.xy.cpu().double().numpy()
    beta = track.beta.cpu().double().numpy()
    nt = track.n_tiles.cpu().numpy()
    has_curb = track.has_curb.cpu().numpy()
    curb = track.curb_quad.cpu().double().numpy()
    E, MT = beta.shape
    envs = np.arange(E)[:, None]
    tiles = (rng.rand(E, n) * nt[:, None]).astype(np.int64)

    def radial(b):
        return np.stack([np.cos(b), np.sin(b)], -1)

    def jitter(b, s=0.3):
        return b + rng.normal(0, s, b.shape)

    def f32(x):
        return torch.as_tensor(x, dtype=torch.float32, device=dev)

    on_road = (xy[envs, tiles] + radial(beta[envs, tiles])
               * rng.uniform(-1, 1, (E, n, 1)) * (C.TRACK_WIDTH + C.BORDER + 1.0))
    last = xy[np.arange(E), nt - 1]
    seam = (0.5 * (xy[:, 0] + last)[:, None] + radial(beta[:, :1])
            * rng.uniform(-5, 5, (E, n, 1)))
    kerb_tiles = np.stack([rng.choice(np.flatnonzero(h) if h.any() else np.arange(t), n)
                           for h, t in zip(has_curb, nt)])
    kerb = curb[envs, kerb_tiles].mean(2) + rng.normal(0, 0.2, (E, n, 2))
    off = (xy[envs, tiles] + radial(beta[envs, tiles]) * OFF_ROAD_M
           * rng.choice([-1.0, 1.0], (E, n, 1)))
    pairs, ends = {}, np.zeros((E, 2), np.int64)
    for e in range(E):                   # tracks repeat across envs: one search each
        key = (int(nt[e]), xy[e, 0].tobytes())
        if key not in pairs:
            pairs[key] = _nearest_self_pair(xy[e], int(nt[e]))
        ends[e] = pairs[key]
    a, b = xy[np.arange(E), ends[:, 0]], xy[np.arange(E), ends[:, 1]]
    approach = a[:, None] + (b - a)[:, None] * rng.rand(E, n, 1)
    poses = {"on-road": (on_road, jitter(beta[envs, tiles])),
             "seam": (seam, jitter(np.repeat(beta[:, :1], n, 1))),
             "kerb": (kerb, jitter(beta[envs, kerb_tiles])),
             "off-road": (off, rng.uniform(-np.pi, np.pi, (E, n))),
             "self-approach": (approach, rng.uniform(-np.pi, np.pi, (E, n)))}
    wheel_pos = np.asarray(shapes.WHEEL_POS, np.float64)
    out = {}
    for name, (pos, ang) in poses.items():
        c, s = np.cos(ang)[..., None], np.sin(ang)[..., None]
        wheel_c = pos[:, :, None] + np.stack([c * wheel_pos[:, 0] - s * wheel_pos[:, 1],
                                              s * wheel_pos[:, 0] + c * wheel_pos[:, 1]], -1)
        steer = rng.uniform(-0.4, 0.4, (E, n))
        wheel_a = ang[..., None] + np.stack([steer, steer, 0 * steer, 0 * steer], -1)
        cars = create_cars(f32(pos), f32(ang)).replace(wheel_c=f32(wheel_c),
                                                       wheel_a=f32(wheel_a))
        post = f32(pos + rng.normal(0, 0.3, pos.shape))
        visited = torch.as_tensor(rng.rand(E, n, MT) < 0.3, device=dev) & track.valid[:, None]
        touched = torch.as_tensor(rng.rand(E, MT) < 0.2, device=dev)
        out[name] = (cars, post, visited, touched)
    cars, post, visited, touched = out["on-road"]
    out["wheels-only"] = (cars.replace(hull_c=cars.hull_c + LIFT_M), post + LIFT_M, visited,
                          touched)
    return out


def cull_probes(track, n: int, seed: int = CULL_SEED) -> dict:
    """Inputs on which the cull drops tiles the plain pass marks: name ->
    (track with every centreline point moved PROBE_SHIFT_M in a random
    direction per env, pre-solve cars, post-solve origin, visited,
    tile_touched). The quads stay, so a tile's reach about its moved point
    no longer holds its vertices. 'probe, wheels only' is cull_cases'
    'wheels-only' (only the wheel term keeps tiles); 'probe, origins only'
    is its 'on-road' with the wheels LIFT_M away (only the origin terms
    do)."""
    rng = np.random.RandomState(seed + 31 * n)
    E = track.xy.shape[0]
    ang = rng.uniform(-np.pi, np.pi, E)
    shift = torch.as_tensor(PROBE_SHIFT_M * np.stack([np.cos(ang), np.sin(ang)], -1),
                            dtype=torch.float32, device=track.xy.device)
    moved = dataclasses.replace(track, xy=(track.xy + shift[:, None]).contiguous())
    cases = cull_cases(track, n, seed)
    cars, post, visited, touched = cases["on-road"]
    lifted = cars.replace(wheel_c=cars.wheel_c + LIFT_M)
    return {"probe, wheels only": (moved,) + cases["wheels-only"],
            "probe, origins only": (moved, lifted, post, visited, touched)}
