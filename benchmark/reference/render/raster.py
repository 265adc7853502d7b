# Frozen copy of multi_car_racing_tpu_torch/render/raster.py (commit 3d8d1d4): part of the
# benchmark's plain reference, which imports nothing of the port.
"""The palette, and the painter of any viewport (``render("rgb_array")``).

Port of the JAX package's ``render/raster.py``: its palette and tile-window
constants (``:36-80``; every colour the scene can produce lives in one
static palette, road dither levels included, so a painter paints palette
indices and expands them to RGB once at the end) and ``render_observation``
(``:152-386``), which paints every agent view of an env at any viewport
size: the 600x400 ``rgb_array`` frame of the Gym facade, with the skid
trails (``draw_particles``), or 96x96. In JAX it is XLA, not Pallas, so
here it is plain torch ops, with JAX's palette, draw order and arithmetic:
each coverage test is the JAX expression, evaluated on the pixels of the
polygon's window bounding box only (a margin of ``BBOX_MARGIN`` window
units around it), since no pixel outside can be covered. The observation
contract (96x96 per step, through the CUDA painter K6) is
``pixels.render_pixels``; this painter serves ``render()``.

Memory: the JAX particle pass forms (N, S, P) point-segment distances; this
one keeps the valid segments only and paints bands of ``BAND_ROWS`` rows,
each against the segments that reach it, at most ``BAND_ELEMENTS``
segment-pixel pairs at a time, so a 600x400 frame at N = 4 with every
ring full stays under 256 MB.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import config as C
from . import geometry as G
from . import particles
from .geometry import f32

W1 = 32   # primary tile window
W2 = 8    # secondary window (crossing sections)
WS = W1 + W2

PAL_WHITE = 0        # clear color / curb white / HUD white / score
PAL_GRASS_DARK = 1
PAL_GRASS_LIGHT = 2
PAL_ROAD0 = 3        # road + 0.00 dither == flattened "touched" color
PAL_ROAD1 = 4
PAL_ROAD2 = 5
PAL_RED = 6          # curb red / gyro bar red
PAL_BLACK = 7        # wheel / HUD bar black
PAL_WHEEL_WHITE = 8
PAL_CAR0 = 9         # 8 car colors: 9..16 (CAR_COLORS; ego red/blue reuse 9/10)
PAL_ABS_BLUE = 17    # (0, 0, 1): ABS bars front, backwards flag
PAL_ABS_BLUE2 = 18   # (0.2, 0, 1): ABS bars rear
PAL_GREEN = 19       # steering bar
PAL_MUD = 20         # skid particles on grass (rgb_array mode)

PALETTE = np.array(
    [
        (1.0, 1.0, 1.0),
        (0.4, 0.8, 0.4),
        (0.4, 0.9, 0.4),
        (0.4, 0.4, 0.4),
        (0.41, 0.41, 0.41),
        (0.42, 0.42, 0.42),
        (1.0, 0.0, 0.0),
        (0.0, 0.0, 0.0),
        C.WHEEL_WHITE,
    ]
    + list(C.CAR_COLORS)
    + [
        (0.0, 0.0, 1.0),
        (0.2, 0.0, 1.0),
        (0.0, 1.0, 0.0),
        C.MUD_COLOR,
    ],
    dtype=np.float32,
)
PALETTE_U8 = np.round(np.clip(PALETTE, 0, 1) * 255).astype(np.uint8)


BBOX_MARGIN = 4.0     # window units around a polygon's box (a pixel is >= 1.67)
BAND_ROWS = 16        # rows per band of the skid-trail pass
BAND_ELEMENTS = 1 << 20   # segment x pixel pairs per chunk of a band (4 MB per float plane)


def pixel_window_coords(vp_w: int, vp_h: int, device=None):
    """Window coordinates of viewport pixel centres: (vp_h, vp_w) each for x
    and y; row 0 = window top (JAX ``geometry.pixel_window_coords``)."""
    col = (torch.arange(vp_w, dtype=torch.float32, device=device) + 0.5) * f32(C.WINDOW_W / vp_w)
    row = (vp_h - 0.5 - torch.arange(vp_h, dtype=torch.float32, device=device)) \
        * f32(C.WINDOW_H / vp_h)
    return col[None, :].expand(vp_h, vp_w), row[:, None].expand(vp_h, vp_w)


def window_indices(xy: torch.Tensor, valid: torch.Tensor, n_tiles: int,
                   centers: torch.Tensor, w1: int = W1, w2: int = W2) -> torch.Tensor:
    """Two tile windows around each view's camera centre, merged ascending
    (the creation / paint order; a tile in both windows comes twice, as in
    JAX). One env's xy (MT, 2), valid (MT,); centers (V, 2) -> (V, w1+w2)
    int64."""
    d2 = torch.sum(torch.square(centers[:, None, :] - xy[None]), dim=-1)
    d2 = torch.where(valid[None], d2, torch.full_like(d2, float("inf")))
    near1 = torch.argmin(d2, dim=1)
    s1 = torch.remainder(near1 - w1 // 2, n_tiles)
    off = torch.remainder(torch.arange(xy.shape[0], device=xy.device)[None, :] - s1[:, None],
                          n_tiles)
    d2b = torch.where(off < w1, torch.full_like(d2, float("inf")), d2)
    near2 = torch.argmin(d2b, dim=1)
    s2 = torch.remainder(near2 - w2 // 2, n_tiles)
    i1 = torch.remainder(s1[:, None] + torch.arange(w1, device=xy.device)[None], n_tiles)
    i2 = torch.remainder(s2[:, None] + torch.arange(w2, device=xy.device)[None], n_tiles)
    return torch.sort(torch.cat([i1, i2], dim=1), dim=1).values


class _Plane:
    """One view's palette-index plane (H, W) int32 and its pixel centres'
    window (px, py) and world (gx, gy) coordinates; paints a polygon on the
    pixels of its bounding box only."""

    def __init__(self, idx, px, py, gx, gy):
        self.idx, self.px, self.py, self.gx, self.gy = idx, px, py, gx, gy
        self.h, self.w = idx.shape
        self.col_scale = self.w / C.WINDOW_W       # window x -> column
        self.row_scale = self.h / C.WINDOW_H       # window y -> rows from the bottom

    def rect(self, xmin: float, xmax: float, ymin: float, ymax: float):
        """The (row, column) slices of the pixels whose centres may lie in
        the window box, with BBOX_MARGIN around it; None when off screen."""
        m = BBOX_MARGIN
        if not (math.isfinite(xmin) and math.isfinite(xmax) and math.isfinite(ymin)
                and math.isfinite(ymax)):
            return None
        c0 = max(0, int(math.floor((xmin - m) * self.col_scale - 0.5)))
        c1 = min(self.w, int(math.ceil((xmax + m) * self.col_scale + 0.5)) + 1)
        r0 = max(0, int(math.floor(self.h - 0.5 - (ymax + m) * self.row_scale)))
        r1 = min(self.h, int(math.ceil(self.h - 0.5 - (ymin - m) * self.row_scale)) + 1)
        if c0 >= c1 or r0 >= r1:
            return None
        return slice(r0, r1), slice(c0, c1)

    def paint(self, sl, cov, pal: int) -> None:
        r, c = sl
        self.idx[r, c] = torch.where(cov, torch.full_like(self.idx[r, c], pal), self.idx[r, c])


def _poly_cov(poly, x, y):
    """JAX's ``quad_cov`` / ``poly_cov8``: (V, 2) polygon (window or world
    coords, either winding) over pixel coords x, y -> bool coverage, edges
    included."""
    pos = neg = None
    nv = poly.shape[0]
    for v in range(nv):
        ax, ay = poly[v, 0], poly[v, 1]
        bx, by = poly[(v + 1) % nv, 0], poly[(v + 1) % nv, 1]
        cr = (bx - ax) * (y - ay) - (by - ay) * (x - ax)
        p, q = cr >= 0, cr <= 0
        pos = p if pos is None else pos & p
        neg = q if neg is None else neg & q
    return pos | neg


def _boxes(polys: torch.Tensor) -> np.ndarray:
    """Window bounding boxes (..., 4) [xmin, xmax, ymin, ymax] of polygons
    (..., V, 2), read to the host in one transfer."""
    box = torch.stack([polys[..., 0].amin(-1), polys[..., 0].amax(-1),
                       polys[..., 1].amin(-1), polys[..., 1].amax(-1)], dim=-1)
    return box.detach().to("cpu", torch.float64).numpy()


def _paint_window_poly(plane: _Plane, poly, box, pal: int) -> None:
    sl = plane.rect(*box)
    if sl is not None:
        plane.paint(sl, _poly_cov(poly, plane.px[sl], plane.py[sl]), pal)


def _paint_world_poly(plane: _Plane, poly_world, box, pal: int) -> None:
    """A world-space quad tested in world coordinates (the JAX warm
    branch's ``cov_world``); ``box`` is its window bounding box."""
    sl = plane.rect(*box)
    if sl is not None:
        plane.paint(sl, _poly_cov(poly_world, plane.gx[sl], plane.gy[sl]), pal)


def _paint_skid(plane: _Plane, pa, pb, grass, hw: float) -> None:
    """The skid trails of one view: segments pa -> pb (S, 2) in window
    coords, the valid ones only, half-width ``hw``; black on road, then mud
    on grass (JAX ``raster.py:252-285``). Bands of BAND_ROWS rows, each
    against the segments whose box reaches it."""
    if pa.shape[0] == 0:
        return
    segs = torch.cat([pa, pb], dim=-1)
    ylo = torch.minimum(pa[:, 1], pb[:, 1]).detach().cpu().double().numpy()
    yhi = torch.maximum(pa[:, 1], pb[:, 1]).detach().cpu().double().numpy()
    m = hw + BBOX_MARGIN
    for r0 in range(0, plane.h, BAND_ROWS):
        r1 = min(plane.h, r0 + BAND_ROWS)
        # Window y of the band's pixel centres: rows r0..r1-1 from the top.
        y_top = (plane.h - 0.5 - r0) / plane.row_scale
        y_bot = (plane.h - 0.5 - (r1 - 1)) / plane.row_scale
        near = np.nonzero((yhi >= y_bot - m) & (ylo <= y_top + m))[0]
        if near.size == 0:
            continue
        x, y = plane.px[r0:r1].reshape(-1), plane.py[r0:r1].reshape(-1)
        black = mud = None
        step = max(1, BAND_ELEMENTS // x.numel())
        for c0 in range(0, near.size, step):
            sel = torch.as_tensor(near[c0:c0 + step], device=pa.device)
            covp = particles.coverage(segs[sel], x, y, hw)
            g = grass[sel, None]
            b, m_ = (covp & ~g).any(0), (covp & g).any(0)
            black = b if black is None else black | b
            mud = m_ if mud is None else mud | m_
        black, mud = black.view(r1 - r0, plane.w), mud.view(r1 - r0, plane.w)
        band = plane.idx[r0:r1]
        band = torch.where(black, torch.full_like(band, PAL_BLACK), band)
        plane.idx[r0:r1] = torch.where(mud, torch.full_like(band, PAL_MUD), band)


def _hull_palette(cfg) -> np.ndarray:
    n = cfg.num_agents
    if cfg.use_ego_color:
        pal = np.full((n, n), PAL_CAR0 + 1, np.int32)           # blue
        np.fill_diagonal(pal, PAL_CAR0)                          # ego red
        return pal
    return np.tile((PAL_CAR0 + np.arange(n) % len(C.CAR_COLORS)).astype(np.int32), (n, 1))


def _render_env(cfg, state, e: int, cam, polys, hud, skid, vp_w: int, vp_h: int,
                draw_particles: bool):
    """All agent views of env ``e`` -> (N, vp_h, vp_w) int32 palette
    indices."""
    n = cfg.num_agents
    track = state.track
    dev = state.t.device
    zoom_all, angles_all, trans_all = cam
    zoom, angles, trans = zoom_all[e], angles_all[e], trans_all[e]      # (), (N,), (N, 2)
    wx, wy = pixel_window_coords(vp_w, vp_h, dev)

    def to_win(pts, v):        # world (..., 2) -> view v's window coords
        return G.world_to_window(pts, zoom, angles[v], trans[v])

    # Camera centres and the two tile windows per view.
    ccx, ccy = G.window_to_world(
        torch.full((n,), C.WINDOW_W / 2, dtype=torch.float32, device=dev),
        torch.full((n,), C.WINDOW_H / 2, dtype=torch.float32, device=dev),
        zoom, angles, trans)
    n_tiles = int(track.n_tiles[e])
    widx = window_indices(track.xy[e], track.valid[e], n_tiles, torch.stack([ccx, ccy], -1))
    mt = track.max_tiles
    tile_pal = torch.where(state.tile_touched[e], PAL_ROAD0,
                           PAL_ROAD0 + torch.arange(mt, device=dev) % 3).tolist()
    curb_pal = torch.where(track.curb_red[e], PAL_RED, PAL_WHITE).tolist()
    valid = track.valid[e].tolist()
    has_curb = track.has_curb[e].tolist()
    warm = bool(zoom < f32(0.999 * C.ZOOM * C.SCALE))
    hull_pal = _hull_palette(cfg)
    k = f32(C.PLAYFIELD / 20.0)
    if draw_particles:          # env e's trails, its env axis kept
        skid_e = particles.SkidState(**{f.name: getattr(skid, f.name)[e:e + 1]
                                        for f in dataclasses.fields(skid)})

    out = []
    for v in range(n):
        # ---- background (white / grass / checker) in world space.
        gx, gy = G.window_to_world(wx, wy, zoom, angles[v], trans[v])
        ix, iy = torch.floor(gx / k), torch.floor(gy / k)
        infield = (torch.abs(gx) <= f32(C.PLAYFIELD)) & (torch.abs(gy) <= f32(C.PLAYFIELD))
        lighter = ((torch.remainder(ix, 2) == 0) & (torch.remainder(iy, 2) == 0)
                   & (ix >= -20) & (ix < 20) & (iy >= -20) & (iy < 20))
        idx = torch.full((vp_h, vp_w), PAL_WHITE, dtype=torch.int32, device=dev)
        idx = torch.where(infield, PAL_GRASS_DARK, idx)
        idx = torch.where(infield & lighter, PAL_GRASS_LIGHT, idx).to(torch.int32)
        plane = _Plane(idx, wx, wy, gx, gy)

        # ---- road tiles + curbs: the windows (steady) or, during the
        # first-second zoom-out (mcr:540), the whole track in world space,
        # tile i then curb i (JAX's priority-max is this painter's order).
        if warm:
            ids = list(range(mt))
        else:
            ids = widx[v].tolist()
        idt = torch.as_tensor(ids, device=dev)
        tq, cq = track.quad[e, idt], track.curb_quad[e, idt]        # (S, 4, 2) world
        tqw, cqw = to_win(tq, v), to_win(cq, v)
        tbox, cbox = _boxes(tqw), _boxes(cqw)
        for j, t in enumerate(ids):
            if warm:
                if valid[t]:
                    _paint_world_poly(plane, tq[j], tbox[j], tile_pal[t])
                if has_curb[t]:
                    _paint_world_poly(plane, cq[j], cbox[j], curb_pal[t])
            else:
                if valid[t]:
                    _paint_window_poly(plane, tqw[j], tbox[j], tile_pal[t])
                if has_curb[t]:
                    _paint_window_poly(plane, cqw[j], cbox[j], curb_pal[t])

        # ---- skid trails (under the cars, as in the reference's draw order).
        if draw_particles:
            win, _, keep = particles.segments_window(skid_e, lambda p: to_win(p, v))
            sel = torch.nonzero(keep[0]).flatten()
            if sel.numel():
                hw = max(1.0, 0.6 * C.WINDOW_W / vp_w)
                _paint_skid(plane, win[0, sel, 0:2], win[0, sel, 2:4],
                            skid.grass[e].reshape(-1)[sel], hw)

        # ---- cars, in id order: wheels with their markers, then the hulls.
        wq = to_win(polys["wheel_quads"][e], v)                  # (N, 4, 4, 2)
        mq = to_win(polys["marker_quads"][e], v)
        hp = to_win(polys["hull_polys"][e], v)                   # (N, 4, 8, 2)
        wbox, mbox, hbox = _boxes(wq), _boxes(mq), _boxes(hp)
        mvalid = polys["marker_valid"][e].tolist()
        for car in range(n):
            for w in range(4):
                _paint_window_poly(plane, wq[car, w], wbox[car, w], PAL_BLACK)
                if mvalid[car][w]:
                    _paint_window_poly(plane, mq[car, w], mbox[car, w], PAL_WHEEL_WHITE)
            for h in range(4):
                _paint_window_poly(plane, hp[car, h], hbox[car, h], int(hull_pal[v, car]))

        # ---- HUD (window coordinates).
        idx = plane.idx
        s, h = G.HUD_S, G.HUD_H

        def rect_cov(x0, x1, y0, y1):
            xa, xb = torch.minimum(x0, x1), torch.maximum(x0, x1)
            ya, yb = torch.minimum(y0, y1), torch.maximum(y0, y1)
            return (wx >= xa) & (wx <= xb) & (wy >= ya) & (wy <= yb)

        def c(x):
            return torch.tensor(x, dtype=torch.float32, device=dev)

        idx = torch.where(rect_cov(c(0.0), c(C.WINDOW_W), c(0.0), c(5 * h)), PAL_BLACK, idx)
        for place, key, pal in ((5, "speed", PAL_WHITE), (7, "abs0", PAL_ABS_BLUE),
                                (8, "abs1", PAL_ABS_BLUE), (9, "abs2", PAL_ABS_BLUE2),
                                (10, "abs3", PAL_ABS_BLUE2)):
            cov = rect_cov(c(place * s), c((place + 1) * s), c(h), h + h * hud[key][e, v])
            idx = torch.where(cov, pal, idx)
        for place, key, pal in ((20, "steer", PAL_GREEN), (30, "gyro", PAL_RED)):
            cov = rect_cov(c(place * s), place * s + hud[key][e, v] * s, c(2 * h), c(4 * h))
            idx = torch.where(cov, pal, idx)

        # ---- score digits ("%04i", 5x7 glyphs at the label box).
        sc = int(torch.clamp(torch.trunc(state.reward[e, v]), -999, 9999))
        a = abs(sc)
        chars = [a // 1000 % 10, a // 100 % 10, a // 10 % 10, a % 10]
        if sc < 0:
            chars[0] = 10
        font = np.concatenate([G.DIGIT_FONT, [[0, 0, 0, 0b11111, 0, 0, 0]]]).astype(np.int64)
        dyg = (f32(G.SCORE_Y + G.SCORE_DIGIT_H / 2) - wy) / f32(G.SCORE_DIGIT_H) * 7.0
        grow = torch.floor(dyg).to(torch.int64)
        for i in range(4):
            dxg = (wx - f32(G.SCORE_X + i * G.SCORE_SPACING)) / f32(G.SCORE_DIGIT_W) * 5.0
            gcol = torch.floor(dxg).to(torch.int64)
            inbox = (gcol >= 0) & (gcol < 5) & (grow >= 0) & (grow < 7)
            bits = torch.as_tensor(font[chars[i]], device=dev)
            rowbits = bits[grow.clamp(0, 6)]
            on = inbox & (torch.bitwise_and(rowbits, torch.bitwise_left_shift(
                torch.ones_like(gcol), 4 - gcol.clamp(0, 4))) > 0)
            idx = torch.where(on, PAL_WHITE, idx)

        # ---- backwards flag triangle (painted last, mcr:668-674).
        if cfg.backwards_flag and bool(hud["backward"][e, v]):
            tri = [[C.WINDOW_W - 100, 30], [C.WINDOW_W - 75, 70], [C.WINDOW_W - 50, 30]]
            tri8 = torch.tensor(tri + [tri[2]] * 5, dtype=torch.float32, device=dev)
            idx = torch.where(_poly_cov(tri8, wx, wy), PAL_ABS_BLUE, idx)
        out.append(idx.to(torch.int32))
    return torch.stack(out)


def render_observation(cfg, state, vp_w: int = C.STATE_W, vp_h: int = C.STATE_H,
                       draw_particles: bool = False) -> torch.Tensor:
    """Every agent view of every env -> (E, N, vp_h, vp_w, 3) uint8, on the
    state's device.

    ``draw_particles`` overlays the skid trails (a ``cfg.track_skid`` state;
    the reference draws them only in the non-state_pixels modes, mcr:564).
    Envs are painted one after another."""
    E = state.t.shape[0]
    cam = G.camera(cfg, state)
    polys = G.car_polys_world(state.cars)
    hud = G.hud_values(state)
    palette = torch.as_tensor(PALETTE_U8, device=state.t.device)
    idx = torch.stack([_render_env(cfg, state, e, cam, polys, hud, state.skid, vp_w, vp_h,
                                   draw_particles) for e in range(E)])
    return palette[idx.to(torch.int64)]
