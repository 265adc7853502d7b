"""Pixel observations in plain PyTorch: E envs of N cars -> (E, N, 96, 96, 3) uint8.

Frozen copy of ``multi_car_racing_tpu_torch/render/pixels.py`` (commit
3d8d1d4) up to and including ``paint_views_plain``: ``view_inputs`` (the
painter's per-view slot tables) and the plain painter that the port's kernel
``csrc/paint_view.cu`` (K6) stands for. Every product and sum of the painter
is its own op, so each rounds as the kernel's ``__f*_rn`` do.

Paint order (mcr:309-334, 559-674): background (grass and checker in world
space, white outside the playfield); road tiles with their curbs -- the
windowed quad slots in steady state, or, during the first-second zoom-out
(``warm``), the env's whole track in world space, tile i then its curb;
per car its 4 wheels each followed by its marker, then its 4 hull polygons;
the 8 HUD rects; the 4 score glyphs; the backwards-flag triangle last.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import config as C
from . import geometry as G
from . import raster as R
from .geometry import f32

H, W = C.STATE_H, C.STATE_W
BAND = 32          # the JAX band height of quad and rect slots (band start clip)
CAR_BAND = 16      # the JAX band height of car slots
SQ = 2 * R.WS      # quad slots: tile and curb interleaved
SR = 8             # rect slots: black bar, 5 vertical and 2 horizontal bars
QW, PW = 16, 28    # widths of a 4-edge and an 8-edge slot row
SCORE_ROW0 = H - 16   # the glyphs lie in the bottom 16 rows
VIEW_CHUNK = 4096     # views per pass of the plain painter (bounds its memory)
# The score font: 10 digits and a minus sign.
FONT = np.concatenate([G.DIGIT_FONT, [[0, 0, 0, 0b11111, 0, 0, 0]]]).astype(np.int32)


def _row_of_wy(wy):
    return (H - 0.5) - wy * f32(H / C.WINDOW_H)


def _col_of_wx(wx):
    return wx * f32(W / C.WINDOW_W) - 0.5


def _band_start(rmin, band=BAND):
    return torch.clamp(torch.floor(rmin) - 1.0, 0, H - band)


def _edge_coefs(poly):
    """(..., V, 2) polygon -> (..., 3V) edge coefficients [c1, c2, k0]*V with
    the orientation sign folded in: interior pixels satisfy
    c2*y - c1*x + k0 >= 0 for every edge whatever the winding (the sign flip
    is an exact negation)."""
    b = torch.roll(poly, -1, dims=-2)
    c1 = b[..., 1] - poly[..., 1]
    c2 = b[..., 0] - poly[..., 0]
    k0 = c1 * poly[..., 0] - c2 * poly[..., 1]
    shoelace = torch.sum(poly[..., 0] * b[..., 1] - poly[..., 1] * b[..., 0], dim=-1)
    sgn = torch.where(shoelace < 0, -1.0, 1.0)[..., None, None]
    coef = torch.stack([c1, c2, k0], dim=-1) * sgn
    return coef.reshape(poly.shape[:-2] + (3 * poly.shape[-2],))


def _compact(mask: torch.Tensor, size: int):
    """Stable compaction along the last dim: (source index (..., size) int64,
    filled (..., size) bool). Output j takes the j-th set position of
    ``mask`` in order; outputs past the count are not filled."""
    pos = torch.cumsum(mask.to(torch.int64), dim=-1) - 1
    dst = torch.where(mask, pos, torch.full_like(pos, size))
    src = torch.zeros(mask.shape[:-1] + (size + 1,), dtype=torch.int64, device=mask.device)
    iota = torch.arange(mask.shape[-1], device=mask.device).expand_as(dst)
    src.scatter_(-1, dst, iota)      # every filled j is written exactly once
    filled = torch.arange(size, device=mask.device) < mask.sum(-1, keepdim=True)
    return src[..., :size], filled


def _pack(pv, pal, active, r0):
    """Slot rows [edge coefficients, palette, active, band start, 0]."""
    return torch.cat([_edge_coefs(pv), pal[..., None], active[..., None], r0[..., None],
                      torch.zeros_like(r0)[..., None]], dim=-1)


def _onscreen(rows, cols):
    return ((rows.amax(-1) >= 0) & (rows.amin(-1) < H)
            & (cols.amax(-1) >= 0) & (cols.amin(-1) < W))


def _pack_quads(quads, pals, valid):
    rows, cols = _row_of_wy(quads[..., 1]), _col_of_wx(quads[..., 0])
    active = (valid & _onscreen(rows, cols)).to(quads.dtype)
    return _pack(quads, pals.to(quads.dtype), active, _band_start(rows.amin(-1)))


def _pack_polys(pv, pal, active, band):
    rows, cols = _row_of_wy(pv[..., 1]), _col_of_wx(pv[..., 0])
    return _pack(pv, pal, active * _onscreen(rows, cols),
                 _band_start(rows.amin(-1), band))


def _hull_palette(cfg) -> np.ndarray:
    """(view, car) hull palette indices (mcr:559-563)."""
    n = cfg.num_agents
    if cfg.use_ego_color:
        pal = np.full((n, n), R.PAL_CAR0 + 1, np.int32)          # others blue
        np.fill_diagonal(pal, R.PAL_CAR0)                         # ego red
        return pal
    return np.tile((R.PAL_CAR0 + np.arange(n) % len(C.CAR_COLORS)).astype(np.int32), (n, 1))


def _scene(cfg, state) -> dict:
    """``view_inputs``' geometry before packing, in window coordinates: the
    camera (zoom (E,), angles (E, N), trans (E, N, 2), ``to_win``), the warm
    flags (E, N), the tile window mask (E, N, MT) in creation order, and the
    car polygons with their palettes and active flags."""
    n = cfg.num_agents
    track = state.track
    E, mt = state.t.shape[0], track.max_tiles
    dev, ft = state.t.device, state.t.dtype
    zoom, angles, trans = G.camera(cfg, state)

    def to_win(pts, extra):
        one = (1,) * extra
        return G.world_to_window(pts, zoom.view((E, 1) + one), angles.view((E, n) + one),
                                 trans.view((E, n) + one + (2,)))

    warm = (zoom < f32(0.999 * C.ZOOM * C.SCALE)).to(ft)[:, None].expand(E, n)

    # The two tile windows as a mask (compacted stably by the caller: the
    # same tiles in the same ascending creation (paint) order as the JAX
    # one-hot product).
    ccx, ccy = G.window_to_world(
        torch.full((E, n), C.WINDOW_W / 2, dtype=ft, device=dev),
        torch.full((E, n), C.WINDOW_H / 2, dtype=ft, device=dev),
        zoom[:, None], angles, trans)
    iota = torch.arange(mt, device=dev)
    centers = torch.stack([ccx, ccy], dim=-1)                       # (E, N, 2)
    d2 = torch.sum(torch.square(centers[:, :, None, :] - track.xy[:, None]), dim=-1)
    valid = track.valid[:, None, :]
    d2 = torch.where(valid, d2, torch.full_like(d2, float("inf")))
    ntil = track.n_tiles.to(torch.int64)[:, None]
    near1 = torch.argmin(d2, dim=-1)
    s1 = torch.remainder(near1 - R.W1 // 2, ntil)
    in1 = (torch.remainder(iota - s1[..., None], ntil[..., None]) < R.W1) & valid
    near2 = torch.argmin(torch.where(in1, torch.full_like(d2, float("inf")), d2), dim=-1)
    s2 = torch.remainder(near2 - R.W2 // 2, ntil)
    wmask = in1 | ((torch.remainder(iota - s2[..., None], ntil[..., None]) < R.W2) & valid)

    # Car polygons: 8 wheel/marker quads then 4 hull polygons per car.
    polys = G.car_polys_world(state.cars)
    wheels = to_win(polys["wheel_quads"][:, None], 3)              # (E, N, car, 4, 4, 2)
    markers = to_win(polys["marker_quads"][:, None], 3)
    q4_v = torch.stack([wheels, markers], dim=4).reshape(E, n, 8 * n, 4, 2)
    q4_p = torch.tensor([R.PAL_BLACK, R.PAL_WHEEL_WHITE] * 4 * n, dtype=ft,
                        device=dev).expand(E, n, 8 * n)
    q4_a = torch.stack([torch.ones_like(polys["marker_valid"], dtype=ft),
                        polys["marker_valid"].to(ft)], dim=-1).reshape(E, 1, 8 * n)

    p8_v = to_win(polys["hull_polys"][:, None], 3).reshape(E, n, 4 * n, 8, 2)
    hull_pal = torch.as_tensor(np.repeat(_hull_palette(cfg), 4, axis=1), dtype=ft,
                               device=dev).expand(E, n, 4 * n)
    p8_a = torch.ones((E, n, 4 * n), dtype=ft, device=dev)
    if cfg.backwards_flag:
        # Window-space triangle, painted after the HUD (mcr:668-674).
        tri = [[C.WINDOW_W - 100, 30], [C.WINDOW_W - 75, 70], [C.WINDOW_W - 50, 30]]
        tri8 = torch.tensor(tri + [tri[2]] * 5, dtype=ft, device=dev)
        p8_v = torch.cat([p8_v, tri8.expand(E, n, 1, 8, 2)], dim=2)
        hull_pal = torch.cat([hull_pal, torch.full((E, n, 1), float(R.PAL_ABS_BLUE),
                                                   dtype=ft, device=dev)], dim=2)
        p8_a = torch.cat([p8_a, state.driving_backward.to(ft)[..., None]], dim=2)
    return dict(zoom=zoom, angles=angles, trans=trans, to_win=to_win, warm=warm,
                wmask=wmask, q4=(q4_v, q4_p, q4_a.expand(E, n, 8 * n)),
                p8=(p8_v, hull_pal, p8_a))


def view_inputs(cfg, state):
    """The painter's per-view tables of E envs (port of the JAX
    ``pallas_raster._view_inputs``, batched over envs). Returns

      cam (E, N, 8) f32: cos, sin, trans x, trans y, 1/zoom, warm, the
        active quad count, 0;
      quads (E, N, 80, 16) f32: windowed tile and curb slots, active first;
      q4 (E, N, 8N, 16) f32: per car 4 x (wheel, marker);
      p8 (E, N, 4N [+1], 28) f32: per car 4 hull polygons [, flag];
      rects (E, N, 8, 8) f32: xa, xb, ya, yb, palette, 1, band start, 0;
      score (E, N, 4, 8) int32: glyph row bits of "%04i".

    A slot row is [c1, c2, k0] per edge, palette, active, band start, 0."""
    n = cfg.num_agents
    track = state.track
    E, mt = state.t.shape[0], track.max_tiles
    dev, ft, i32 = state.t.device, state.t.dtype, torch.int32
    sc = _scene(cfg, state)
    zoom, angles, trans, to_win = sc["zoom"], sc["angles"], sc["trans"], sc["to_win"]
    ca, sa = torch.cos(angles), torch.sin(angles)

    # --- quad slots: windowed tiles + curbs, interleaved (paint order).
    iota = torch.arange(mt, device=dev)
    tile_pal = torch.where(state.tile_touched, R.PAL_ROAD0, R.PAL_ROAD0 + iota % 3).to(i32)
    curb_pal = torch.where(track.curb_red, R.PAL_RED, R.PAL_WHITE).to(i32)
    src, filled = _compact(sc["wmask"], R.WS)                       # (E, N, WS)
    env = torch.arange(E, device=dev)[:, None, None]

    def take(x):
        g = x[env, src]
        return torch.where(filled.view(filled.shape + (1,) * (g.dim() - 3)), g,
                           torch.zeros_like(g))

    tq = to_win(take(track.quad), 2)                                # (E, N, WS, 4, 2)
    cq = to_win(take(track.curb_quad), 2)
    quads = torch.stack([tq, cq], dim=3).reshape(E, n, SQ, 4, 2)
    pals = torch.stack([take(tile_pal), take(curb_pal)], dim=3).reshape(E, n, SQ)
    vmask = torch.stack([take(track.valid), take(track.has_curb)], dim=3).reshape(E, n, SQ)
    slots = _pack_quads(quads, pals, vmask)
    # Active slots to the front, in order; the kernel loops over the count.
    act = slots[..., 13] > 0.0
    nq = act.sum(-1).to(ft)
    src2, filled2 = _compact(act, SQ)
    slots = torch.gather(slots, 2, src2[..., None].expand(E, n, SQ, QW))
    quad_slots = torch.where(filled2[..., None], slots, torch.zeros_like(slots))

    cam = torch.stack([ca, sa, trans[..., 0], trans[..., 1],
                       (1.0 / zoom)[:, None] * torch.ones_like(ca),
                       sc["warm"], nq, torch.zeros_like(ca)], dim=-1)   # (E, N, 8)

    # --- car slots.
    quad4_slots = _pack_polys(*sc["q4"], CAR_BAND)
    poly8_slots = _pack_polys(*sc["p8"], CAR_BAND)

    # --- HUD rects (window coords; a negative value flips via min/max).
    hud = G.hud_values(state)
    s, h = G.HUD_S, G.HUD_H
    z = torch.zeros_like(hud["speed"])
    o = torch.ones_like(hud["speed"])
    rects = [
        (z, C.WINDOW_W * o, z, 5 * h * o, R.PAL_BLACK),
        (5 * s * o, 6 * s * o, h * o, h + h * hud["speed"], R.PAL_WHITE),
        (7 * s * o, 8 * s * o, h * o, h + h * hud["abs0"], R.PAL_ABS_BLUE),
        (8 * s * o, 9 * s * o, h * o, h + h * hud["abs1"], R.PAL_ABS_BLUE),
        (9 * s * o, 10 * s * o, h * o, h + h * hud["abs2"], R.PAL_ABS_BLUE2),
        (10 * s * o, 11 * s * o, h * o, h + h * hud["abs3"], R.PAL_ABS_BLUE2),
        (20 * s * o, 20 * s + hud["steer"] * s, 2 * h * o, 4 * h * o, R.PAL_GREEN),
        (30 * s * o, 30 * s + hud["gyro"] * s, 2 * h * o, 4 * h * o, R.PAL_RED),
    ]
    rect_rows = []
    for x0, x1, y0, y1, pal in rects:
        ya, yb = torch.minimum(y0, y1), torch.maximum(y0, y1)
        rect_rows.append(torch.stack(
            [torch.minimum(x0, x1), torch.maximum(x0, x1), ya, yb, pal * o, o,
             _band_start(_row_of_wy(yb)), z], dim=-1))
    rect_slots = torch.stack(rect_rows, dim=2)                      # (E, N, 8, 8)

    # --- score glyph row bits ("%04i", 5x7 font; minus is the 11th glyph).
    sc = torch.clamp(torch.trunc(state.reward), -999, 9999).to(torch.int64)
    a = torch.abs(sc)
    digits = torch.stack([a // 1000 % 10, a // 100 % 10, a // 10 % 10, a % 10], dim=-1)
    digits[..., 0] = torch.where(sc < 0, 10, digits[..., 0])
    bits = torch.as_tensor(FONT, device=dev)[digits]               # (E, N, 4, 7)
    score_bits = torch.cat([bits, torch.zeros_like(bits[..., :1])], dim=-1)

    return cam, quad_slots, quad4_slots, poly8_slots, rect_slots, score_bits


# ---------------------------------------------------------------------------
# The painter's plain PyTorch version
# ---------------------------------------------------------------------------

def _pixel_centres(device):
    """Window coords of the viewport's pixel centres, (H, W) each; row 0 is
    the window's top (JAX ``pallas_raster.py:371-374``)."""
    row = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    col = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    return (col + 0.5) * f32(C.WINDOW_W / W), (H - 0.5 - row) * f32(C.WINDOW_H / H), row


def _background(cam, wx, wy):
    ca, sa, tx, ty, inv = (cam[:, i, None, None] for i in range(5))
    dx, dy = wx - tx, wy - ty
    gx = (ca * dx + sa * dy) * inv
    gy = (-sa * dx + ca * dy) * inv
    k = f32(C.PLAYFIELD / 20.0)
    ix, iy = torch.floor(gx / k), torch.floor(gy / k)
    infield = (torch.abs(gx) <= f32(C.PLAYFIELD)) & (torch.abs(gy) <= f32(C.PLAYFIELD))
    lighter = ((torch.remainder(ix, 2) == 0) & (torch.remainder(iy, 2) == 0)
               & (ix >= -20) & (ix < 20) & (iy >= -20) & (iy < 20))
    idx = torch.where(infield, R.PAL_GRASS_DARK, R.PAL_WHITE)
    return torch.where(infield & lighter, R.PAL_GRASS_LIGHT, idx).to(torch.int32), gx, gy


def _paint_slot(idx, slot, nedges, wx, wy, row, extra=None):
    """One slot row per view (V, 3*nedges + 4) over (V, H, W) planes: every
    edge test c2*y - c1*x + k0 >= 0, active, rows from the band start."""
    e3 = 3 * nedges
    cov = (slot[:, e3 + 1, None, None] > 0) & (row >= slot[:, e3 + 2, None, None])
    if extra is not None:
        cov = cov & extra[:, None, None]
    for e in range(nedges):
        c1, c2, k0 = (slot[:, 3 * e + i, None, None] for i in range(3))
        cov = cov & (c2 * wy - c1 * wx + k0 >= 0.0)
    return torch.where(cov, slot[:, e3, None, None].to(torch.int32), idx)


def _world_quad(idx, q, pal, mask, gx, gy):
    """A world-space quad (V, 4, 2) of either winding, vertex form (the JAX
    kernel's warm branch, ``pallas_raster.py:473-495``)."""
    pos = neg = None
    for v in range(4):
        ax, ay = q[:, v, 0, None, None], q[:, v, 1, None, None]
        bx, by = q[:, (v + 1) % 4, 0, None, None], q[:, (v + 1) % 4, 1, None, None]
        c1 = by - ay
        c2 = bx - ax
        k0 = c1 * ax - c2 * ay
        cr = c2 * gy - c1 * gx + k0
        p, m = cr >= 0.0, cr <= 0.0
        pos = p if pos is None else pos & p
        neg = m if neg is None else neg & m
    cov = (pos | neg) & mask[:, None, None]
    return torch.where(cov, pal[:, None, None], idx)


def _paint_chunk(cam, quads, q4, p8, rects, score, track, n_cars):
    """Palette-index planes (V, H, W) int32 of V views; ``track`` holds each
    view's own env's warm-branch tables."""
    quad, curb_quad, touched, curb_red, valid, has_curb = track
    wx, wy, row = _pixel_centres(cam.device)
    idx, gx, gy = _background(cam, wx, wy)
    warm = cam[:, 5] > 0.0

    # Road: windowed slots (steady) or the whole track in world space (warm).
    nq = cam[:, 6]
    steady = ~warm
    for t in range(quads.shape[1]):
        idx = _paint_slot(idx, quads[:, t], 4, wx, wy, row, steady & (t < nq))
    wv = torch.nonzero(warm).flatten()
    if wv.numel():
        iw, gxw, gyw = idx[wv], gx[wv], gy[wv]
        mt = quad.shape[1]
        tile_pal = torch.where(touched[wv], R.PAL_ROAD0,
                               R.PAL_ROAD0 + torch.arange(mt, device=cam.device) % 3)
        curb_pal = torch.where(curb_red[wv], R.PAL_RED, R.PAL_WHITE)
        for t in range(mt):
            iw = _world_quad(iw, quad[wv, t], tile_pal[:, t].to(torch.int32),
                             valid[wv, t], gxw, gyw)
            iw = _world_quad(iw, curb_quad[wv, t], curb_pal[:, t].to(torch.int32),
                             has_curb[wv, t], gxw, gyw)
        idx = idx.index_copy(0, wv, iw)

    # Cars, in id order.
    for car in range(n_cars):
        for t in range(8 * car, 8 * car + 8):
            idx = _paint_slot(idx, q4[:, t], 4, wx, wy, row)
        for t in range(4 * car, 4 * car + 4):
            idx = _paint_slot(idx, p8[:, t], 8, wx, wy, row)

    # HUD rects.
    for t in range(SR):
        xa, xb, ya, yb, pal, _, r0 = (rects[:, t, i, None, None] for i in range(7))
        cov = (row >= r0) & (wx >= xa) & (wx <= xb) & (wy >= ya) & (wy <= yb)
        idx = torch.where(cov, pal.to(torch.int32), idx)

    # Score glyphs (bottom 16 rows).
    dyg = (f32(G.SCORE_Y + G.SCORE_DIGIT_H / 2) - wy) / f32(G.SCORE_DIGIT_H) * 7.0
    grow = torch.floor(dyg)
    for i in range(4):
        dxg = (wx - f32(G.SCORE_X + i * G.SCORE_SPACING)) / f32(G.SCORE_DIGIT_W) * 5.0
        gcol = torch.floor(dxg)
        inbox = (row >= SCORE_ROW0) & (gcol >= 0) & (gcol < 5) & (grow >= 0) & (grow < 7)
        rowbits = torch.gather(score[:, i], 1, grow.clamp(0, 7).to(torch.int64)
                               .reshape(1, -1).expand(score.shape[0], -1))
        rowbits = rowbits.view(-1, H, W)
        shift = torch.clamp(4 - gcol, 0, 4).to(torch.int32)
        on = inbox & (torch.bitwise_and(rowbits, torch.bitwise_left_shift(
            torch.ones_like(shift), shift)) > 0)
        idx = torch.where(on, R.PAL_WHITE, idx)

    # Backwards flag, last.
    if p8.shape[1] > 4 * n_cars:
        idx = _paint_slot(idx, p8[:, 4 * n_cars], 8, wx, wy, row)
    return idx


def paint_views_plain(cam, quads, q4, p8, rects, score, quad, curb_quad, tile_touched,
                      curb_red, valid, has_curb):
    """The painter in PyTorch ops: ``view_inputs``' tables (E, N, ...) and,
    for warm views, their env's track tables -- quad and curb_quad
    (E, MT, 4, 2) f32, tile_touched, curb_red, valid and has_curb (E, MT)
    bool -> (E, N, 96, 96, 3) uint8. Every product and sum is its own op, so
    each rounds as the kernel's ``__f*_rn`` do. Chunked over views."""
    E, n = cam.shape[:2]
    V = E * n
    flat = [x.reshape((V,) + x.shape[2:]) for x in (cam, quads, q4, p8, rects, score)]
    env_of_view = torch.arange(V, device=cam.device) // n
    tracks = (quad, curb_quad, tile_touched, curb_red, valid, has_curb)
    palette = torch.as_tensor(R.PALETTE_U8, device=cam.device)
    out = torch.empty((V, H, W, 3), dtype=torch.uint8, device=cam.device)
    for v0 in range(0, V, VIEW_CHUNK):
        sl = slice(v0, min(V, v0 + VIEW_CHUNK))
        envs = env_of_view[sl]
        idx = _paint_chunk(*(x[sl] for x in flat), tuple(x[envs] for x in tracks), n)
        out[sl] = palette[idx.to(torch.int64)]
    return out.view(E, n, H, W, 3)
