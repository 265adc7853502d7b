"""Work of K6 (``csrc/paint_view.cu``, the 96x96 painter) on one observation.

Frozen copy of ``paint_work`` of ``multi_car_racing_tpu_torch/render/
pixels.py`` (commit 3d8d1d4), on the scene of the benchmark's plain
reference (``reference/render/pixels._scene``). Bytes: every table read
once (each view's slot tables; the track tables of the envs with a warm
view) and every output byte written once. Operations: the background's 12
per pixel, and one edge test (two products, a difference and the
constant's sum: 4 operations) per pixel centre inside each painted
polygon's window-space bounding box -- the windowed tiles and curbs of a
steady view, the whole valid track of a warm view, and the active car and
flag polygons. A painter needs no test outside a polygon's box; the HUD
rects and glyphs are left out.
"""

import torch

from benchmark.reference.render import pixels as P

WHEN = "obs"
KERNELS = ("paint_view_kernel",)


def _bbox_pixels(poly, mask) -> float:
    """Pixel centres inside the window-space bounding boxes of the polygons
    (..., k, 2) where ``mask`` (...) holds, summed."""
    def span(c):
        lo = torch.clamp(torch.ceil(c.amin(-1)), min=0.0)
        return torch.clamp(torch.clamp(torch.floor(c.amax(-1)), max=P.H - 1.0) - lo + 1.0,
                           min=0.0)
    n = span(P._row_of_wy(poly[..., 1])) * span(P._col_of_wx(poly[..., 0]))
    return float((n.to(torch.float64) * mask.to(torch.float64)).sum())


def paint_work(cfg, state) -> tuple[int, int]:
    """(bytes, fp32 operations) that one paint of this state's views needs."""
    sc = P._scene(cfg, state)
    track = state.track
    E, n = sc["warm"].shape
    V, px = E * n, P.H * P.W
    warm = sc["warm"] > 0
    road = warm[..., None] | sc["wmask"]                            # (E, N, MT)
    edge_px = (_bbox_pixels(sc["to_win"](track.quad[:, None], 2), road & track.valid[:, None])
               + _bbox_pixels(sc["to_win"](track.curb_quad[:, None], 2),
                              road & track.has_curb[:, None])
               + _bbox_pixels(sc["q4"][0], sc["q4"][2] > 0)
               + _bbox_pixels(sc["p8"][0], sc["p8"][2] > 0))
    flops = int(4 * edge_px) + 12 * V * px
    table_words = (8 + P.SQ * P.QW + 8 * n * P.QW + sc["p8"][0].shape[2] * P.PW
                   + P.SR * 8 + 4 * 8)
    warm_envs = int(warm.any(-1).sum())
    nbytes = V * table_words * 4 + warm_envs * track.max_tiles * (2 * 8 * 4 + 4) + V * px * 3
    return nbytes, flops


def work(obs) -> tuple[int, int]:
    """(fp32 operations, bytes) of one observation of every view."""
    nbytes, flops = paint_work(obs.cfg, obs.post)
    return flops, nbytes
