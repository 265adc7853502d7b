"""The port's pixel stage at N = 33 cars an env (past the 32 that K6 once
took) against the JAX package on the CPU: ``view_inputs`` and
``paint_views_plain`` on a host track's spawn grid, every view steady (the
windowed slots; 33 cars, so each view's 8N wheel and 4N hull slots hold 264
and 133 rows).

- The slot tables against JAX's jitted ``pallas_raster._view_inputs``, under
  tests/test_torch_render.py's bars: flags, band starts, palettes, counts and
  score bits equal; camera scalars within 1e-6 * max(1, |x|); the active
  slots' edge coefficients within 4e-6 * S (c1, c2) and 4e-6 * S^2 (k0),
  where S is that file's M or, when larger, the view's zoom times its
  largest world coordinate (``_coef_check``: the scale at which XLA rounds
  a window coordinate), and a slot that is a line in either sign.
- The pixels: ``paint_views_plain`` on the port's tables against the same
  painter on JAX's tables. JAX's own XLA painter (``raster.render_observation``)
  takes minutes to compile at N = 33 on a CPU, and the painter on JAX's
  tables gives its pixels: the tables are where the two packages differ, by
  XLA's fused multiply-adds (the coefficient bar above). So every pixel is
  equal but where a pixel centre lies within that bar of a slot's edge: each
  differing pixel must have a slot that covers it within the bar and misses
  it within the bar (its rounding can flip it either way)."""

from functools import partial

import jax
import numpy as np
import torch

from multi_car_racing_tpu import config as JC
from multi_car_racing_tpu.render import pallas_raster as JPR

from multi_car_racing_tpu_torch import EnvConfig, config as C, convert, env as penv
from multi_car_racing_tpu_torch.render import pixels as PP
from test_torch_obs import jax_state
from test_torch_render import COEF_TOL, close
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

N = 33


def _coef_check(label, ref, got, nedges, scale):
    """The active slots' meta columns equal and their edge coefficients
    within COEF_TOL * S (c1, c2) and COEF_TOL * S^2 (k0), where S = max(M,
    Z): M, test_torch_render's lower bound of the slot's largest window
    coordinate, and Z = ``scale``, the view's zoom times its largest world
    coordinate. A window coordinate is trans + ca*x - sa*y of x and y =
    world * zoom (geometry.world_to_window), so XLA's contraction of it into
    fused multiply-adds rounds at the scale of Z; the goldens of
    test_torch_render.py lie near the world's origin (Z <= M), this
    track's cars up to 500 m away. A slot that is a line (opposite edges
    cancel: a wheel marker seen edge-on) may come with either sign: its
    folding sign is that of an area of zero, which rounding decides, and
    either sign paints the same pixels (those on the line). Returns S per
    slot."""
    e3 = 3 * nedges
    assert np.array_equal(ref[..., e3:], got[..., e3:]), f"{label}: palette/active/band"
    rc = ref[..., :e3].reshape(ref.shape[:-1] + (nedges, 3)).astype(np.float64)
    gc = got[..., :e3].reshape(ref.shape[:-1] + (nedges, 3)).astype(np.float64)
    if nedges == 4:
        line = np.all(np.abs(rc[..., :2, :] + rc[..., 2:, :])
                      <= 1e-3 * np.maximum(1.0, np.abs(rc[..., :2, :])), axis=(-1, -2))
        flip = line & (np.abs(gc + rc).max((-1, -2)) < np.abs(gc - rc).max((-1, -2)))
        gc[flip] *= -1
    span = np.abs(rc[..., 0]) + np.abs(rc[..., 1])
    m = np.maximum(1.0, (np.abs(rc[..., 2]) / np.maximum(span, 1e-30)).max(-1))
    big = np.maximum(m, scale[..., None])
    act = ref[..., e3 + 1] > 0
    assert act.any(), label
    dc = np.abs(rc[..., :2] - gc[..., :2]).max(-1).max(-1)
    dk = np.abs(rc[..., 2] - gc[..., 2]).max(-1)
    assert (dc <= COEF_TOL * big)[act].all(), (label, float((dc / big)[act].max()))
    assert (dk <= COEF_TOL * big * big)[act].all(), (label, float((dk / big ** 2)[act].max()))
    return big


def _ambiguous(slots, big, nedges, v, r, c):
    """Whether an active slot of view ``v`` (rows [c1, c2, k0] x nedges,
    palette, active, band start, 0; ``big`` its bar's scale S) has pixel (r,
    c) on an edge within the coefficient bar: every edge value at the pixel
    centre >= -bound and the least <= bound, bound = COEF_TOL * S * (|wx| +
    |wy| + S)."""
    wx = (c + 0.5) * (C.WINDOW_W / PP.W)
    wy = (PP.H - 0.5 - r) * (C.WINDOW_H / PP.H)
    e3 = 3 * nedges
    s = slots[0, v].astype(np.float64)
    keep = (s[:, e3 + 1] > 0) & (r >= s[:, e3 + 2])
    coef = s[keep, :e3].reshape(-1, nedges, 3)
    b = big[0, v][keep]
    bound = COEF_TOL * b * (abs(wx) + abs(wy) + b)
    f = (coef[..., 1] * wy - coef[..., 0] * wx + coef[..., 2]).min(-1)
    return bool(((f >= -bound) & (f <= bound)).any())


def test_view_inputs_and_pixels_at_33_match_jax():
    cfg = EnvConfig(num_agents=N, use_random_direction=False)
    pool = penv.make_host_track_pool(cfg, (5,), device="cpu")
    order = torch.arange(N, dtype=torch.int32)[None]
    st = penv.spawn_state(cfg, pool, order, torch.zeros(1, dtype=torch.bool))
    st = st.replace(t=torch.full_like(st.t, 2.0))                  # steady views
    args = PP.paint_inputs(cfg, st)
    jcfg = JC.EnvConfig(num_agents=N, use_random_direction=False)
    ref = [np.asarray(x) for x in jax.jit(jax.vmap(partial(JPR._view_inputs, jcfg, n=N)))(
        jax_state(convert.env_state_to_numpy(st)))]
    got = [x.numpy() for x in args[:6]]
    close("cam", ref[0].reshape(got[0].shape)[..., :5], torch.from_numpy(got[0][..., :5]))
    assert np.array_equal(ref[0].reshape(got[0].shape)[..., 5:], got[0][..., 5:])
    assert not got[0][..., 5].any(), "setup: a warm view"
    world = float(st.track.xy.abs().max()) + 50.0        # the cars are on the track
    scale = world / got[0][..., 4]                        # zoom * |world| per view
    big = {}
    for label, i, ne in (("quads", 1, 4), ("q4", 2, 4), ("p8", 3, 8)):
        assert ref[i].shape == got[i].shape, label
        big[i] = _coef_check(label, ref[i], got[i], ne, scale)
    assert got[2].shape == (1, N, 8 * N, 16) and got[3].shape[2] in (4 * N, 4 * N + 1)
    assert np.array_equal(ref[4][..., 4:], got[4][..., 4:]) and np.array_equal(ref[5], got[5])

    img = PP.paint_views_plain(*args).numpy()
    jargs = [torch.from_numpy(np.array(x).reshape(a.shape)) for x, a in zip(ref, args[:6])]
    jimg = PP.paint_views_plain(*jargs, *args[6:]).numpy()
    assert img.shape == (1, N, 96, 96, 3) and img.dtype == np.uint8
    # Each view is its own: the ego car's colour and the neighbours differ.
    assert len({img[0, v].tobytes() for v in range(N)}) == N
    bad = np.argwhere((img != jimg).any(-1))
    assert len(bad) <= 8, len(bad)
    for _, v, r, c in bad.tolist():
        assert any(_ambiguous(got[i], big[i], ne, v, r, c)
                   for i, ne in ((1, 4), (2, 4), (3, 8))), (v, r, c)
