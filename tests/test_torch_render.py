"""The port's render geometry and slot tables (multi_car_racing_tpu_torch.render)
against the JAX package's, on the CPU, on the five 96x96 golden states
(tests/fixtures/golden: N = 1, 2 and 4 cars, CCW and CW, warm and steady,
ego colour, the backwards flag).

States: each fixture's 52 numpy leaves, with a leading env axis, go to both
packages -- to the port through ``convert.env_state_from_leaves``, to JAX
through ``tree_unflatten`` with the JAX ``EnvState``'s own tree structure.

Bars:
- geometry (``camera``, ``car_polys_world``, ``wheel_marker_local``,
  ``hud_values``): within 1e-6 * max(1, |x|) of JAX's jitted, vmapped
  functions; marker validity equal.
- slot tables (``view_inputs`` against JAX's jitted, vmapped
  ``pallas_raster._view_inputs``): the active flags, band starts, palettes,
  active counts, warm flags and score bits equal; the camera scalars within
  1e-6 * max(1, |x|); the edge coefficients of the active slots, in order,
  within 4e-6 * M for c1, c2 and 4e-6 * M^2 for k0, where M = max(1,
  max_e |k0_e| / (|c1_e| + |c2_e|)) is a lower bound of the slot's largest
  window coordinate. Coefficients are differences and products of window
  coordinates: XLA's CPU compiler contracts ``trans + ca*x - sa*y`` into two
  FMAs and its cos is one ulp off torch's on some angles, so the jitted
  JAX coordinates differ from the port's per-operation ones by an ulp or two
  (a few 1e-7 of M), and an edge of a millimetre-thin marker differs by far
  more than 1e-6 of itself.
  A numpy float32 version of the same tables (``_per_op_slots``), one
  rounding per operation, given the port's cos and sin of the view angles,
  meets the 1e-6 * max(1, |x|) bar on every active coefficient: the looser
  bar against JAX is owed to XLA's rounding alone. (torch's float32 cos can
  itself be an ulp off the correctly rounded value, and one ulp of cos
  moves a short edge's coefficient by ~1e-4 of itself, so the reference
  takes the cos and sin, not the angle.)
- ``env_state_from_leaves``: every leaf equal (dtype and value) to the
  state that JAX's unflattening gives.
"""

import glob
import json
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC
from multi_car_racing_tpu.render import geometry as JG, pallas_raster as JPR, raster as JR

from multi_car_racing_tpu_torch import EnvConfig, convert
from multi_car_racing_tpu_torch.render import geometry as PG, pixels as PP
from multi_car_racing_tpu_torch.util import tree_leaves
from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDENS = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))
                 if "rgb_array" not in p)
TOL = 1e-6
COEF_TOL = 4e-6


def golden(name):
    """(config kwargs, the 52 leaves with a leading env axis, frame). The
    frame is 96x96 but for ``rgb_array_skid``'s 600x400 viewport."""
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False)
    meta = json.loads(str(d["meta"]))
    assert meta["vp"] == ([600, 400] if name == "rgb_array_skid" else None)
    assert meta["n_leaves"] == 52
    return meta["cfg"], [d[f"leaf_{i}"][None] for i in range(52)], d["frame"]


def jax_from_leaves(leaves):
    """The JAX EnvState of the leaves, unflattened with the JAX EnvState's
    own tree structure (taken from a JAX EnvState of the same shapes)."""
    template = jax_state(convert.env_state_to_numpy(
        convert.env_state_from_leaves(leaves, device="cpu")))
    treedef = jax.tree_util.tree_structure(template)
    assert treedef.num_leaves == len(leaves)
    return jax.tree_util.tree_unflatten(treedef, [jnp.asarray(x) for x in leaves])


def states(name):
    kw, leaves, frame = golden(name)
    return (EnvConfig(**kw), JC.EnvConfig(**kw),
            convert.env_state_from_leaves(leaves, device="cpu"), jax_from_leaves(leaves))


def close(name, ref, got, tol=TOL):
    ref = np.asarray(ref, np.float64)
    got = got.detach().numpy().astype(np.float64)
    assert ref.shape == got.shape, name
    bad = np.abs(ref - got) > tol * np.maximum(1.0, np.abs(ref))
    assert not bad.any(), (name, float(np.abs(ref - got).max()))


@pytest.mark.parametrize("name", GOLDENS)
def test_geometry_matches_jax(name):
    cfg, jcfg, st, js = states(name)
    zoom, ang, trans = jax.jit(jax.vmap(partial(JG.camera, jcfg)))(js)
    pz, pa, pt = PG.camera(cfg, st)
    close("zoom", zoom, pz)
    close("angle", ang, pa)
    close("trans", trans, pt)
    jp = jax.jit(jax.vmap(lambda s: JG.car_polys_world(s.cars)))(js)
    pp = PG.car_polys_world(st.cars)
    for k in ("wheel_quads", "marker_quads", "hull_polys"):
        close(k, jp[k], pp[k])
    assert np.array_equal(np.asarray(jp["marker_valid"]), pp["marker_valid"].numpy())
    # The marker on a grid of wheel phases, both signs and past 2 pi.
    phase = np.linspace(-7.0, 7.0, 301, dtype=np.float32)
    jv, jok = jax.jit(JG.wheel_marker_local)(jnp.asarray(phase))
    pv, pok = PG.wheel_marker_local(torch.from_numpy(phase))
    close("marker_local", jv, pv)
    assert np.array_equal(np.asarray(jok), pok.numpy())
    jh = jax.jit(jax.vmap(JG.hud_values))(js)
    ph = PG.hud_values(st)
    for k in ("speed", "abs0", "abs1", "abs2", "abs3", "steer", "gyro", "score"):
        close(k, jh[k], ph[k])
    assert np.array_equal(np.asarray(jh["backward"]), ph["backward"].numpy())
    for k in ("HUD_S", "HUD_H", "SCORE_X", "SCORE_Y", "SCORE_DIGIT_W", "SCORE_DIGIT_H",
              "SCORE_SPACING"):
        assert getattr(PG, k) == getattr(JG, k), k
    assert np.array_equal(PG.DIGIT_FONT, JG.DIGIT_FONT)


def _coef_check(label, ref, got, nedges):
    """Active slots' meta columns equal, coefficients within COEF_TOL of the
    slot's coordinate scale (module docstring)."""
    e3 = 3 * nedges
    assert np.array_equal(ref[..., e3:], got[..., e3:]), f"{label}: palette/active/band"
    act = ref[..., e3 + 1] > 0
    assert act.any(), label
    rc = ref[..., :e3].reshape(ref.shape[:-1] + (nedges, 3)).astype(np.float64)[act]
    gc = got[..., :e3].reshape(ref.shape[:-1] + (nedges, 3)).astype(np.float64)[act]
    span = np.abs(rc[..., 0]) + np.abs(rc[..., 1])
    m = np.maximum(1.0, (np.abs(rc[..., 2]) / np.maximum(span, 1e-30)).max(-1))[:, None]
    dc = np.abs(rc[..., :2] - gc[..., :2]).max(-1)
    dk = np.abs(rc[..., 2] - gc[..., 2])
    assert (dc <= COEF_TOL * m).all(), (label, float((dc / m).max()))
    assert (dk <= COEF_TOL * m * m).all(), (label, float((dk / (m * m)).max()))


@pytest.mark.parametrize("name", GOLDENS)
def test_view_inputs_match_jax(name):
    cfg, jcfg, st, js = states(name)
    n = cfg.num_agents
    ref = [np.asarray(x) for x in jax.jit(jax.vmap(
        lambda s: JPR._view_inputs(jcfg, s, n)))(js)]
    got = [x.numpy() for x in PP.view_inputs(cfg, st)]
    cam_r, cam_g = ref[0].reshape(got[0].shape), got[0]
    close("cam", cam_r[..., :5], torch.from_numpy(cam_g[..., :5]))
    assert np.array_equal(cam_r[..., 5:], cam_g[..., 5:]), "warm, active count"
    for label, i, ne in (("quads", 1, 4), ("q4", 2, 4), ("p8", 3, 8)):
        assert ref[i].shape == got[i].shape, label
        _coef_check(label, ref[i], got[i], ne)
    # Active quad slots first, in order; the rest all zero in both.
    nq = cam_g[..., 6].astype(int)
    slot = np.arange(PP.SQ)
    assert np.array_equal(got[1][..., 13] > 0, slot < nq[..., None])
    assert not got[1][slot >= nq[..., None]].any()
    close("rects", ref[4][..., :4], torch.from_numpy(got[4][..., :4]))
    assert np.array_equal(ref[4][..., 4:], got[4][..., 4:]), "rect palettes and bands"
    assert np.array_equal(ref[5], got[5]), "score bits"
    assert got[5].dtype == np.int32


def _f32(x):
    return np.float32(x)


def _per_op_slots(cfg, st, ca, sa):
    """The active edge coefficients of every view's quad, q4 and p8 slots,
    in slot order, computed in numpy float32 one operation at a time from
    the state and the cos and sin (E, N) of the view angles: a list over
    views of three (k, edges, 3) arrays. The world-space car polygons are
    the port's ``car_polys_world`` (held to JAX above)."""
    n = cfg.num_agents
    t = st.t.numpy()
    cars, tr = st.cars, st.track
    scroll = cars.hull_origin.numpy()
    zoom = (_f32(0.1 * JC.SCALE) * np.maximum(_f32(1) - t, _f32(0))
            + _f32(JC.ZOOM * JC.SCALE) * np.minimum(t, _f32(1)))
    polys = {k: v.numpy() for k, v in PG.car_polys_world(cars).items()}
    quad, curb, xy = tr.quad.numpy(), tr.curb_quad.numpy(), tr.xy.numpy()
    valid, has_curb, ntil = tr.valid.numpy(), tr.has_curb.numpy(), tr.n_tiles.numpy()

    def coefs(poly, act):
        b = np.roll(poly, -1, axis=-2)
        c1, c2 = b[..., 1] - poly[..., 1], b[..., 0] - poly[..., 0]
        k0 = c1 * poly[..., 0] - c2 * poly[..., 1]
        area = np.sum(poly[..., 0] * b[..., 1] - poly[..., 1] * b[..., 0], axis=-1)
        sgn = np.where(area < 0, _f32(-1), _f32(1))[..., None, None]
        rows = (_f32(96 - 0.5) - poly[..., 1] * _f32(96 / JC.WINDOW_H))
        cols = poly[..., 0] * _f32(96 / JC.WINDOW_W) - _f32(0.5)
        on = ((rows.max(-1) >= 0) & (rows.min(-1) < 96) & (cols.max(-1) >= 0)
              & (cols.min(-1) < 96))
        return (np.stack([c1, c2, k0], axis=-1) * sgn)[act & on]

    out = []
    for e in range(t.shape[0]):
        z = zoom[e]
        for v in range(n):
            c, s_ = ca[e, v], sa[e, v]
            tx = _f32(JC.WINDOW_W / 2) - z * (c * scroll[e, v, 0] - s_ * scroll[e, v, 1])
            ty = (_f32(JC.WINDOW_H * cfg.h_ratio)
                  - z * (s_ * scroll[e, v, 0] + c * scroll[e, v, 1]))

            def win(p):
                x, y = p[..., 0] * z, p[..., 1] * z
                return np.stack([tx + c * x - s_ * y, ty + s_ * x + c * y], axis=-1)

            # The two tile windows around the view's centre, creation order.
            dx, dy = _f32(JC.WINDOW_W / 2) - tx, _f32(JC.WINDOW_H / 2) - ty
            inv = _f32(1) / z
            cx, cy = (c * dx + s_ * dy) * inv, (-s_ * dx + c * dy) * inv
            d2 = np.where(valid[e], np.square(cx - xy[e, :, 0]) + np.square(cy - xy[e, :, 1]),
                          np.inf)
            i = np.arange(len(d2))
            s1 = np.mod(np.argmin(d2) - JR.W1 // 2, ntil[e])
            in1 = (np.mod(i - s1, ntil[e]) < JR.W1) & valid[e]
            s2 = np.mod(np.argmin(np.where(in1, np.inf, d2)) - JR.W2 // 2, ntil[e])
            src = np.nonzero(in1 | ((np.mod(i - s2, ntil[e]) < JR.W2) & valid[e]))[0]
            road = np.stack([quad[e, src], curb[e, src]], axis=1).reshape(-1, 4, 2)
            road_act = np.stack([valid[e, src], has_curb[e, src]], axis=1).reshape(-1)
            q4 = np.stack([polys["wheel_quads"][e], polys["marker_quads"][e]],
                          axis=2).reshape(-1, 4, 2)
            q4_act = np.stack([np.ones_like(polys["marker_valid"][e]),
                               polys["marker_valid"][e]], axis=-1).reshape(-1)
            p8 = polys["hull_polys"][e].reshape(-1, 8, 2)
            out.append((coefs(win(road), road_act), coefs(win(q4), q4_act),
                        coefs(win(p8), np.ones(len(p8), bool))))
    return out


@pytest.mark.parametrize("name", GOLDENS)
def test_slot_coefficients_match_per_op_reference(name):
    """The loosening of the slot-coefficient bar against JAX is XLA's: the
    port's active coefficients meet 1e-6 * max(1, |x|) against a numpy
    float32 version rounded once per operation."""
    kw, leaves, _ = golden(name)
    cfg = EnvConfig(**kw)
    st = convert.env_state_from_leaves(leaves, device="cpu")
    cam, quads, q4, p8, _, _ = (x.numpy() for x in PP.view_inputs(cfg, st))
    n = cfg.num_agents
    tables = [(quads, 4, slice(None)), (q4, 4, slice(None)), (p8, 8, slice(0, 4 * n))]
    for view, ref in enumerate(_per_op_slots(cfg, st, cam[..., 0], cam[..., 1])):
        e, v = divmod(view, n)
        for (tbl, ne, sl), r in zip(tables, ref):
            rows = tbl[e, v, sl]
            act = rows[:, 3 * ne + 1] > 0
            got = rows[act, :3 * ne].reshape(-1, ne, 3).astype(np.float64)
            assert got.shape == r.shape, (name, view, got.shape, r.shape)
            r = r.astype(np.float64)
            err = np.abs(got - r) / np.maximum(1.0, np.abs(r))
            assert (err <= TOL).all(), (name, view, ne, float(err.max()))


@pytest.mark.parametrize("name", GOLDENS)
def test_env_state_from_leaves_matches_jax_unflatten(name):
    _, leaves, _ = golden(name)
    js = jax_from_leaves(leaves)
    via_jax = convert.env_state_from_numpy(jax.device_get(js), device="cpu")
    got = convert.env_state_from_leaves(leaves, device="cpu")
    a, b = tree_leaves(got), tree_leaves(via_jax)
    assert len(a) == len(b) == 52
    for i, (x, y, raw) in enumerate(zip(a, b, leaves)):
        assert x.dtype == y.dtype and torch.equal(x, y), i
        assert x.is_contiguous() and tuple(x.shape) == raw.shape, i
    with pytest.raises(ValueError):
        convert.env_state_from_leaves(leaves + [leaves[0]], device="cpu")


def test_render_fields_are_read():
    """``backwards_flag``, ``h_ratio`` and ``use_ego_color`` are config fields
    with the JAX defaults, and ``view_inputs`` reads each: the flag slot
    goes, the camera's y translation moves, the hull palettes change."""
    for f in ("backwards_flag", "h_ratio", "use_ego_color"):
        assert getattr(EnvConfig(), f) == getattr(JC.EnvConfig(), f), f
    kw, leaves, _ = golden("egocolor_4agent")
    st = convert.env_state_from_leaves(leaves, device="cpu")
    base = EnvConfig(**{**kw, "use_ego_color": False})
    cam, _, _, p8, _, _ = PP.view_inputs(base, st)
    n = base.num_agents
    assert p8.shape[2] == 4 * n + 1
    assert PP.view_inputs(EnvConfig(**{**kw, "backwards_flag": False}), st)[3].shape[2] == 4 * n
    cam2 = PP.view_inputs(EnvConfig(**{**kw, "h_ratio": 0.5}), st)[0]
    assert torch.equal(cam2[..., :3], cam[..., :3]) and not torch.equal(cam2[..., 3], cam[..., 3])
    ego = PP.view_inputs(EnvConfig(**kw), st)[3]
    pal = ego[..., :4 * n, 24].reshape(1, n, n, 4)[..., 0]
    assert torch.equal(pal[0], torch.where(torch.eye(n, dtype=torch.bool), 9.0, 10.0))
    assert not torch.equal(ego[..., 24], p8[..., 24])
