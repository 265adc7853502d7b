"""The pixel painter's per-patch cull (csrc/paint_view.cu, K6) in its plain
PyTorch form, ``render.pixels.paint_candidates``, on the CPU.

K6 bins every slot and world quad of a view against each 16 x 16 patch,
narrows a patch's candidates to each of its 8 x 8 cells, and runs the exact
per-pixel test only on a cell's candidates; ``paint_candidates`` is the same
predicate with the same squares, boxes, margin and arithmetic.

- Soundness: every slot or warm world quad that the plain painter's
  per-pixel test (``_paint_slot`` / ``_world_quad`` arithmetic, one rounding
  per operation) covers at some pixel of a cell is a candidate of that
  cell -- on the five golden states and on small synthetic ones: N = 2 at
  the spawn tick, at t = 0.25 / 0.5 / 0.75 s (warm, mid zoom) and steady,
  with the cameras jittered by sub-pixel amounts from a numpy seed; N = 4 with
  ego colour; a view driving backwards (the flag).
- Selectivity: on the spawn tick, mean road candidates per cell under
  WARM_SHARE of the view's painted world quads; on the steady state, under
  STEADY_SHARE of its active road slots (measured here at the spawn poses:
  0.011-0.014 and 0.034-0.040). A cull that culls nothing fails.
"""

import glob
import json
import os

import numpy as np
import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, convert, env as penv
from multi_car_racing_tpu_torch.render import pixels as PP
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "fixtures", "golden")
GOLDENS = sorted(os.path.basename(p)[:-4] for p in glob.glob(os.path.join(GOLDEN_DIR, "*.npz"))
                 if "rgb_array" not in p)
WARM_SHARE = 0.05
STEADY_SHARE = 0.10
QUAD_CHUNK = 64          # world quads per coverage pass (bounds memory)
JITTER_SHIFT, JITTER_TURN = 0.3, 0.01   # world units, rad: about half a pixel each


def _per_cell(cov):
    """(V, S, H, W) bool -> (V, cells, S): covered at some pixel of the cell,
    in ``cell_origins``' order."""
    V, S = cov.shape[:2]
    k = PP.CELL
    grid = cov.view(V, S, PP.H // k, k, PP.W // k, k).any(5).any(3).reshape(V, S, -1)
    _, (cr, cc) = PP.cell_origins()
    return grid[:, :, (cr // k) * (PP.W // k) + cc // k].transpose(1, 2)


def _slot_cover(slots, nedges, wx, wy, row):
    """Sign-folded slots (V, S, 3 nedges + 4) -> per-pixel coverage
    (V, S, H, W), as ``pixels._paint_slot`` decides it."""
    e3 = 3 * nedges
    s = slots[..., None, None]
    cov = (s[:, :, e3 + 1] > 0) & (row >= s[:, :, e3 + 2])
    for e in range(nedges):
        c1, c2, k0 = s[:, :, 3 * e], s[:, :, 3 * e + 1], s[:, :, 3 * e + 2]
        cov = cov & (c2 * wy - c1 * wx + k0 >= 0.0)
    return cov


def _world_cover(q, gx, gy):
    """World quads (V, S, 4, 2) of either winding -> coverage (V, S, H, W),
    as ``pixels._world_quad`` decides it."""
    pos = neg = None
    for v in range(4):
        ax, ay = q[:, :, v, 0, None, None], q[:, :, v, 1, None, None]
        bx, by = q[:, :, (v + 1) % 4, 0, None, None], q[:, :, (v + 1) % 4, 1, None, None]
        c1 = by - ay
        c2 = bx - ax
        k0 = c1 * ax - c2 * ay
        cr = c2 * gy[:, None] - c1 * gx[:, None] + k0
        pos = cr >= 0.0 if pos is None else pos & (cr >= 0.0)
        neg = cr <= 0.0 if neg is None else neg & (cr <= 0.0)
    return pos | neg


def coverage(args, n):
    """The plain painter's per-patch coverage, in ``paint_candidates``'
    layout: (road, cars, flag)."""
    cam, quads, q4, p8 = (x.reshape((-1,) + x.shape[2:]) for x in args[:4])
    quad, curb_quad, _, _, valid, has_curb = args[6:]
    V, mt = cam.shape[0], quad.shape[1]
    wx, wy, row = PP._pixel_centres(cam.device)
    _, gx, gy = PP._background(cam, wx, wy)
    warm = cam[:, 5] > 0.0

    steady = _per_cell(_slot_cover(quads, 4, wx, wy, row))
    steady &= (torch.arange(PP.SQ) < cam[:, 6, None])[:, None] & ~warm[:, None, None]
    env = torch.arange(V) // n
    both = torch.stack([quad[env], curb_quad[env]], dim=2).reshape(V, 2 * mt, 4, 2)
    painted = torch.stack([valid[env], has_curb[env]], dim=2).reshape(V, 1, 2 * mt)
    world = torch.cat([_per_cell(_world_cover(both[:, i:i + QUAD_CHUNK], gx, gy))
                       for i in range(0, 2 * mt, QUAD_CHUNK)], dim=-1)
    road = torch.zeros((V, PP.CELLS, max(PP.SQ, 2 * mt)), dtype=torch.bool)
    road[..., :PP.SQ] |= steady
    road[..., :2 * mt] |= world & painted & warm[:, None, None]

    c4 = _per_cell(_slot_cover(q4, 4, wx, wy, row))
    c8 = _per_cell(_slot_cover(p8, 8, wx, wy, row))
    cars = torch.cat([c4.reshape(V, PP.CELLS, n, 8),
                      c8[..., :4 * n].reshape(V, PP.CELLS, n, 4)], dim=-1)
    flag = c8[..., 4 * n] if p8.shape[1] > 4 * n else torch.zeros_like(c8[..., 0])
    return road, cars.reshape(V, PP.CELLS, 12 * n), flag


def jitter(state, seed):
    """The cameras moved by sub-pixel amounts at the steady zoom, from a numpy
    seed: each car shifted by up to JITTER_SHIFT world units (half a pixel at
    the steady zoom), its heading and its velocity turned by up to
    JITTER_TURN rad (half a pixel at the window's edge; the view follows the
    velocity above 0.5 m/s, else the heading)."""
    rng = np.random.RandomState(seed)
    cars = state.cars
    dev = cars.hull_c.device
    shift = torch.as_tensor(rng.uniform(-JITTER_SHIFT, JITTER_SHIFT, cars.hull_c.shape),
                            dtype=torch.float32, device=dev)
    turn = torch.as_tensor(rng.uniform(-JITTER_TURN, JITTER_TURN, cars.hull_a.shape),
                           dtype=torch.float32, device=dev)
    c, s = torch.cos(turn), torch.sin(turn)
    vx, vy = cars.hull_v[..., 0], cars.hull_v[..., 1]
    return state.replace(cars=cars.replace(
        hull_c=cars.hull_c + shift, hull_a=cars.hull_a + turn,
        hull_v=torch.stack([c * vx - s * vy, s * vx + c * vy], dim=-1),
        wheel_c=cars.wheel_c + shift[:, :, None]))


def golden_case(name):
    d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False)
    cfg = EnvConfig(**json.loads(str(d["meta"]))["cfg"])
    return cfg, convert.env_state_from_leaves([d[f"leaf_{i}"][None] for i in range(52)],
                                              device="cpu")


_SPAWN = {}


def spawn(num_agents, **kw):
    key = (num_agents, tuple(sorted(kw.items())))
    if key not in _SPAWN:
        cfg = EnvConfig(num_agents=num_agents, **kw)
        _SPAWN[key] = cfg, penv.reset_batch(cfg, range(2), 2, device="cpu")
    return _SPAWN[key]


def synthetic_case(name):
    if name == "n4_ego":
        cfg, st = spawn(4, use_ego_color=True)
        return cfg, jitter(st.replace(t=torch.full_like(st.t, 2.0)), 4)
    cfg, st = spawn(2)
    if name == "backward":
        st = st.replace(t=torch.full_like(st.t, 2.0),
                        driving_backward=torch.tensor([[True, False], [False, True]]))
        return cfg, jitter(st, 5)
    t = {"spawn": None, "t0.25": 0.25, "t0.5": 0.5, "t0.75": 0.75, "steady": 2.0}[name]
    if t is not None:
        st = st.replace(t=torch.full_like(st.t, t))
    return cfg, jitter(st, 7) if name != "spawn" else st


SYNTHETIC = ("spawn", "t0.25", "t0.5", "t0.75", "steady", "n4_ego", "backward")


@pytest.mark.parametrize("case", [f"golden:{g}" for g in GOLDENS] + list(SYNTHETIC))
def test_cull_is_sound(case):
    kind, _, name = case.rpartition(":")
    cfg, st = golden_case(name) if kind == "golden" else synthetic_case(name)
    args = PP.paint_inputs(cfg, st)
    cand = PP.paint_candidates(*args)
    cov = coverage(args, cfg.num_agents)
    for label, c, k in zip(("road", "cars", "flag"), cand, cov):
        assert c.shape == k.shape, label
        missed = k & ~c
        assert not missed.any(), (label, missed.nonzero()[:8].tolist())
    assert cov[0].any(), "no road covered: the case tests nothing"
    # At the spawn tick's zoom (0.1 of the steady one) a car covers no pixel centre.
    assert cov[1].any() or name == "spawn", "no car covered"
    if name == "backward":
        assert cov[2].any() and cand[2].any()


@pytest.mark.parametrize("name", ["spawn", "steady"])
def test_cull_is_selective(name):
    cfg, st = synthetic_case(name)
    args = PP.paint_inputs(cfg, st)
    road, _, _ = PP.paint_candidates(*args)
    cam = args[0].reshape(-1, 8)
    warm = cam[:, 5] > 0
    per_patch = road.sum(-1).double().mean(-1)                       # (V,)
    if name == "spawn":
        assert bool(warm.all())
        n = cfg.num_agents
        quads = (args[10].sum(-1) + args[11].sum(-1)).repeat_interleave(n).double()
        share = per_patch / quads
        bar = WARM_SHARE
    else:
        assert not bool(warm.any())
        share = per_patch / cam[:, 6].double()
        bar = STEADY_SHARE
    assert float(share.max()) < bar, share.tolist()
    assert float(share.min()) > 0.0, share.tolist()
