#!/usr/bin/env python3
"""Hold this checkout's kernels against another version's, on one NVIDIA card.

    python3 compare_parent.py kernels PARENT_DIR
    python3 compare_parent.py variants CSRC_DIR [CSRC_DIR ...]
    python3 compare_parent.py e2e PARENT_DIR

PARENT_DIR is an unpacked checkout of the parent commit (``git archive``),
whose kernels are launched with the parent's arguments (``PARENT_ARGTYPES``);
CSRC_DIR a copy of this checkout's ``multi_car_racing_tpu_torch/csrc`` with
a change in it.

- ``kernels``: builds K1 (``joints_island.cu``), K2 (``contact_island.cu``),
  K3 (``solve_island.cu``) and K4/K5 (``track_pass.cu``) from PARENT_DIR's
  sources beside this checkout's, one nvcc each, started together, then
  - K1, on phase 3's input (N = 1 after 20 driven steps) and on the
    all-far cars: the same bytes as the parent's, two launches identical;
    its time, and its time with 0/0 and 180/0 velocity/position iterations
    (the tire model, warm start and integration; the velocity loop), and the
    share of 32-car warps whose cars differ in a joint's limit state;
  - K2 and K3, on the inputs below: the same bytes as the parent's,
    two launches identical, every far env's cars out of K2 byte-equal to
    the same cars through K1, K2's near count against ``near_flags``, and
    K3's live count and list against ``solve_live_envs`` (a version whose
    K3 takes the list: 17 pointers);
  - K3 without a bundle (every car a dead car) at N = 1 on phase 3's cars
    and at N = 2 on phase 6's: the same bytes, two launches identical;
  - K4/K5, at N = 1 and N = 2 on chip_smoke.py's phase-14 inputs and the
    main path's last, and on the N = 2 spawn tick's first 1024 and 256
    envs: each version against the plain track pass under the
    track bars (masks, counts, nearest_beta equal; bonus within 2e-5), its
    bytes against the parent's (reported), two launches identical, the
    candidates per car of ``track_engine.track_candidates``;
  and times every kernel in turns (parent, this, this, parent), K4/K5 also
  with a 128 MiB read before each launch (``chip_smoke.cold_graph_ms``),
  so that its tables come from memory as on the main path. It also
  checks, in one launch, that sincosf gives sinf's and cosf's bits on every
  finite float with |x| <= 2^10 (car_chain.cuh takes one sincosf for the
  hull angle's pair).
- ``variants``: the same checks and times for the kernels built from each
  CSRC_DIR, bytes held against the first.
- ``e2e``: runs the N = 1 and N = 2 paths of each checkout's own
  ``chip_smoke.py`` in turns (parent, this, this, parent, parent, this),
  one process each: three 100-step windows of the N = 1 and of the N = 2
  main path, the state-PPO rollout, the pixel main path and the pixel-PPO
  env side.

``kernels`` and ``variants`` end with a line ``FAILED [...]`` naming every
check that did not hold (an empty list when all held), and exit 1 if any
did.

The K2/K3 inputs (E = 4096, N = 2 unless named): chip_smoke.py's phase 6
state; the N = 2 main path's last; all-far (phase 6's cars, car 1 of every
env moved 500 m); the N = 2 spawn tick; all-near (the spawn tick, car 1
pulled to 2.7 m of car 0); N = 4 at E = 1024 driven until 10% of envs are
near; the N = 4 rear-end ram (E = 1); N = 6, 8, 10, 12 and 32 at E = 64
driven until a quarter of the envs are near and a car-car contact happened
(chip_smoke.wide_states; at N = 8 a warp carries 40 bodies, more than its
lanes; from N = 10 on a warp's arrays sit in the global scratch; N = 32 is
the most cars of one car a lane). Kernel times are device time per launch: 50 launches captured in
a CUDA graph (chip_smoke.graph_ms). Prints
one line per input and writes the whole report to
``multi_car_racing_tpu_torch/_build/compare/compare_<mode>.json``. Imports
nothing of JAX.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from multi_car_racing_tpu_torch import EnvConfig, _cuda, env as penv  # noqa: E402
from multi_car_racing_tpu_torch.physics import fused_world as fw, tire  # noqa: E402
from multi_car_racing_tpu_torch.physics import track_engine as te  # noqa: E402
from multi_car_racing_tpu_torch.physics.collide import ContactState  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls  # noqa: E402
from multi_car_racing_tpu_torch.util import tree_map  # noqa: E402

REPS = 50
SCALE_ENVS = (1024, 256)
BUILD = os.path.join(ROOT, "multi_car_racing_tpu_torch", "_build", "compare")
KERNELS = ("joints_island", "contact_island", "solve_island", "track_pass")
VP, CI, CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


# Each launch function's arguments, in this checkout and in its parent
# (19e86c4, the same: K2 and K3 take a scratch buffer, pointer and slots,
# before the stream). Only these two are kept: a comparison with an older
# commit needs that commit's compare_parent.py.
ARGTYPES = {
    "joints_island": [VP] * 5 + [CI] * 3 + [VP],
    "contact_island": [VP] * 15 + [CI] * 7 + [VP, CI, VP],
    "solve_island": [VP] * 17 + [CI] * 7 + [VP, CI, VP],
    "track_pass": [VP] * 20 + [CI] * 3 + [CF] * 6 + [VP],
}
PARENT_ARGTYPES = dict(ARGTYPES)


def build(tag: str, src_dir: str, name: str, argtypes: dict):
    """csrc/<name>.cu of ``src_dir`` built with this checkout's nvcc flags:
    (the launch function, typed by ``argtypes``; the ptxas lines)."""
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, f"{tag}_{name}.so")
    src = os.path.join(src_dir, f"{name}.cu")
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", out, src]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_cuda.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(out), f"{name}_launch")
    fn.argtypes, fn.restype = argtypes[name], CI
    return fn, _cuda._ptxas_summary(proc.stderr)


class Version:
    """K1, K2, K3 and K4/K5 of one source directory, launched on packed
    inputs; ``parent`` for the parent's launch arguments."""

    def __init__(self, tag: str, src_dir: str, parent: bool = False):
        types = PARENT_ARGTYPES if parent else ARGTYPES
        with ThreadPoolExecutor(len(KERNELS)) as ex:
            built = dict(zip(KERNELS, ex.map(lambda n: build(tag, src_dir, n, types), KERNELS)))
        self.tag = tag
        self.k1, self.k2, self.k3, self.k45 = (built[n][0] for n in KERNELS)
        self.ptxas = {n: b[1] for n, b in built.items()}
        self.lists = len(types["solve_island"]) >= 25     # K3 takes the live-env list
        self.takes_scratch = len(types["contact_island"]) == 25
        self.near_count = self.near_list = self.live_count = self.live_list = None

    def scratch(self, n: int, envs: int, dev) -> list:
        """K2's and K3's scratch arguments at ``n`` cars: none for a version
        that takes none; none (the shared layout) while a warp's arrays fit a
        block's shared memory (N <= 9 on an H100); else a slot of
        ``fw.warp_floats(n)`` floats per env (up to N = 32 both versions'
        layout)."""
        if not self.takes_scratch:
            return []
        floats = fw.warp_floats(n)
        if 4 * floats <= torch.cuda.get_device_properties(dev).shared_memory_per_block_optin:
            return [0, 0]
        self.slots = torch.empty(envs * floats, device=dev)     # kept alive past the launch
        return [self.slots.data_ptr(), envs]

    def joints(self, fin, ls_in, vel: int = 180, pos: int = 60):
        fout = torch.empty((fw.OUT_ROWS["N_OUT"], fin.shape[1]), device=fin.device)
        ls_out = torch.empty((4, fin.shape[1]), dtype=torch.int32, device=fin.device)
        rc = self.k1(fin.data_ptr(), ls_in.data_ptr(), fout.data_ptr(), ls_out.data_ptr(),
                     fw._params(fin.device).data_ptr(), fin.shape[1], vel, pos,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} joints_island launch failed ({rc})")
        return fout, ls_out

    def contact(self, fin, ls_in, cst, n):
        dev = fin.device
        envs, mm = fin.shape[1] // n, cst.ids.shape[1]
        fout = torch.empty((fw.OUT_ROWS["N_OUT"], fin.shape[1]), device=dev)
        ls_out = torch.empty((4, fin.shape[1]), dtype=torch.int32, device=dev)
        ni, ti = torch.empty_like(cst.normal_imp), torch.empty_like(cst.tangent_imp)
        ids = torch.empty_like(cst.ids)
        self.near_count = torch.empty(1, dtype=torch.int32, device=dev)
        self.near_list = torch.empty(envs, dtype=torch.int32, device=dev)
        ctab, itab = fw._contact_tables(dev, n)
        rc = self.k2(fin.data_ptr(), ls_in.data_ptr(), cst.normal_imp.data_ptr(),
                     cst.tangent_imp.data_ptr(), cst.ids.data_ptr(), fout.data_ptr(),
                     ls_out.data_ptr(), ni.data_ptr(), ti.data_ptr(), ids.data_ptr(),
                     fw._params(dev).data_ptr(), ctab.data_ptr(), itab.data_ptr(),
                     self.near_list.data_ptr(), self.near_count.data_ptr(),
                     envs, n, mm, 180, 60, 180, 60, *self.scratch(n, envs, dev),
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} contact_island launch failed ({rc})")
        return fout, ls_out, ni, ti, ids

    def solve(self, fin, ls_in, bundle, n):
        """K3 on packed rows and a bundle (or None): (fout, ls_out) and, with a
        bundle, the impulses."""
        dev = fin.device
        envs = fin.shape[1] // n
        fout = torch.empty((fw.N_SOLVE_OUT, fin.shape[1]), device=dev)
        ls_out = torch.empty((4, fin.shape[1]), dtype=torch.int32, device=dev)
        if bundle is None:
            mm, ni = 0, None
            rows, out_imp, tabs = [0] * 6, [0, 0], [0, 0]
        else:
            m = bundle.man
            mm = m.normal.shape[1]
            ni = torch.empty((envs, mm, 2), device=dev)
            ti = torch.empty_like(ni)
            rows = [t.data_ptr() for t in (m.normal, m.point, m.separation, m.point_ok,
                                           bundle.normal_imp, bundle.tangent_imp)]
            out_imp = [ni.data_ptr(), ti.data_ptr()]
            tabs = [t.data_ptr() for t in fw._contact_tables(dev, n)]
        lists = []
        if self.lists:
            self.live_list = torch.empty(envs, dtype=torch.int32, device=dev)
            self.live_count = torch.empty(1, dtype=torch.int32, device=dev)
            lists = [self.live_list.data_ptr(), self.live_count.data_ptr()]
        scratch = (self.scratch(n, envs, dev) if mm
                   else [0, 0] if self.takes_scratch else [])    # no bundle: no scratch
        rc = self.k3(fin.data_ptr(), ls_in.data_ptr(), *rows, fout.data_ptr(),
                     ls_out.data_ptr(), *out_imp, fw._params(dev).data_ptr(), *tabs, *lists,
                     envs, n, mm, 180, 60, 180, 60, *scratch,
                     torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} solve_island launch failed ({rc})")
        return (fout, ls_out) if ni is None else (fout, ls_out, ni, ti)

    def track(self, track, wheels, origins, visited, touched):
        E, N, MT = visited.shape
        dev = visited.device
        out = [torch.empty((E, N, 4), dtype=torch.bool, device=dev),
               torch.empty((E, N, MT), dtype=torch.bool, device=dev),
               torch.empty((E, N), device=dev),
               torch.empty((E, N), dtype=torch.int32, device=dev),
               torch.empty((E, MT), dtype=torch.bool, device=dev),
               torch.empty((E, N), device=dev),
               torch.empty((E, N), dtype=torch.bool, device=dev)]
        ptrs = [x.data_ptr() for x in (
            track.quad_T, track.quad_ax_T, track.quad_lo, track.quad_hi, track.curb_quad_T,
            track.xy, track.beta, track.valid, track.n_tiles, wheels, origins, visited,
            touched, *out)]
        rc = self.k45(*ptrs, E, N, MT, te.overlap.WHEEL_HX, te.overlap.WHEEL_HY,
                      te.C.SENSOR_OVERLAP_MARGIN, te.REACH_BASE, te.WHEEL_CULL_EXTRA,
                      te.ORIGIN_CULL_EXTRA, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} track_pass launch failed ({rc})")
        return out


def drive_until_near(n: int, envs: int, dev):
    """chip_smoke.py phase 6's drive: until NEAR_SHARE of envs are near."""
    cfg = EnvConfig(num_agents=n, use_random_direction=False)
    acts = cs.cycled_actions(envs, n, dev)
    state = penv.reset_batch(cfg, cs.SEEDS, envs)
    for t in range(cs.NEAR_MAX_STEPS + 1):
        pre = apply_controls(state.cars, acts[t % 8])
        share = float(fw.near_flags(pre).float().mean())
        if t == cs.NEAR_MAX_STEPS or (t >= 10 and share >= cs.NEAR_SHARE):
            break
        state, _, _ = penv.step(cfg, state, acts[t % 8])
    return pre, state.wheel_on_road, state.contacts


def main_path_last(n: int, dev):
    """The state after the N = n main path's reset and WARMUP + T steps, and
    the next step's pre-solve cars."""
    cfg = EnvConfig(num_agents=n, use_random_direction=False)
    acts = cs.cycled_actions(cs.E, n, dev)
    state = penv.reset_batch(cfg, cs.SEEDS, cs.E)
    for t in range(cs.WARMUP + cs.T):
        state, _, _ = penv.step(cfg, state, acts[t % 8])
    return state, apply_controls(state.cars, acts[(cs.WARMUP + cs.T) % 8])


def inputs(dev) -> dict:
    """name -> ((pre-solve cars, wheel_on_road, contacts), cars per env)."""
    cfg2 = EnvConfig(num_agents=2, use_random_direction=False)
    in6 = drive_until_near(2, cs.E, dev)
    state, pre = main_path_last(2, dev)
    far = torch.tensor([cs.ALL_FAR_SHIFT, 0.0], device=dev).expand(cs.E, 2)
    sp = cs.spawn_batch(cfg2, cs.E, 2, dev)
    pull = -cs.ALL_NEAR_PULL * (sp.cars.hull_c[:, 1] - sp.cars.hull_c[:, 0])
    _, ram, ram_act, _ = cs.ram_state(dev)
    return {"phase 6": (in6, 2), "main path's last": ((pre, state.wheel_on_road, state.contacts), 2),
            "all-far": ((cs.move_car1(in6[0], far),) + in6[1:], 2),
            "spawn tick": ((sp.cars, sp.wheel_on_road, sp.contacts), 2),
            "all-near": ((cs.move_car1(sp.cars, pull), sp.wheel_on_road, sp.contacts), 2),
            f"N=4, E={cs.N4_E}": (drive_until_near(4, cs.N4_E, dev), 4),
            "ram (N=4, E=1)": ((apply_controls(ram.cars, ram_act), ram.wheel_on_road,
                                ram.contacts), 4),
            **{f"N={n}, E={cs.WIDE_E}": ((lambda st: (st.cars, st.wheel_on_road, st.contacts))(
                cs.wide_states(n, cs.WIDE_E, dev)[2]), n)
               for n in cs.NARROW_NS + cs.WIDE_NS + (fw.LANE_CARS,)}}


def k1_inputs(dev, contact_inputs: dict) -> dict:
    """name -> (pre-solve cars, wheel_on_road): phase 3's (N = 1, 20 driven
    steps, the next action) and the all-far cars."""
    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    acts = cs.cycled_actions(cs.E, 1, dev)
    state = penv.reset_batch(cfg, cs.SEEDS, cs.E)
    for t in range(20):
        state, _, _ = penv.step(cfg, state, acts[t % 8])
    return {"phase 3": (apply_controls(state.cars, acts[20 % 8]), state.wheel_on_road),
            "all-far cars": contact_inputs["all-far"][0][:2]}


def track_inputs(dev) -> dict:
    """name -> the track pass's arguments: chip_smoke.py's phase-14 inputs
    and the main path's last, at N = 1 and N = 2; and the N = 2 spawn tick's
    first SCALE_ENVS envs (the time of one warp's chain against E = 4096's)."""
    out = {}
    for n in (1, 2):
        cfg = EnvConfig(num_agents=n, use_random_direction=False)
        out.update(cs.track_inputs(cfg, cs.cycled_actions(cs.E, n, dev)))
        state, pre = main_path_last(n, dev)
        post, _, _ = fw.island_step(pre, state.wheel_on_road, state.contacts)
        out[f"N={n}, the main path's last"] = (state.track, pre, post.hull_origin,
                                               state.visited, state.tile_touched, n)
    spawn = out["N=2, a spawn tick"]
    for envs in SCALE_ENVS:
        out[f"N=2, a spawn tick, E={envs}"] = tuple(
            tree_map(lambda x: x[:envs].contiguous(), a) if i < 2 else
            a[:envs].contiguous() if i < 5 else a for i, a in enumerate(spawn))
    return out


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def differing(a, b) -> list:
    """Per output: elements that differ and the largest difference."""
    return [(int((x != y).sum()), float((x.double() - y.double()).abs().max()))
            for x, y in zip(a, b)]


def mixed_warps(ls) -> list:
    """Per joint: the share of 32-car warps whose cars differ in limit state."""
    w = ls[:, :ls.shape[1] // 32 * 32].reshape(4, -1, 32)
    return [float((w[k] != w[k][:, :1]).any(1).float().mean()) for k in range(4)]


def in_turns(versions, res: dict, key: str, fn, timer=cs.graph_ms) -> None:
    """Times fn(version) with ``timer`` for each version, in turns (first to
    last, then last to first), appended under res[tag][key]."""
    for order in (versions, versions[::-1]):
        for v in order:
            res[v.tag].setdefault(key, []).append(timer(lambda: fn(v), REPS))


def compare_k1(versions: list, k1_in: dict) -> dict:
    res = {}
    for name, (cars, road) in k1_in.items():
        fin, ls_in = fw.pack_inputs(cars, road)
        ref = versions[0].joints(fin, ls_in)
        r = {"cars": fin.shape[1], "mixed_warp_share_per_joint": mixed_warps(ref[1]),
             "limit_share_per_joint": [float((ref[1][k] != 0).float().mean())
                                       for k in range(4)]}
        for v in versions:
            a, b = v.joints(fin, ls_in), v.joints(fin, ls_in)
            torch.cuda.synchronize()
            r[v.tag] = {"equal": same(ref, a), "two_launches_identical": same(a, b)}
            if not r[v.tag]["equal"]:
                r[v.tag]["differing"] = differing(ref, a)
        in_turns(versions, r, "ms", lambda v: v.joints(fin, ls_in))
        in_turns(versions, r, "ms_0_0", lambda v: v.joints(fin, ls_in, 0, 0))
        in_turns(versions, r, "ms_180_0", lambda v: v.joints(fin, ls_in, 180, 0))
        print(f"K1 {name}: {json.dumps(r)}", flush=True)
        res[name] = r
    return res


def compare_contact(versions: list, dev, contact_inputs: dict) -> dict:
    res = {}
    for name, ((cars, road, cst), n) in contact_inputs.items():
        fin, ls_in = fw.pack_inputs(cars, road)
        cst = ContactState(cst.normal_imp.contiguous(), cst.tangent_imp.contiguous(),
                           cst.ids.contiguous())
        post, force, motor, bundle = cs.solve_inputs(cars, road, cst, n)[:4]
        fin3, ls3 = fw.pack_solve_inputs(post, force, motor)
        near = fw.near_flags(cars)
        ref2, ref3 = versions[0].contact(fin, ls_in, cst, n), versions[0].solve(fin3, ls3,
                                                                              bundle, n)
        k1, k1_ls = fw.launch(fin, ls_in, fin.shape[1])
        far = (~near)[:, None].expand(-1, n).reshape(-1)
        live = fw.solve_live_envs(bundle, near.shape[0])
        r = {"near_share": float(near.float().mean()), "near_envs": int(near.sum()),
             "live_envs": int(live.sum())}
        for v in versions:
            a2, b2 = v.contact(fin, ls_in, cst, n), v.contact(fin, ls_in, cst, n)
            a3, b3 = v.solve(fin3, ls3, bundle, n), v.solve(fin3, ls3, bundle, n)
            torch.cuda.synchronize()
            out = {"k2_equal": same(ref2, a2), "k3_equal": same(ref3, a3),
                   "k2_two_launches_identical": same(a2, b2),
                   "k3_two_launches_identical": same(a3, b3)}
            if not out["k2_equal"]:
                out["k2_differing"] = differing(ref2, a2)
            if not out["k3_equal"]:
                out["k3_differing"] = differing(ref3, a3)
            out["near_count"] = int(v.near_count)
            out["near_count_equal"] = out["near_count"] == r["near_envs"]
            out["far_equal_k1"] = (torch.equal(a2[0][:, far], k1[:, far])
                                   and torch.equal(a2[1][:, far], k1_ls[:, far]))
            out.update(live_list_check(v, live))
            r[v.tag] = out
        in_turns(versions, r, "k2_ms", lambda v: v.contact(fin, ls_in, cst, n))
        in_turns(versions, r, "k3_ms", lambda v: v.solve(fin3, ls3, bundle, n))
        print(f"{name}: {json.dumps(r)}", flush=True)
        res[name] = r
    return res


def live_list_check(v, live: torch.Tensor) -> dict:
    """A version's K3 live count and list (of its last launch) against the
    plain predicate: the count equals live's sum, the listed envs are the
    live ones. Empty for a K3 that takes no list."""
    if not v.lists:
        return {}
    count = int(v.live_count)
    listed = torch.sort(v.live_list[:count].long()).values
    return {"k3_live_count": count, "k3_live_count_equal": count == int(live.sum()),
            "k3_listed_are_live": torch.equal(listed, live.nonzero().flatten().to(listed))}


def compare_solve_alone(versions: list, dev, contact_inputs: dict, k1_in: dict) -> dict:
    """K3 with no bundle (every env dead: the joints-only chains): at N = 1
    on phase 3's cars and at N = 2 on phase 6's."""
    res = {}
    cases = {"N=1, no bundle": (k1_in["phase 3"], 1),
             "N=2, no bundle": (contact_inputs["phase 6"][0][:2], 2)}
    for name, ((cars, road), n) in cases.items():
        post, force, motor, _ = tire.tire_step(cars, road)
        fin3, ls3 = fw.pack_solve_inputs(post, force, motor)
        ref = versions[0].solve(fin3, ls3, None, n)
        live = fw.solve_live_envs(None, fin3.shape[1] // n)
        r = {"envs": fin3.shape[1] // n, "live_envs": 0}
        for v in versions:
            a, b = v.solve(fin3, ls3, None, n), v.solve(fin3, ls3, None, n)
            torch.cuda.synchronize()
            out = {"k3_equal": same(ref, a), "k3_two_launches_identical": same(a, b)}
            if not out["k3_equal"]:
                out["k3_differing"] = differing(ref, a)
            out.update(live_list_check(v, live))
            r[v.tag] = out
        in_turns(versions, r, "k3_ms", lambda v: v.solve(fin3, ls3, None, n))
        print(f"K3 {name}: {json.dumps(r)}", flush=True)
        res[name] = r
    return res


def failed_checks(report: dict) -> list:
    """Every check of a report that did not hold: each check flag (a name
    ending in equal, identical, _live, _k1 or within_bars) that is False,
    and each non-empty list of K4/K5 outputs whose bytes differ."""
    bad = []

    def walk(x, path):
        if isinstance(x, dict):
            for k, val in x.items():
                walk(val, path + [k])
        elif ((x is False and path[-1].endswith(("equal", "identical", "_live", "_k1",
                                                 "within_bars")))
              or (path[-1] == "bytes_differ_from_first" and x)):
            bad.append("/".join(path))

    for part in ("k1", "inputs", "solve_alone", "track"):
        walk(report.get(part, {}), [part])
    if report.get("sincos_mismatches"):
        bad.append("sincos")
    return bad


def compare_track(versions: list, dev) -> dict:
    res = {}
    for name, args in track_inputs(dev).items():
        wheels, origins = te.pack_cars(args[1], args[2])
        plain = te.track_pass_plain(*args)
        per_car = te.track_candidates(*args[:3]).sum(-1)
        run = (args[0], wheels, origins, args[3], args[4])
        ref = versions[0].track(*run)
        r = {"cand_mean": float(per_car.float().mean()), "cand_max": int(per_car.max())}
        for v in versions:
            a, b = v.track(*run), v.track(*run)
            torch.cuda.synchronize()
            out = {"unequal_to_plain": [nm for nm, x, y in zip(te.OUTPUT_NAMES, a, plain)
                                        if nm != "bonus" and not torch.equal(x, y)],
                   "bonus_err": float((a[2] - plain[2]).abs().max()),
                   "bytes_differ_from_first": [nm for nm, x, y in zip(te.OUTPUT_NAMES, a, ref)
                                               if not torch.equal(x, y)],
                   "two_launches_identical": same(a, b)}
            out["within_bars"] = (not out["unequal_to_plain"]
                                  and out["bonus_err"] <= cs.BONUS_TOL)
            r[v.tag] = out
        in_turns(versions, r, "ms", lambda v: v.track(*run))
        in_turns(versions, r, "ms_after_l2_flush", lambda v: v.track(*run),
                 lambda fn, reps: cs.cold_graph_ms(fn, reps)[0])
        print(f"K4/K5 {name}: {json.dumps(r)}", flush=True)
        res[name] = r
    return res


# sincosf against sinf and cosf, bit for bit, on every finite float with
# |x| <= 2^10 (both signs; 2,298,478,594 values), in one launch. The asm move
# hides x from the compiler so that sinf(x) and cosf(x) keep their own range
# reductions, as car_chain.cuh's parent evaluated them.
SINCOS_CU = r"""
#include <cuda_runtime.h>
__global__ void sincos_kernel(unsigned long long* bad, unsigned long long half) {
  const unsigned long long step = 1ull * gridDim.x * blockDim.x;
  for (unsigned long long i = 1ull * blockIdx.x * blockDim.x + threadIdx.x; i < 2 * half;
       i += step) {
    const unsigned b = static_cast<unsigned>(i % half) | (i >= half ? 0x80000000u : 0u);
    const float x = __uint_as_float(b);
    float y;
    asm volatile("mov.b32 %0, %1;" : "=f"(y) : "f"(x));
    float s, c;
    sincosf(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(sinf(x)) ||
        __float_as_uint(c) != __float_as_uint(cosf(y)))
      atomicAdd(bad, 1ull);
  }
}
extern "C" int sincos_check(unsigned long long* bad, void* stream) {
  const unsigned long long half = 0x44800000ull + 1;   // +0 ... 2^10, by bit pattern
  sincos_kernel<<<132 * 16, 256, 0, static_cast<cudaStream_t>(stream)>>>(bad, half);
  return static_cast<int>(cudaGetLastError());
}
"""


def sincos_check(dev) -> int:
    """The floats with |x| <= 2^10 on which sincosf differs from sinf or
    cosf in any bit (0 where car_chain.cuh may use it)."""
    os.makedirs(BUILD, exist_ok=True)
    src, out = os.path.join(BUILD, "sincos_check.cu"), os.path.join(BUILD, "sincos_check.so")
    with open(src, "w") as f:
        f.write(SINCOS_CU)
    proc = subprocess.run([_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, timeout=_cuda.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on the sincos check:\n{proc.stderr}")
    fn = ctypes.CDLL(out).sincos_check
    fn.argtypes, fn.restype = [VP, VP], CI
    bad = torch.zeros(1, dtype=torch.int64, device=dev)
    if fn(bad.data_ptr(), torch.cuda.current_stream().cuda_stream):
        raise RuntimeError("sincos check launch failed")
    mismatches = int(bad)
    print(f"sincosf vs sinf/cosf on every finite float with |x| <= 2^10: {mismatches} "
          f"mismatches", flush=True)
    return mismatches


E2E = """
import json, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from multi_car_racing_tpu_torch import EnvConfig, env as penv
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
out = {}
for n in (1, 2):
    cfg = EnvConfig(num_agents=n, use_random_direction=False)
    acts = cs.cycled_actions(cs.E, n, dev)
    out[f"n{n}_step_ms"] = [cs.main_path(cfg, acts, f"N={n}", smi)["step_ms"] for _ in range(3)]
out["rollout_env_steps_per_s"] = cs.rollout_phase(smi, dev)["env_steps_per_s"]
out["pixel_step_ms"] = cs.pixel_main_path(smi, dev)["step_ms"]
pool = penv.make_host_track_pool(EnvConfig(num_agents=2), cs.POOL_SEEDS, device=dev)
out["pixel_ppo_env_steps_per_s"] = cs.pixel_rollout_phase(smi, dev, pool)["env_steps_per_s"]
print("E2E " + json.dumps(out), flush=True)
"""


def end_to_end(parent_dir: str) -> list:
    runs = []
    for tag in ("parent", "this", "this", "parent", "parent", "this"):
        cwd = ROOT if tag == "this" else parent_dir
        proc = subprocess.run([sys.executable, "-c", E2E], cwd=cwd, capture_output=True,
                              text=True, timeout=900)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("E2E ")]
        if proc.returncode or not lines:
            raise RuntimeError(f"{tag} run failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
        runs.append({"tree": tag, **json.loads(lines[-1][4:])})
        print(json.dumps(runs[-1]), flush=True)
    return runs


def main() -> int:
    if len(sys.argv) < 3 or sys.argv[1] not in ("kernels", "variants", "e2e"):
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("compare_parent: no CUDA device", file=sys.stderr)
        return 2
    mode, dirs = sys.argv[1], [os.path.abspath(d) for d in sys.argv[2:]]
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60, check=True).stdout.strip()
    print(f"card: {smi}", flush=True)
    t0 = time.perf_counter()
    report = {"mode": mode, "card": smi, "dirs": sys.argv[2:]}
    if mode == "e2e":
        report["runs"] = end_to_end(dirs[0])
    else:
        if mode == "kernels":
            srcs = [("parent", os.path.join(dirs[0], "multi_car_racing_tpu_torch", "csrc")),
                    ("this", os.path.join(ROOT, "multi_car_racing_tpu_torch", "csrc"))]
        else:
            srcs = [(os.path.basename(d.rstrip("/")) or d, d) for d in dirs]
        versions = [Version(tag, src, parent=tag == "parent") for tag, src in srcs]
        for v in versions:
            print(f"{v.tag} ptxas: " + json.dumps(v.ptxas), flush=True)
        report["ptxas"] = {v.tag: v.ptxas for v in versions}
        report["sincos_mismatches"] = sincos_check(dev)
        contact_inputs = inputs(dev)
        k1_in = k1_inputs(dev, contact_inputs)
        report["k1"] = compare_k1(versions, k1_in)
        report["inputs"] = compare_contact(versions, dev, contact_inputs)
        report["solve_alone"] = compare_solve_alone(versions, dev, contact_inputs, k1_in)
        report["track"] = compare_track(versions, dev)
        report["failed"] = failed_checks(report)
        print(f"FAILED {json.dumps(report['failed'])}", flush=True)
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, f"compare_{mode}.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 1 if report.get("failed") else 0


if __name__ == "__main__":
    sys.exit(main())
