#!/usr/bin/env python3
"""Hold this checkout's contact kernels against another version's, on one
NVIDIA card.

    python3 compare_parent.py kernels PARENT_DIR
    python3 compare_parent.py variants CSRC_DIR [CSRC_DIR ...]
    python3 compare_parent.py e2e PARENT_DIR

PARENT_DIR is an unpacked checkout of another commit (``git archive``),
usually the parent; CSRC_DIR a copy of ``multi_car_racing_tpu_torch/csrc``
with a change in it.

- ``kernels``: builds the contact kernels K2 (``contact_island.cu``) and K3
  (``solve_island.cu``) from PARENT_DIR's sources beside this checkout's and,
  on each input below, checks that they give the same bytes, that two
  launches of this checkout's give the same bytes, that every far env's cars
  out of K2 are byte-equal to the same cars through K1, and reads K2's near
  count against ``near_flags``; then times both versions in turns (parent,
  this, this, parent; CUDA events over 50 launches).
- ``variants``: the same checks and times for K2 and K3 built from each
  CSRC_DIR, bytes held against the first.
- ``e2e``: runs the N = 2 paths of each checkout's own ``chip_smoke.py`` in
  turns (parent, this, this, parent, parent, this), one process each: three
  100-step windows of the N = 2 main path, the state-PPO rollout, the pixel
  main path and the pixel-PPO env side.

The inputs (E = 4096, N = 2 unless named): chip_smoke.py's phase 6 state;
the N = 2 main path's last; all-far (phase 6's cars, car 1 of every env
moved 500 m); the N = 2 spawn tick; all-near (the spawn tick, car 1 pulled
to 2.7 m of car 0); N = 4 at E = 1024 driven until 10% of envs are near;
the N = 4 rear-end ram (E = 1). Prints one line per input and writes the
whole report to ``multi_car_racing_tpu_torch/_build/compare/compare_<mode>.json``.
Imports nothing of JAX.
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
from multi_car_racing_tpu_torch.physics import fused_world as fw  # noqa: E402
from multi_car_racing_tpu_torch.physics.collide import ContactState  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls  # noqa: E402

REPS = 50
BUILD = os.path.join(ROOT, "multi_car_racing_tpu_torch", "_build", "compare")
VP, CI = ctypes.c_void_p, ctypes.c_int


def build(tag: str, src_dir: str, name: str):
    """csrc/<name>.cu of ``src_dir`` built with this checkout's nvcc flags:
    (the launch function, typed; the ptxas lines)."""
    os.makedirs(BUILD, exist_ok=True)
    out = os.path.join(BUILD, f"{tag}_{name}.so")
    cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", out, os.path.join(src_dir, f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=_cuda.NVCC_TIMEOUT_S)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src_dir}/{name}.cu:\n{proc.stderr}")
    fn = getattr(ctypes.CDLL(out), f"{name}_launch")
    with open(os.path.join(src_dir, f"{name}.cu")) as f:
        # K2 takes the near list and its count from the two-launch design on.
        listed = name == "contact_island" and "near_count" in f.read()
    fn.argtypes = [VP] * (15 if name == "solve_island" or listed else 13) + [CI] * 7 + [VP]
    fn.restype = CI
    return fn, listed, _cuda._ptxas_summary(proc.stderr)


class Version:
    """K2 and K3 of one source directory, launched on packed inputs."""

    def __init__(self, tag: str, src_dir: str):
        with ThreadPoolExecutor(2) as ex:
            k2, k3 = ex.map(lambda n: build(tag, src_dir, n), ("contact_island", "solve_island"))
        self.tag, (self.k2, self.listed, p2), (self.k3, _, p3) = tag, k2, k3
        self.ptxas = {"contact_island": p2, "solve_island": p3}
        self.near_count = None

    def contact(self, fin, ls_in, cst, n):
        dev = fin.device
        envs, mm = fin.shape[1] // n, cst.ids.shape[1]
        fout = torch.empty((fw.OUT_ROWS["N_OUT"], fin.shape[1]), device=dev)
        ls_out = torch.empty((4, fin.shape[1]), dtype=torch.int32, device=dev)
        ni, ti = torch.empty_like(cst.normal_imp), torch.empty_like(cst.tangent_imp)
        ids = torch.empty_like(cst.ids)
        lists = []
        if self.listed:
            self.near_count = torch.empty(1, dtype=torch.int32, device=dev)
            lists = [torch.empty(envs, dtype=torch.int32, device=dev).data_ptr(),
                     self.near_count.data_ptr()]
        ctab, itab = fw._contact_tables(dev, n)
        rc = self.k2(fin.data_ptr(), ls_in.data_ptr(), cst.normal_imp.data_ptr(),
                     cst.tangent_imp.data_ptr(), cst.ids.data_ptr(), fout.data_ptr(),
                     ls_out.data_ptr(), ni.data_ptr(), ti.data_ptr(), ids.data_ptr(),
                     fw._params(dev).data_ptr(), ctab.data_ptr(), itab.data_ptr(), *lists,
                     envs, n, mm, 180, 60, 180, 60, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} contact_island launch failed ({rc})")
        return fout, ls_out, ni, ti, ids

    def solve(self, fin, ls_in, bundle, n):
        dev = fin.device
        envs, mm = fin.shape[1] // n, bundle.man.normal.shape[1]
        fout = torch.empty((fw.N_SOLVE_OUT, fin.shape[1]), device=dev)
        ls_out = torch.empty((4, fin.shape[1]), dtype=torch.int32, device=dev)
        ni = torch.empty((envs, mm, 2), device=dev)
        ti = torch.empty_like(ni)
        m = bundle.man
        ctab, itab = fw._contact_tables(dev, n)
        rc = self.k3(fin.data_ptr(), ls_in.data_ptr(), m.normal.data_ptr(), m.point.data_ptr(),
                     m.separation.data_ptr(), m.point_ok.data_ptr(),
                     bundle.normal_imp.data_ptr(), bundle.tangent_imp.data_ptr(),
                     fout.data_ptr(), ls_out.data_ptr(), ni.data_ptr(), ti.data_ptr(),
                     fw._params(dev).data_ptr(), ctab.data_ptr(), itab.data_ptr(),
                     envs, n, mm, 180, 60, 180, 60, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"{self.tag} solve_island launch failed ({rc})")
        return fout, ls_out, ni, ti


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


def inputs(dev) -> dict:
    """name -> ((pre-solve cars, wheel_on_road, contacts), cars per env)."""
    cfg2 = EnvConfig(num_agents=2, use_random_direction=False)
    in6 = drive_until_near(2, cs.E, dev)
    acts = cs.cycled_actions(cs.E, 2, dev)
    state = penv.reset_batch(cfg2, cs.SEEDS, cs.E)
    for t in range(cs.WARMUP + cs.T):
        state, _, _ = penv.step(cfg2, state, acts[t % 8])
    last = (apply_controls(state.cars, acts[(cs.WARMUP + cs.T) % 8]), state.wheel_on_road,
            state.contacts)
    far = torch.tensor([cs.ALL_FAR_SHIFT, 0.0], device=dev).expand(cs.E, 2)
    sp = cs.spawn_batch(cfg2, cs.E, 2, dev)
    pull = -cs.ALL_NEAR_PULL * (sp.cars.hull_c[:, 1] - sp.cars.hull_c[:, 0])
    _, ram, ram_act, _ = cs.ram_state(dev)
    return {"phase 6": (in6, 2), "main path's last": (last, 2),
            "all-far": ((cs.move_car1(in6[0], far),) + in6[1:], 2),
            "spawn tick": ((sp.cars, sp.wheel_on_road, sp.contacts), 2),
            "all-near": ((cs.move_car1(sp.cars, pull), sp.wheel_on_road, sp.contacts), 2),
            f"N=4, E={cs.N4_E}": (drive_until_near(4, cs.N4_E, dev), 4),
            "ram (N=4, E=1)": ((apply_controls(ram.cars, ram_act), ram.wheel_on_road,
                                ram.contacts), 4)}


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def differing(a, b) -> list:
    """Per output: elements that differ and the largest difference."""
    return [(int((x != y).sum()), float((x.double() - y.double()).abs().max()))
            for x, y in zip(a, b)]


def compare_versions(versions: list, dev) -> dict:
    """The checks and times of ``kernels`` / ``variants``; bytes against
    versions[0], times in turns."""
    res = {}
    for name, ((cars, road, cst), n) in inputs(dev).items():
        fin, ls_in = fw.pack_inputs(cars, road)
        cst = ContactState(cst.normal_imp.contiguous(), cst.tangent_imp.contiguous(),
                           cst.ids.contiguous())
        post, force, motor, bundle = cs.solve_inputs(cars, road, cst, n)[:4]
        fin3, ls3 = fw.pack_solve_inputs(post, force, motor)
        near = fw.near_flags(cars)
        reps = REPS if fin.shape[1] > 64 else 5
        ref2, ref3 = versions[0].contact(fin, ls_in, cst, n), versions[0].solve(fin3, ls3,
                                                                              bundle, n)
        k1, k1_ls = fw.launch(fin, ls_in, fin.shape[1])
        far = (~near)[:, None].expand(-1, n).reshape(-1)
        r = {"near_share": float(near.float().mean()), "near_envs": int(near.sum())}
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
            if v.listed:
                out["near_count"] = int(v.near_count)
                out["far_equal_k1"] = (torch.equal(a2[0][:, far], k1[:, far])
                                       and torch.equal(a2[1][:, far], k1_ls[:, far]))
            r[v.tag] = out
        for order in (versions, versions[::-1]):
            for v in order:
                r[v.tag].setdefault("k2_ms", []).append(
                    cs.cuda_ms(lambda: v.contact(fin, ls_in, cst, n), reps))
                r[v.tag].setdefault("k3_ms", []).append(
                    cs.cuda_ms(lambda: v.solve(fin3, ls3, bundle, n), reps))
        r["k1_ms_same_cars"] = cs.cuda_ms(lambda: fw.launch(fin, ls_in, fin.shape[1]), reps)
        print(f"{name}: {json.dumps(r)}", flush=True)
        res[name] = r
    return res


E2E = """
import json, subprocess, sys
sys.path.insert(0, ".")
import torch
import chip_smoke as cs
from multi_car_racing_tpu_torch import EnvConfig, env as penv
dev = torch.device("cuda")
smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip()
cfg = EnvConfig(num_agents=2, use_random_direction=False)
acts = cs.cycled_actions(cs.E, 2, dev)
out = {"n2_step_ms": [cs.main_path(cfg, acts, "N=2", smi)["step_ms"] for _ in range(3)]}
out["rollout_env_steps_per_s"] = cs.rollout_phase(smi, dev)["env_steps_per_s"]
out["pixel_step_ms"] = cs.pixel_main_path(smi, dev)["step_ms"]
pool = penv.make_track_pool(EnvConfig(num_agents=2), cs.POOL_SEEDS, device=dev)
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
        versions = [Version(tag, src) for tag, src in srcs]
        for v in versions:
            print(f"{v.tag} ptxas: " + json.dumps(v.ptxas), flush=True)
        report["ptxas"] = {v.tag: v.ptxas for v in versions}
        report["inputs"] = compare_versions(versions, dev)
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, f"compare_{mode}.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(f"done in {time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
