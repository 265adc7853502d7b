#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card and check them.

    python3 chip_smoke.py

The main path is the batched env step of ``multi_car_racing_tpu_torch``,
driven twice through the env's entry points: ``env.reset_batch`` (16
host-generated tracks tiled to E = 4096 envs, spawn tick included), then
``env.step`` with 8 cycled random actions,

- at CarRacing-v0 (one car per env), where each step's fused physics stage
  runs in the hand-written CUDA kernel ``csrc/joints_island.cu`` (K1);
- at MultiCarRacing-v0 with two cars per env, where it runs in
  ``csrc/contact_island.cu`` (K2: K1's chain plus the car-car Collide pass
  and contact solve, one warp per env branching on its broadphase flag).

Both kernels are built with nvcc at first use from the sources in the
checkout, one nvcc per kernel, started together.

Phases (each prints a line as it starts; any failure exits nonzero). The
bars: every CarState field within 5e-4 * max(1, max|plain|) (the value bar)
and within 5e-4 * max(1e-3, max|plain - pre|) (the step bar: the step's own
change, so a millimetre-sized error in the position solve shows on
coordinates of hundreds of metres), limit states equal.
  1. device: the card's name and power limit; no CUDA device -> exit 2
  2. build: both kernels' build times and ptxas register/spill lines
  3. K1 vs plain: one island step through K1 and through its plain PyTorch
     version on the same card tensors at N = 1, E = 4096, after 20 driven
     steps; both bars; skid flags differing bounded
  4. small input: 4 envs stepped 10 times on the card and on the CPU (plain
     path) at N = 1: rewards within 2e-5, hull positions within 1e-3 m
  5. N = 1 main path: reset + 10 warm-up + 100 timed steps at E = 4096; all
     state finite; K1's launch count equals the resets plus steps and K2's
     is 0; env-steps/s, K1's time and bound, stage times by CUDA events
  6. K2 vs plain at N = 2, E = 4096, on a state driven until a share of envs
     is broadphase-near: CarState fields and impulses within both bars,
     manifold ids differing bounded; fails if no env has a live contact
  7. a rear-end ram at N = 4 driven by the port: K2 vs plain at the first
     step whose normal impulse exceeds 0.1; both bars, ids equal
  8. determinism: two K2 launches on phase 6's input are bit-identical
  9. N = 2 main path: as phase 5 with K2 (K1's count 0)
 10. the kernels JSON line, the nvidia-smi line, and the result line

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multi_car_racing_tpu_torch import EnvConfig, _cuda  # noqa: E402
from multi_car_racing_tpu_torch import env as penv, seeding  # noqa: E402
from multi_car_racing_tpu_torch.physics import fused_world  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls  # noqa: E402
from multi_car_racing_tpu_torch.util import tree_leaves  # noqa: E402

E = 4096
SEEDS = tuple(range(16))
WARMUP = 10
T = 100
KERNEL_TIMING_LAUNCHES = 50
TOL = 5e-4                     # tests/test_pallas_world.py's kernel-vs-XLA bar
STEP_FLOOR = 1e-3              # floor of the per-step-change scale
SMALL_SEEDS = (0, 1, 2, 3)
SMALL_STEPS = 10
# NVIDIA H100 SXM data sheet: fp32 outside the tensor cores, HBM3 rate.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
CAR_FIELDS = ("hull_c", "hull_a", "hull_v", "hull_w", "wheel_c", "wheel_a",
              "wheel_v", "wheel_w", "joint_impulse", "motor_impulse", "spin",
              "phase", "fuel_spent")
# Both kernels replace variants of one TPU kernel function: K1 its
# force_no_contacts=True build, K2 its full-contact build (pallas_call :1623
# through _call_packed :1591).
TPU_KERNEL = "multi_car_racing_tpu/physics/pallas_world.py:975"
NEAR_SHARE = 0.10              # drive phase 6 until this share of envs is near
NEAR_MAX_STEPS = 120
RAM_STEPS = (100, 160)         # phase 7 looks for the contact in this window


def phase(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def cycled_actions(num_envs: int, n_agents: int, device) -> torch.Tensor:
    """bench.py's 8 cycled random actions: (8, E, N, 3)."""
    rng = np.random.RandomState(0)
    a = np.stack([
        np.stack([rng.uniform([-1, 0, 0], [1, 1, 0.2], size=(n_agents, 3))
                  for _ in range(num_envs)])
        for _ in range(8)
    ])
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def compare_fields(kern: dict, plain: dict, pre: dict, label: str) -> dict:
    """Per field: max |kernel - plain| and that deviation over each of its
    two bars, TOL * max(1, max|plain|) on the value and
    TOL * max(STEP_FLOOR, max|plain - pre|) on the step's change. Prints
    them all, then raises if any field is past a bar."""
    devs = {}
    for f, a in kern.items():
        b, p = plain[f], pre[f]
        d = float((a - b).abs().max())
        value_bar = TOL * max(1.0, float(b.abs().max()))
        step_bar = TOL * max(STEP_FLOOR, float((b - p).abs().max()))
        devs[f] = (d, d / value_bar, d / step_bar)
    phase(f"{label}: max |kernel - plain| per field (value-bar share, step-bar share): "
          + ", ".join(f"{f}={d:.3g} ({rv:.3g}, {rs:.3g})"
                      for f, (d, rv, rs) in devs.items()))
    bad = [f for f, (_, rv, rs) in devs.items() if not (rv <= 1.0 and rs <= 1.0)]
    if bad:
        raise AssertionError(f"{label}: {bad} past the bar")
    return devs


def car_fields(cars) -> dict:
    return {f: getattr(cars, f) for f in CAR_FIELDS}


def compare_cars(kern, plain, pre, label: str = "K1 vs plain") -> dict:
    devs = compare_fields(car_fields(kern), car_fields(plain), car_fields(pre), label)
    if not torch.equal(kern.limit_state, plain.limit_state):
        raise AssertionError(f"{label}: limit_state differs")
    return devs


def compare_contact_step(k_out, p_out, pre, cs_pre, label: str) -> tuple[dict, int, int]:
    """K2 against the plain version on one island step: every CarState field
    and both impulses within both bars, limit states equal. Returns (the
    deviations, envs whose manifold ids differ, skid flags that differ)."""
    (k_cars, k_skid, k_cs), (p_cars, p_skid, p_cs) = k_out, p_out
    devs = compare_cars(k_cars, p_cars, pre, label)
    devs.update(compare_fields(
        {"normal_imp": k_cs.normal_imp, "tangent_imp": k_cs.tangent_imp},
        {"normal_imp": p_cs.normal_imp, "tangent_imp": p_cs.tangent_imp},
        {"normal_imp": cs_pre.normal_imp, "tangent_imp": cs_pre.tangent_imp}, label))
    id_miss = int((k_cs.ids != p_cs.ids).any(dim=1).sum())
    skid_miss = int((k_skid != p_skid).sum())
    return devs, id_miss, skid_miss


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def island_kernel(cfg, fin, ls_in, contacts):
    """The island kernel of ``cfg`` on packed inputs: K1 or K2."""
    if cfg.num_agents == 1:
        return fused_world.launch(fin, ls_in, fin.shape[1])
    return fused_world.launch_contacts(fin, ls_in, contacts, cfg.num_agents)


def stage_times(cfg, state, action) -> dict:
    """CUDA-event time of each stage of one env step, on the same inputs."""
    pre = apply_controls(state.cars, action)
    new_cars, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    out = penv._track_stage(state.track, pre, new_cars.hull_origin, state.visited,
                            state.tile_touched, cfg.num_agents)
    gain = out[2]
    mid = state.replace(cars=new_cars)
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    fout, ls_out = island_kernel(cfg, fin, ls_in, state.contacts)[:2]
    return {
        "controls": cuda_ms(lambda: apply_controls(state.cars, action), 20),
        "island pack": cuda_ms(lambda: fused_world.pack_inputs(pre, state.wheel_on_road), 20),
        "island kernel": cuda_ms(lambda: island_kernel(cfg, fin, ls_in, state.contacts), 20),
        "island unpack": cuda_ms(lambda: fused_world.unpack_outputs(pre, fout, ls_out), 20),
        "track stage": cuda_ms(lambda: penv._track_stage(
            state.track, pre, new_cars.hull_origin, state.visited, state.tile_touched,
            cfg.num_agents), 20),
        "post-step": cuda_ms(lambda: penv._post_step(mid, cfg, gain, out[5], out[6]), 20),
    }


def assert_finite(state) -> None:
    for x in tree_leaves(state):
        if x.is_floating_point() and not bool(torch.isfinite(x).all()):
            raise AssertionError("non-finite value in the env state")


def main_path(cfg, actions, label: str, smi: str) -> dict:
    """Reset + WARMUP + T timed steps at E envs through the env's entry
    points, with both island kernels' launch counts set to 0 just before
    and read just after. Checks the state is finite, and that this car
    count's kernel launched once per reset and per step and the other never."""
    counter, other = (("launches", "contact_launches") if cfg.num_agents == 1
                      else ("contact_launches", "launches"))
    fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
    t0 = time.perf_counter()
    state = penv.reset_batch(cfg, SEEDS, E)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    for t in range(WARMUP):
        state, r, done = penv.step(cfg, state, actions[t % 8])
    float(r.sum())                                  # host read ends the warm-up
    torch.cuda.synchronize()
    ret = torch.zeros_like(r)
    t0 = time.perf_counter()
    for t in range(T):
        state, r, done = penv.step(cfg, state, actions[(WARMUP + t) % 8])
        ret = ret + r
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = getattr(fused_world.island_step, counter)
    if getattr(fused_world.island_step, other):
        raise AssertionError(f"{label}: the other island kernel was launched")
    assert_finite(state)
    if tuple(ret.shape) != (E, cfg.num_agents) or not bool(torch.isfinite(ret).all()):
        raise AssertionError("returns have the wrong shape or are not finite")
    if launches != 1 + WARMUP + T:
        raise AssertionError(f"{label} island kernel launched {launches} times, expected "
                             f"{1 + WARMUP + T} (1 reset + {WARMUP + T} steps)")
    step_ms = 1e3 * elapsed / T
    phase(f"{label}: reset {reset_s:.3f} s; {T} steps in {elapsed:.4f} s = {step_ms:.4f} "
          f"ms/step, {E * T / elapsed:.1f} env-steps/s on {smi}; mean return "
          f"{float(ret.mean()):.4f}; done {int(done.sum())}/{E}; launches {launches}")
    return {"state": state, "launches": launches, "step_ms": step_ms}


def kernel_times(cfg, run: dict, actions) -> dict:
    """Kernel, plain-version and per-stage times on the main path's last
    inputs, and the kernel's bound from the work this input needs."""
    state, step_ms = run["state"], run["step_ms"]
    n = cfg.num_agents
    action = actions[(WARMUP + T) % 8]
    pre = apply_controls(state.cars, action)
    lagged = state.wheel_on_road
    fin, ls_in = fused_world.pack_inputs(pre, lagged)
    kernel_ms = cuda_ms(lambda: island_kernel(cfg, fin, ls_in, state.contacts),
                        KERNEL_TIMING_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = fused_world.island_step_plain(pre, lagged, state.contacts)[0]
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_cars = E * n
    n_limit = int((p_out.limit_state != 0).sum())
    if n == 1:
        flops = fused_world.island_flops(n_cars, n_limit)
        nbytes = fused_world.island_bytes(n_cars)
        work = f"{n_limit} joints at a limit"
    else:
        counts = fused_world.contact_island_work(pre)
        flops = fused_world.contact_island_flops(n_cars, n_limit, n, **counts)
        nbytes = fused_world.contact_island_bytes(n_cars, n)
        work = f"{n_limit} joints at a limit, " + ", ".join(
            f"{k[2:].replace('_', ' ')} {v}" for k, v in counts.items())
    flop_ms = 1e3 * flops / PEAK_FP32_FLOPS
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, byte_ms)
    phase(f"island kernel {kernel_ms:.5f} ms/launch ({kernel_ms / step_ms:.1%} of a step), "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({flops} fp32 ops, "
          f"{nbytes} bytes, {work})")
    stages = stage_times(cfg, state, action)
    phase("step stages (ms, CUDA events, 20 reps each): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of {step_ms:.4f} ms/step")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}


def ram_state(device):
    """The rear-end ram of tests/test_pallas_world.py driven by the port: 4
    cars, seed 11, global stream 5, the second-row car at full gas. Steps
    until the state's contact carry holds a normal impulse over 0.1."""
    n = 4
    cfg = EnvConfig(num_agents=n)
    state, _ = penv.host_reset(cfg, seed=11, global_stream=seeding.GlobalStream(5),
                               device=device)
    gs = seeding.GlobalStream(5)
    gs.direction()
    order = list(gs.car_order(n))
    act = torch.zeros((1, n, 3), device=device)
    act[0, order.index(2)] = torch.tensor([0.0, 1.0, 0.0])
    for t in range(RAM_STEPS[1]):
        state, _, _ = penv.step(cfg, state, act)
        if t + 1 >= RAM_STEPS[0] and float(state.contacts.normal_imp.abs().max()) > 0.1:
            return cfg, state, act, t + 1
    raise AssertionError(f"no ram contact within {RAM_STEPS[1]} steps")


def report(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
           max_err_over_bar: float, times: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err,
            "max_err_over_bar": max_err_over_bar, **times, "library_ms": None, **extra}


def main() -> int:
    phase("1/10 device")
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs the port on the card only",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    phase(f"device {kind} | nvidia-smi: {smi} | torch {torch.__version__} "
          f"cuda {torch.version.cuda} | python {sys.version.split()[0]}")

    phase("2/10 build (one nvcc per kernel, started together)")
    t0 = time.perf_counter()
    kernels = (fused_world.KERNEL, fused_world.CONTACT_KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_cuda.load, kernels))
    for name in kernels:
        fused_world._library(name)
        info = _cuda.build_info[name]
        phase(f"built {name} in {info['seconds']:.2f} s: " + " | ".join(info["ptxas"]))
    phase(f"both kernels loaded {time.perf_counter() - t0:.2f} s after the builds started")

    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    actions = cycled_actions(E, cfg.num_agents, dev)

    phase(f"3/10 K1 vs plain at E={E} after 20 steps")
    state = penv.reset_batch(cfg, SEEDS, E)
    for t in range(20):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    pre = apply_controls(state.cars, actions[20 % 8])
    k_cars, k_skid, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    p_cars, p_skid, _ = fused_world.island_step_plain(pre, state.wheel_on_road, state.contacts)
    torch.cuda.synchronize()
    devs = compare_cars(k_cars, p_cars, pre)
    # max_abs_err covers the physics state; the fuel accumulator (~1e4, where
    # one float32 ulp is ~1e-3) is reported on its own.
    max_abs_err = max(d for f, (d, _, _) in devs.items() if f != "fuel_spent")
    max_err_over_bar = max(max(rv, rs) for _, rv, rs in devs.values())
    skid_miss = int((k_skid != p_skid).sum())
    phase(f"skid flags differing: {skid_miss}")
    if skid_miss > E // 1000:       # a threshold flag; 1-ulp force noise may flip it
        raise AssertionError(f"kernel vs plain: {skid_miss} skid flags differ")

    phase(f"4/10 small input: {len(SMALL_SEEDS)} envs x {SMALL_STEPS} steps, card vs CPU")
    small = {d: penv.reset_batch(cfg, SMALL_SEEDS, len(SMALL_SEEDS), device=d)
             for d in ("cuda", "cpu")}
    returns = {d: 0.0 for d in small}
    for t in range(SMALL_STEPS):
        for d in small:
            small[d], r, _ = penv.step(cfg, small[d], actions[t % 8, :len(SMALL_SEEDS)].to(d))
            returns[d] = returns[d] + r.double().cpu()
    ret_dev = float((returns["cuda"] - returns["cpu"]).abs().max())
    pos_dev = float((small["cuda"].cars.hull_c.cpu() - small["cpu"].cars.hull_c).abs().max())
    phase(f"returns {returns['cuda'].flatten().tolist()}; |card - cpu| return "
          f"{ret_dev:.3g}, hull position {pos_dev:.3g} m")
    if not (ret_dev <= 2e-5 and pos_dev <= 1e-3):
        raise AssertionError("small-input run on the card disagrees with the CPU path")

    phase(f"5/10 N=1 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run1 = main_path(cfg, actions, "N=1", smi)
    times1 = kernel_times(cfg, run1, actions)
    k1 = report(fused_world.KERNEL, "multi_car_racing_tpu_torch/csrc/joints_island.cu",
                TPU_KERNEL, run1["launches"], max_abs_err, max_err_over_bar, times1,
                variant="force_no_contacts=True", fuel_spent_abs_err=devs["fuel_spent"][0])

    cfg2 = EnvConfig(num_agents=2, use_random_direction=False)
    actions2 = cycled_actions(E, cfg2.num_agents, dev)
    phase(f"6/10 K2 vs plain at N=2, E={E}, driven until {NEAR_SHARE:.0%} of envs are near")
    state = penv.reset_batch(cfg2, SEEDS, E)
    for t in range(NEAR_MAX_STEPS + 1):
        pre = apply_controls(state.cars, actions2[t % 8])
        near = fused_world.near_flags(pre)
        if t == NEAR_MAX_STEPS or (t >= 10 and float(near.float().mean()) >= NEAR_SHARE):
            break
        state, _, _ = penv.step(cfg2, state, actions2[t % 8])
    cs_pre = state.contacts
    k_out = fused_world.island_step(pre, state.wheel_on_road, cs_pre)
    p_out = fused_world.island_step_plain(pre, state.wheel_on_road, cs_pre)
    torch.cuda.synchronize()
    live_envs = int(p_out[2].normal_imp.gt(0).any(-1).any(-1).sum())
    k_live_envs = int(k_out[2].normal_imp.gt(0).any(-1).any(-1).sum())
    phase(f"after {t} steps: near {float(near.float().mean()):.4f} of envs "
          f"({int(near.sum())}); envs with a live contact point: plain {live_envs}, "
          f"K2 {k_live_envs}")
    devs2, id_miss, skid_miss = compare_contact_step(k_out, p_out, pre, cs_pre,
                                                     "K2 vs plain (N=2)")
    phase(f"envs whose manifold ids differ: {id_miss}; skid flags differing: {skid_miss}")
    if id_miss > E // 1000 or skid_miss > E // 1000:
        raise AssertionError(f"K2 vs plain: {id_miss} envs' ids, {skid_miss} skid flags differ")
    if k_live_envs == 0:
        raise AssertionError("K2 vs plain: no env with a live contact point")

    phase("7/10 rear-end ram (N=4, E=1): K2 vs plain at the first step with contact")
    ram_cfg, ram, ram_act, ram_t = ram_state(dev)
    ram_pre = apply_controls(ram.cars, ram_act)
    k_ram = fused_world.island_step(ram_pre, ram.wheel_on_road, ram.contacts)
    p_ram = fused_world.island_step_plain(ram_pre, ram.wheel_on_road, ram.contacts)
    torch.cuda.synchronize()
    ram_imp = float(k_ram[2].normal_imp.abs().max())
    phase(f"ram contact after {ram_t} steps: K2 max|normal_imp| {ram_imp:.4f}, plain "
          f"{float(p_ram[2].normal_imp.abs().max()):.4f}")
    if not ram_imp > 0.1:
        raise AssertionError("ram: K2 produced no normal impulse over 0.1")
    devs_ram, ram_id_miss, _ = compare_contact_step(k_ram, p_ram, ram_pre, ram.contacts,
                                                    "K2 vs plain (ram, N=4)")
    if ram_id_miss:
        raise AssertionError("ram: K2's manifold ids differ from the plain version's")

    phase("8/10 determinism: two K2 launches on phase 6's input")
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    b = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    same = all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
        (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
    phase(f"bit-identical: {same}")
    if not same:
        raise AssertionError("two K2 launches on the same input differ")

    phase(f"9/10 N=2 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run2 = main_path(cfg2, actions2, "N=2", smi)
    times2 = kernel_times(cfg2, run2, actions2)
    all2 = {**devs2, **{f"ram {f}": v for f, v in devs_ram.items()}}
    k2 = report(fused_world.CONTACT_KERNEL,
                "multi_car_racing_tpu_torch/csrc/contact_island.cu", TPU_KERNEL,
                run2["launches"],
                max(d for f, (d, _, _) in all2.items() if not f.endswith("fuel_spent")),
                max(max(rv, rs) for _, rv, rs in all2.values()), times2,
                variant="full contact", near_share=float(near.float().mean()),
                live_envs=k_live_envs,
                id_miss_envs=id_miss, ram_max_normal_imp=ram_imp)

    phase("10/10 report")
    print(json.dumps({"kernels": [k1, k2]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
