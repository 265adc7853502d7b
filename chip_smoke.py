#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py

The main path is the batched env step of ``multi_car_racing_tpu_torch`` at
CarRacing-v0 (one car per env): ``env.reset_batch`` (16 host-generated
tracks tiled to E = 4096 envs, spawn tick included), then ``env.step`` with
8 cycled random actions. Each step's fused physics stage runs in the
hand-written CUDA kernel ``csrc/joints_island.cu``, built with nvcc at first
use from the sources in the checkout.

Phases (each prints a line as it starts; any failure exits nonzero):
  1. device: the card's name and power limit; no CUDA device -> exit 2
  2. build: the kernel's build time and ptxas register/spill line
  3. kernel vs plain: one island step through the kernel and through its
     plain PyTorch version on the same card tensors, after 20 driven steps;
     every CarState field within 5e-4 * max(1, max|plain|) and within
     5e-4 * max(1e-3, max|plain - pre|) (the step's own change, so a
     millimetre-sized error in the position solve shows on coordinates of
     hundreds of metres), limit states equal
  4. small input: 4 envs stepped 10 times on the card and on the CPU (plain
     path): rewards within 2e-5, hull positions within 1e-3 m
  5. main path: reset + 10 warm-up steps + 100 timed steps at E = 4096; all
     state finite; the kernel's launch count equals the resets plus steps
  6. the kernels JSON line, the nvidia-smi line, and the result line

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multi_car_racing_tpu_torch import EnvConfig, _cuda  # noqa: E402
from multi_car_racing_tpu_torch import env as penv  # noqa: E402
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
TPU_KERNEL = "multi_car_racing_tpu/physics/pallas_world.py:975"


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


def compare_cars(kern, plain, pre) -> dict:
    """Per CarState field: max |kernel - plain| and that deviation over each
    of its two bars, TOL * max(1, max|plain|) on the value and
    TOL * max(STEP_FLOOR, max|plain - pre|) on the step's change. Prints
    them all, then raises if any field is past a bar."""
    devs = {}
    for f in CAR_FIELDS:
        a, b, p = getattr(kern, f), getattr(plain, f), getattr(pre, f)
        d = float((a - b).abs().max())
        value_bar = TOL * max(1.0, float(b.abs().max()))
        step_bar = TOL * max(STEP_FLOOR, float((b - p).abs().max()))
        devs[f] = (d, d / value_bar, d / step_bar)
    phase("max |kernel - plain| per field (value-bar share, step-bar share): "
          + ", ".join(f"{f}={d:.3g} ({rv:.3g}, {rs:.3g})"
                      for f, (d, rv, rs) in devs.items()))
    bad = [f for f, (_, rv, rs) in devs.items() if not (rv <= 1.0 and rs <= 1.0)]
    if bad:
        raise AssertionError(f"kernel vs plain: {bad} past the bar")
    if not torch.equal(kern.limit_state, plain.limit_state):
        raise AssertionError("kernel vs plain: limit_state differs")
    return devs


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


def stage_times(cfg, state, action) -> dict:
    """CUDA-event time of each stage of one env step, on the same inputs."""
    pre = apply_controls(state.cars, action)
    new_cars, _ = fused_world.island_step(pre, state.wheel_on_road)
    out = penv._track_stage(state.track, pre, new_cars.hull_origin, state.visited,
                            state.tile_touched, cfg.num_agents)
    gain = out[2]
    mid = state.replace(cars=new_cars)
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    fout, ls_out = fused_world.launch(fin, ls_in, fin.shape[1])
    return {
        "controls": cuda_ms(lambda: apply_controls(state.cars, action), 20),
        "island pack": cuda_ms(lambda: fused_world.pack_inputs(pre, state.wheel_on_road), 20),
        "island kernel": cuda_ms(lambda: fused_world.launch(fin, ls_in, fin.shape[1]), 20),
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


def main() -> int:
    phase("1/6 device")
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

    phase("2/6 build")
    t0 = time.perf_counter()
    fused_world._library()
    info = _cuda.build_info[fused_world.KERNEL]
    phase(f"built {fused_world.KERNEL} in {info['seconds']:.2f} s "
          f"(load {time.perf_counter() - t0:.2f} s): " + " | ".join(info["ptxas"]))

    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    actions = cycled_actions(E, cfg.num_agents, dev)

    phase(f"3/6 kernel vs plain at E={E} after 20 steps")
    state = penv.reset_batch(cfg, SEEDS, E)
    for t in range(20):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    pre = apply_controls(state.cars, actions[20 % 8])
    k_cars, k_skid = fused_world.island_step(pre, state.wheel_on_road)
    p_cars, p_skid = fused_world.island_step_plain(pre, state.wheel_on_road)
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

    phase(f"4/6 small input: {len(SMALL_SEEDS)} envs x {SMALL_STEPS} steps, card vs CPU")
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

    phase(f"5/6 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} warm-up + {T} steps")
    fused_world.island_step.launches = 0
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
    launches = fused_world.island_step.launches
    assert_finite(state)
    if tuple(ret.shape) != (E, cfg.num_agents) or not bool(torch.isfinite(ret).all()):
        raise AssertionError("returns have the wrong shape or are not finite")
    if launches != 1 + WARMUP + T:
        raise AssertionError(f"island kernel launched {launches} times, expected "
                             f"{1 + WARMUP + T} (1 reset + {WARMUP + T} steps)")
    steps_per_s = E * T / elapsed
    step_ms = 1e3 * elapsed / T
    phase(f"reset {reset_s:.3f} s; {T} steps in {elapsed:.4f} s = {step_ms:.4f} ms/step, "
          f"{steps_per_s:.1f} env-steps/s on {smi}; mean return "
          f"{float(ret.mean()):.4f}; done {int(done.sum())}/{E}; launches {launches}")

    # Kernel, plain-version and per-stage times on this run's last inputs.
    action = actions[(WARMUP + T) % 8]
    pre = apply_controls(state.cars, action)
    lagged = state.wheel_on_road
    fin, ls_in = fused_world.pack_inputs(pre, lagged)
    n_cars = E * cfg.num_agents
    kernel_ms = cuda_ms(lambda: fused_world.launch(fin, ls_in, n_cars),
                        KERNEL_TIMING_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out, _ = fused_world.island_step_plain(pre, lagged)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_limit = int((p_out.limit_state != 0).sum())
    flops = fused_world.island_flops(n_cars, n_limit)
    nbytes = fused_world.island_bytes(n_cars)
    flop_ms = 1e3 * flops / PEAK_FP32_FLOPS
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    bound_ms = max(flop_ms, byte_ms)
    phase(f"island kernel {kernel_ms:.5f} ms/launch ({kernel_ms / step_ms:.1%} of a step), "
          f"plain {plain_ms:.3f} ms; bound {bound_ms:.5f} ms ({flops} fp32 ops, "
          f"{nbytes} bytes, {n_limit} joints at a limit)")
    stages = stage_times(cfg, state, action)
    phase("step stages (ms, CUDA events, 20 reps each): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of {step_ms:.4f} ms/step")

    phase("6/6 report")
    print(json.dumps({"kernels": [{
        "name": fused_world.KERNEL,
        "route": "cuda",
        "source": "multi_car_racing_tpu_torch/csrc/joints_island.cu",
        "replaces": TPU_KERNEL,
        "launches": launches,
        "max_abs_err": max_abs_err,
        "fuel_spent_abs_err": devs["fuel_spent"][0],
        "max_err_over_bar": max_err_over_bar,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
