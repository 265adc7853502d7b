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
  and contact solve, one warp per env branching on its broadphase flag);

and in both, every step's and every spawn tick's track stage runs in
``csrc/track_pass.cu`` (K4/K5: wheel-tile SAT, visit rewards, nearest tile,
on-grass). A third path is the env side of a state-PPO rollout at N = 2:
64-step chunks with ``obs.state_observation`` on every step and
``env.reset_done_envs`` from a pool of 32 host tracks between chunks, past
the 1000-step time limit.

The three kernels are built with nvcc at first use from the sources in the
checkout, one nvcc per kernel, started together.

Phases (each prints a line as it starts; any failure exits nonzero). The
island bars: every CarState field within 5e-4 * max(1, max|plain|) (the
value bar) and within 5e-4 * max(1e-3, max|plain - pre|) (the step bar: the
step's own change, so a millimetre-sized error in the position solve shows
on coordinates of hundreds of metres), limit states equal. The track bars
(tests/test_track_engine.py's): wheel_on_road, visited, tile_touched,
on_grass, count and nearest_beta equal, bonus within 2e-5.
  1. device: the card's name and power limit; no CUDA device -> exit 2
  2. build: the three kernels' build times and ptxas register/spill lines
  3. K1 vs plain: one island step through K1 and through its plain PyTorch
     version on the same card tensors at N = 1, E = 4096, after 20 driven
     steps; both bars; skid flags differing bounded
  4. small input: 4 envs stepped 10 times on the card and on the CPU (plain
     path) at N = 1: rewards within 2e-5, hull positions within 1e-3 m
  5. N = 1 main path: reset + 10 warm-up + 100 timed steps at E = 4096; all
     state finite; K1's launch count equals the resets plus steps and K2's
     is 0; the track kernel's count equals the resets plus steps and the
     plain track pass ran 0 times on the card; env-steps/s, K1's and the
     track kernel's times and bounds, stage times by CUDA events
  6. K2 vs plain at N = 2, E = 4096, on a state driven until a share of envs
     is broadphase-near: CarState fields and impulses within both bars,
     manifold ids differing bounded; fails if no env has a live contact
  7. a rear-end ram at N = 4 driven by the port: K2 vs plain at the first
     step whose normal impulse exceeds 0.1; both bars, ids equal
  8. determinism: two K2 launches on phase 6's input are bit-identical
  9. N = 2 main path: as phase 5 with K2 (K1's count 0)
 10. K4/K5 vs plain at N = 1 and N = 2, E = 4096: on a state driven until
     tiles are newly visited (at N = 2, until a car earns a second-visitor
     share) and on a spawn tick; the track bars; two launches bit-identical
 11. state-PPO rollout at N = 2, E = 4096: chunks of 64 steps with state
     observations, reset_done_envs between chunks, until a chunk has run
     after the time-limit reset; obs (E, 2, 38) finite, the time-limited envs
     at most one chunk old, at least 16 pool tracks in use; K2's and the
     track kernel's counts (set to 0 just before the first reset) each equal
     the first reset plus the steps plus the reset ticks, K1's count and the
     plain track pass's calls on the card are 0; env-steps/s and the ms of
     observations and of resets per chunk
 12. the kernels JSON line, the nvidia-smi line, and the result line

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
from multi_car_racing_tpu_torch import env as penv, obs as pobs, seeding  # noqa: E402
from multi_car_racing_tpu_torch.physics import fused_world, track_engine  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls  # noqa: E402
from multi_car_racing_tpu_torch.util import tree_leaves, tree_map  # noqa: E402

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
# K4/K5 replaces both TPU track-pass kernels: v1 (pallas_call :252 through
# track_pass_batched :190) and v2 (_make_kernel_v2 :304, pallas_call :498
# through track_pass_batched_v2 :440).
TRACK_TPU_KERNEL = "multi_car_racing_tpu/physics/track_engine.py:54"
TRACK_TPU_KERNEL_V2 = "multi_car_racing_tpu/physics/track_engine.py:304"
TRACK_NAMES = ("wheel_on_road", "visited", "bonus", "count", "tile_touched",
               "nearest_beta", "on_grass")
BONUS_TOL = 2e-5               # tests/test_track_engine.py's bar
TRACK_MIN_STEPS, TRACK_MAX_STEPS = 5, 60   # phase 10 drives within this window
# Phase 11: the env side of learner/ppo.py's state rollout (rollout_len 64,
# pool_size 32) at the reference's time limit.
ROLLOUT_N = 2
ROLLOUT_CHUNK = 64
POOL_SEEDS = tuple(range(100, 132))


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
    track_args = (state.track, pre, new_cars.hull_origin, state.visited, state.tile_touched,
                  cfg.num_agents)
    out = track_engine.track_pass(*track_args)
    gain = out[2]
    mid = state.replace(cars=new_cars)
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    fout, ls_out = island_kernel(cfg, fin, ls_in, state.contacts)[:2]
    return {
        "controls": cuda_ms(lambda: apply_controls(state.cars, action), 20),
        "island pack": cuda_ms(lambda: fused_world.pack_inputs(pre, state.wheel_on_road), 20),
        "island kernel": cuda_ms(lambda: island_kernel(cfg, fin, ls_in, state.contacts), 20),
        "island unpack": cuda_ms(lambda: fused_world.unpack_outputs(pre, fout, ls_out), 20),
        "track pass (K4/K5 with its wrapper)": cuda_ms(
            lambda: track_engine.track_pass(*track_args), 20),
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
    track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
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
    track_launches = track_engine.track_pass.launches
    plain_track_calls = track_engine.track_pass_plain.cuda_calls
    if getattr(fused_world.island_step, other):
        raise AssertionError(f"{label}: the other island kernel was launched")
    assert_finite(state)
    if tuple(ret.shape) != (E, cfg.num_agents) or not bool(torch.isfinite(ret).all()):
        raise AssertionError("returns have the wrong shape or are not finite")
    if launches != 1 + WARMUP + T:
        raise AssertionError(f"{label} island kernel launched {launches} times, expected "
                             f"{1 + WARMUP + T} (1 reset + {WARMUP + T} steps)")
    if track_launches != 1 + WARMUP + T or plain_track_calls:
        raise AssertionError(f"{label}: track kernel launched {track_launches} times "
                             f"(expected {1 + WARMUP + T}), plain track pass ran "
                             f"{plain_track_calls} times on the card (expected 0)")
    step_ms = 1e3 * elapsed / T
    phase(f"{label}: reset {reset_s:.3f} s; {T} steps in {elapsed:.4f} s = {step_ms:.4f} "
          f"ms/step, {E * T / elapsed:.1f} env-steps/s on {smi}; mean return "
          f"{float(ret.mean()):.4f}; done {int(done.sum())}/{E}; island launches "
          f"{launches}, track launches {track_launches}, plain track calls on the card "
          f"{plain_track_calls}")
    return {"state": state, "launches": launches, "track_launches": track_launches,
            "step_ms": step_ms}


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


def track_times(cfg, run: dict, actions) -> dict:
    """K4/K5's time per launch (CUDA events over the bare launch on packed
    inputs), the plain track stage's (for the record) and the kernel's bound
    from this input's valid tiles, on the main path's last inputs."""
    state, n = run["state"], cfg.num_agents
    pre = apply_controls(state.cars, actions[(WARMUP + T) % 8])
    post, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    wheels, origins = track_engine.pack_cars(pre, post.hull_origin)
    ms = cuda_ms(lambda: track_engine.launch(state.track, wheels, origins, state.visited,
                                             state.tile_touched), KERNEL_TIMING_LAUNCHES)
    plain_ms = cuda_ms(lambda: track_engine.track_pass_plain(
        state.track, pre, post.hull_origin, state.visited, state.tile_touched, n), 5)
    mt = state.track.max_tiles
    valid = int(state.track.n_tiles.sum())
    nbytes, flops = track_engine.track_pass_work(E, n, mt, valid_tiles=valid)
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    flop_ms = 1e3 * flops / PEAK_FP32_FLOPS
    bound_ms = max(byte_ms, flop_ms)
    phase(f"track kernel (N={n}) {ms:.5f} ms/launch ({ms / run['step_ms']:.1%} of a step), "
          f"plain track stage {plain_ms:.4f} ms; bound {bound_ms:.5f} ms ({nbytes} bytes = "
          f"{byte_ms:.5f} ms, {flops} fp32 ops = {flop_ms:.5f} ms, {valid} valid tiles)")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
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


def has_share(bonus: torch.Tensor, cnt: torch.Tensor, track) -> torch.Tensor:
    """Cars paid less than the full bonus of their new tiles: a second (or
    later) visitor's share, 0 < bonus < count * 1000 / n_tiles."""
    full = cnt.double() * (1000.0 / track.n_tiles.double())[:, None]
    return (bonus > 0) & (bonus.double() < full * (1 - 1e-4))


def compare_track(k, p, track, label: str) -> dict:
    """K4/K5 against the plain track pass on one input: every mask, the
    counts and nearest_beta equal, bonus within BONUS_TOL. Prints what the
    input exercised; raises past a bar."""
    bad = {name: int((a != b).sum()) for name, a, b in zip(TRACK_NAMES, k, p)
           if name != "bonus" and not (a.dtype == b.dtype and torch.equal(a, b))}
    bonus_err = float((k[2] - p[2]).abs().max())
    cnt = p[3]
    out = {"bonus_err": bonus_err, "gained": int((cnt.sum(1) > 0).sum()),
           "share": int(has_share(p[2], cnt, track).sum()), "new_tiles": int(cnt.sum()),
           "touched": int(p[4].sum())}
    phase(f"{label}: unequal outputs (elements) {bad}; max |bonus diff| {bonus_err:.3g}; "
          f"envs gaining a tile {out['gained']} ({out['new_tiles']} new tiles); cars with a "
          f"second-visitor share {out['share']}; wheels on road {int(p[0].sum())} of "
          f"{p[0].numel()}; touched tiles {out['touched']}; cars on grass "
          f"{int(p[6].sum())}")
    if bad or not bonus_err <= BONUS_TOL:
        raise AssertionError(f"{label}: K4/K5 vs plain past the bar ({bad}, bonus "
                             f"{bonus_err:.3g})")
    return out


def track_phase(cfg, actions) -> dict:
    """K4/K5 against the plain track pass at E envs of cfg.num_agents cars,
    on the next step of a driven batch that gains tiles (at N >= 2 with a
    second-visitor share) and on a spawn tick; two launches bit-identical."""
    n = cfg.num_agents
    state, stepped = penv.reset_batch(cfg, SEEDS, E), None
    for t in range(TRACK_MAX_STEPS):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
        if t + 1 < TRACK_MIN_STEPS:
            continue
        pre = apply_controls(state.cars, actions[(t + 1) % 8])
        post, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
        args = (state.track, pre, post.hull_origin, state.visited, state.tile_touched, n)
        out = track_engine.track_pass(*args)
        if bool((out[3] > 0).any()) and (n == 1 or bool(has_share(out[2], out[3],
                                                                   state.track).any())):
            stepped = (f"N={n}, the step after {t + 1} driven steps", args)
            break
    if stepped is None:
        raise AssertionError(f"N={n}: no step in {TRACK_MAX_STEPS} gained a tile"
                             + ("" if n == 1 else " with a second-visitor share"))
    dev = state.steps.device
    pool = penv.make_track_pool(cfg, SEEDS, device=dev)
    idx, orders, dirs = penv.draw_episodes(cfg, E, len(SEEDS),
                                           torch.Generator(device=dev).manual_seed(n))
    sp = penv.spawn_state(cfg, tree_map(lambda x: x.index_select(0, idx), pool), orders, dirs)
    spawn = (f"N={n}, a spawn tick", (sp.track, sp.cars, sp.cars.hull_origin, sp.visited,
                                      sp.tile_touched, n))
    # The spawn tick with every wheel lifted 1 km away: no wheel touches a
    # tile, so each touched tile comes from the hull-centre term alone.
    lifted = (f"N={n}, a spawn tick with the wheels lifted away (hull centres only)",
              (sp.track, sp.cars.replace(wheel_c=sp.cars.wheel_c + 1000.0),
               sp.cars.hull_origin, sp.visited, sp.tile_touched, n))
    results = {}
    for label, args in (stepped, spawn, lifted):
        k = track_engine.track_pass(*args)
        k2 = track_engine.track_pass(*args)
        p = track_engine.track_pass_plain(*args)
        torch.cuda.synchronize()
        r = compare_track(k, p, args[0], label)
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        phase(f"{label}: two launches bit-identical: {same}")
        if not same:
            raise AssertionError(f"{label}: two K4/K5 launches on one input differ")
        if args is lifted[1]:
            if r["new_tiles"] or r["touched"] < E:
                raise AssertionError(f"{label}: expected no new tile and a touched tile "
                                     f"under each env's hull centres")
        elif r["gained"] == 0 or (n >= 2 and r["share"] == 0):
            raise AssertionError(f"{label}: no env gained a tile"
                                 + ("" if n == 1 else " or no second-visitor share"))
        results[label] = r
    return results


def rollout_phase(smi: str, dev: torch.device) -> dict:
    """The env side of a state-PPO rollout: E envs of ROLLOUT_N cars from a
    pool of host tracks, chunks of ROLLOUT_CHUNK steps with a state
    observation before every step and reset_done_envs between chunks, until
    one chunk has run after the time-limit reset. The launch counts are set
    to 0 just before the first reset: every spawn tick and step must have
    gone through K2 and K4/K5, and neither K1 nor the plain track pass ran."""
    cfg = EnvConfig(num_agents=ROLLOUT_N)      # random direction, 1000-step limit
    t0 = time.perf_counter()
    pool = penv.make_track_pool(cfg, POOL_SEEDS, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, orders, dirs = penv.draw_episodes(cfg, E, len(POOL_SEEDS), gen)
    fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
    track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
    state = penv.reset_from_parts(cfg, tree_map(lambda x: x.index_select(0, idx), pool),
                                  orders, dirs)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    actions = cycled_actions(E, ROLLOUT_N, dev)
    first_x = pool.xy[:, 0, 0]

    def tracks_in_use(st) -> set:
        return set((st.track.xy[:, 0, 0][:, None] == first_x[None]).int().argmax(1).tolist())

    def event():
        return torch.cuda.Event(enable_timing=True)

    in_use = tracks_in_use(state)
    obs_events, reset_events = [], []
    finite = torch.ones((), dtype=torch.bool, device=dev)
    at_limit, chunks = None, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while True:
        for s in range(ROLLOUT_CHUNK):
            a, b = event(), event()
            a.record()
            ob = pobs.state_observation(state)
            b.record()
            obs_events.append((a, b))
            finite &= torch.isfinite(ob).all()
            state, _, _ = penv.step(cfg, state, actions[(chunks * ROLLOUT_CHUNK + s) % 8])
        chunks += 1
        if at_limit is not None:
            break                       # a whole chunk ran after the time-limit reset
        limit = state.steps >= cfg.max_episode_steps
        a, b = event(), event()
        a.record()
        state = penv.reset_done_envs(cfg, state, pool, gen)
        b.record()
        reset_events.append((a, b))
        in_use |= tracks_in_use(state)
        if bool(limit.any()):
            at_limit = limit
            if not bool((state.steps[limit] == 1).all()):
                raise AssertionError("rollout: a time-limited env was not reset")
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    steps = chunks * ROLLOUT_CHUNK
    obs_ms = sum(a.elapsed_time(b) for a, b in obs_events) / chunks
    reset_ms = sum(a.elapsed_time(b) for a, b in reset_events) / len(reset_events)
    limited = int(at_limit.sum())
    counts = {"contact_launches": fused_world.island_step.contact_launches,
              "track_launches": track_engine.track_pass.launches,
              "k1_launches": fused_world.island_step.launches,
              "plain_track_calls": track_engine.track_pass_plain.cuda_calls}
    want = 1 + steps + len(reset_events)        # first reset, steps, reset ticks
    out = {"chunks": chunks, "steps": steps, "env_steps_per_s": E * steps / elapsed,
           "obs_ms_per_chunk": obs_ms, "reset_ms_per_chunk": reset_ms,
           "reset_at_limit": limited, "tracks_in_use": len(in_use), "setup_s": setup_s,
           "max_steps_after": int(state.steps.max()), **counts}
    phase(f"rollout: {chunks} chunks of {ROLLOUT_CHUNK} steps at E={E}, N={ROLLOUT_N} in "
          f"{elapsed:.3f} s = {out['env_steps_per_s']:.1f} env-steps/s on {smi} (obs and "
          f"resets included); obs {obs_ms:.4f} ms and reset_done_envs {reset_ms:.4f} ms per "
          f"chunk (CUDA events); {limited} envs reset at the time limit, {E - limited} "
          f"earlier (done); {len(in_use)} of {len(POOL_SEEDS)} pool tracks in use; "
          f"steps at the end: max {out['max_steps_after']}; pool + first reset "
          f"{setup_s:.3f} s; launches: K2 {counts['contact_launches']}, K4/K5 "
          f"{counts['track_launches']} (expected {want} = 1 reset + {steps} steps + "
          f"{len(reset_events)} reset ticks), K1 {counts['k1_launches']}, plain track "
          f"calls on the card {counts['plain_track_calls']}")
    if (counts["contact_launches"] != want or counts["track_launches"] != want
            or counts["k1_launches"] or counts["plain_track_calls"]):
        raise AssertionError(f"rollout: launch counts {counts}, expected K2 and K4/K5 "
                             f"{want} each, K1 and the plain track pass 0")
    if tuple(ob.shape) != (E, ROLLOUT_N, pobs.STATE_OBS_DIM) or not bool(finite):
        raise AssertionError(f"rollout: observations {tuple(ob.shape)}, finite {bool(finite)}")
    if not bool((state.steps[at_limit] <= ROLLOUT_CHUNK + 1).all()):
        raise AssertionError("rollout: an env reset at the time limit is older than a chunk")
    if out["max_steps_after"] >= cfg.max_episode_steps:
        raise AssertionError("rollout: an env ran past the time limit without a reset")
    if len(in_use) < 16:
        raise AssertionError(f"rollout: only {len(in_use)} pool tracks drawn")
    return out


def report(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
           max_err_over_bar: float, times: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err,
            "max_err_over_bar": max_err_over_bar, **times, "library_ms": None, **extra}


def main() -> int:
    start = time.perf_counter()
    phase("1/12 device")
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

    phase("2/12 build (one nvcc per kernel, started together)")
    t0 = time.perf_counter()
    kernels = (fused_world.KERNEL, fused_world.CONTACT_KERNEL, track_engine.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_cuda.load, kernels))
    fused_world._library(fused_world.KERNEL)
    fused_world._library(fused_world.CONTACT_KERNEL)
    track_engine._library()
    for name in kernels:
        info = _cuda.build_info[name]
        phase(f"built {name} in {info['seconds']:.2f} s: " + " | ".join(info["ptxas"]))
    phase(f"all kernels loaded {time.perf_counter() - t0:.2f} s after the builds started")

    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    actions = cycled_actions(E, cfg.num_agents, dev)

    phase(f"3/12 K1 vs plain at E={E} after 20 steps")
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

    phase(f"4/12 small input: {len(SMALL_SEEDS)} envs x {SMALL_STEPS} steps, card vs CPU")
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

    phase(f"5/12 N=1 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run1 = main_path(cfg, actions, "N=1", smi)
    times1 = kernel_times(cfg, run1, actions)
    track1 = track_times(cfg, run1, actions)
    k1 = report(fused_world.KERNEL, "multi_car_racing_tpu_torch/csrc/joints_island.cu",
                TPU_KERNEL, run1["launches"], max_abs_err, max_err_over_bar, times1,
                variant="force_no_contacts=True", fuel_spent_abs_err=devs["fuel_spent"][0])

    cfg2 = EnvConfig(num_agents=2, use_random_direction=False)
    actions2 = cycled_actions(E, cfg2.num_agents, dev)
    phase(f"6/12 K2 vs plain at N=2, E={E}, driven until {NEAR_SHARE:.0%} of envs are near")
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

    phase("7/12 rear-end ram (N=4, E=1): K2 vs plain at the first step with contact")
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

    phase("8/12 determinism: two K2 launches on phase 6's input")
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    b = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    same = all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
        (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
    phase(f"bit-identical: {same}")
    if not same:
        raise AssertionError("two K2 launches on the same input differ")

    phase(f"9/12 N=2 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run2 = main_path(cfg2, actions2, "N=2", smi)
    times2 = kernel_times(cfg2, run2, actions2)
    track2 = track_times(cfg2, run2, actions2)
    all2 = {**devs2, **{f"ram {f}": v for f, v in devs_ram.items()}}
    k2 = report(fused_world.CONTACT_KERNEL,
                "multi_car_racing_tpu_torch/csrc/contact_island.cu", TPU_KERNEL,
                run2["launches"],
                max(d for f, (d, _, _) in all2.items() if not f.endswith("fuel_spent")),
                max(max(rv, rs) for _, rv, rs in all2.values()), times2,
                variant="full contact", near_share=float(near.float().mean()),
                live_envs=k_live_envs,
                id_miss_envs=id_miss, ram_max_normal_imp=ram_imp)

    phase(f"10/12 K4/K5 vs plain at E={E}, N=1 and N=2: a stepped state and a spawn tick")
    checks = {**track_phase(cfg, actions), **track_phase(cfg2, actions2)}
    worst = max(r["bonus_err"] for r in checks.values())
    k45 = report(track_engine.KERNEL, "multi_car_racing_tpu_torch/csrc/track_pass.cu",
                 TRACK_TPU_KERNEL, run2["track_launches"], worst, worst / BONUS_TOL, track2,
                 variant="v1 and v2 (one kernel)", also_replaces=TRACK_TPU_KERNEL_V2,
                 main_path="N=2", launches_n1=run1["track_launches"],
                 **{f"{k}_n1": v for k, v in track1.items()},
                 checks={k: {"gained": r["gained"], "second_visitor_shares": r["share"]}
                         for k, r in checks.items()})

    phase(f"11/12 state-PPO rollout: E={E}, N={ROLLOUT_N}, pool of {len(POOL_SEEDS)} host "
          f"tracks, chunks of {ROLLOUT_CHUNK} steps, past the time limit")
    rollout = rollout_phase(smi, dev)

    phase(f"12/12 report: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k45], "rollout": rollout}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
