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
  and contact solve, two launches per call: a far pass, one thread per car,
  that runs far envs as K1 does and lists the near envs on the card, then a
  near pass, one warp per listed env, whose solve walks the live rows only);

and in both, every step's and every spawn tick's track stage runs in
``csrc/track_pass.cu`` (K4/K5: wheel-tile SAT, visit rewards, nearest tile,
on-grass). A third path is the env side of a state-PPO rollout at N = 2:
64-step chunks with ``obs.state_observation`` on every step and
``env.reset_done_envs`` from a pool of 32 host tracks between chunks, past
the 1000-step time limit. The pixel paths: ``obs.pixel_observation_batched``
after every step of ``bench.py``'s pixel workload (E = 4096, N = 2), and the
env side of a pixel-PPO rollout (E = 1024, N = 2, a frame per decision of 4
steps, autoreset between chunks), where every frame is one launch of
``csrc/paint_view.cu`` (K6: the 96x96 painter, one block per view, each view
branching on its own warm-up flag; each warp bins 16x16 patches of its view
by a conservative edge-function reject, then paints 8x8 cells testing only
their candidates).

K3 (``csrc/solve_island.cu``, the island solve alone from a ContactBundle
made outside) is on none of those paths: its path is
``fused_world.world_step_batched``, driven on the card at N = 2, 4 and 1 and
as the harness that holds K2's in-kernel Collide apart from its solve
(phases 9-12); on env.step's paths its count stays 0. A K3 call is two
launches: a list pass, one thread per env, that lists the envs with a live
contact point on the card, then a solve pass that runs every car of the
other envs as K1's chain without the tire model, one thread per car, beside
one warp per listed env (without a bundle, the solve pass alone).

The five kernels are built with nvcc at first use from the sources in the
checkout, one nvcc per kernel, started together.

Phases (each prints a line as it starts; any failure exits nonzero). The
island bars: every CarState field within 5e-4 * max(1, max|plain|) (the
value bar) and within 5e-4 * max(1e-3, max|plain - pre|) (the step bar: the
step's own change, so a millimetre-sized error in the position solve shows
on coordinates of hundreds of metres), limit states equal. The track bars
(tests/test_track_engine.py's): wheel_on_road, visited, tile_touched,
on_grass, count and nearest_beta equal, bonus within 2e-5.
  1. device: the card's name and power limit; no CUDA device -> exit 2
  2. build: the five kernels' build times and ptxas register/spill lines;
     K1's, K2's (near and far pass), K3's (list and solve pass) and
     K4/K5's registers and spills
  3. K1 vs plain: one island step through K1 and through its plain PyTorch
     version on the same card tensors at N = 1, E = 4096, after 20 driven
     steps; both bars; skid flags differing bounded; K1's ms on that input
  4. small input: 4 envs stepped 10 times on the card and on the CPU (plain
     path) at N = 1: rewards within 2e-5, hull positions within 1e-3 m
  5. N = 1 main path: reset + 10 warm-up + 100 timed steps at E = 4096; all
     state finite; K1's launch count equals the resets plus steps and K2's
     and K3's are 0; the track kernel's count equals the resets plus steps
     and the plain track pass ran 0 times on the card; env-steps/s, K1's and
     the track kernel's times and bounds (K4/K5's culled bound beside the
     un-culled kernel's, with the candidates per car), stage times by CUDA
     events. Kernel times of K1-K5 are device time per launch: 50 launches
     captured in a CUDA graph (graph_ms), since a kernel of tens of
     microseconds finishes before the host launches the next; K4/K5's with
     a 128 MiB read before each launch, its own time subtracted
     (cold_graph_ms), beside the warm replay and the kernel's device time
     over 10 main-path steps from a torch.profiler trace; K6's (~1 ms) are
     CUDA events over 50 launches from the host
  6. K2 vs plain at N = 2, E = 4096, on a state driven until a share of envs
     is broadphase-near: CarState fields and impulses within both bars,
     manifold ids differing bounded; fails if no env has a live contact.
     Live rows per near env (fused_world.live_routing). The far pass: every
     far env's cars byte-equal to the same cars through K1, its carry zero,
     and K2's near count equal to near_flags' sum -- on that input, on an
     all-far one (car 1 of every env moved 500 m) and on an all-near one (a
     spawn tick with car 1 pulled to 2.7 m of car 0); K2 vs plain on both;
     K2's ms on phase 6's input
  7. a rear-end ram at N = 4 driven by the port: K2 vs plain at the first
     step whose normal impulse exceeds 0.1; both bars, ids equal. Then N = 4,
     E = 1024 driven until 10% of envs are near: K2 vs plain, the far pass,
     and K3's ms beside K2's with the solve's share; and four overlapping
     cars per env (more than 32 live rows): K2 vs plain, both bars
  8. determinism: two K2 launches on phase 6's input and on the all-near
     input (the near list filled in no fixed order) are bit-identical
  9. K3 vs plain at N = 2, E = 4096, full 180/60, on phase 6's input: the
     plain tire model, Collide pass and make_bundle, then world_step_batched
     on the card against world.world_step on the same card tensors; every
     CarState field and both impulses within both bars; fails if no env has
     a live contact. K3's count is set to 0 here. After each K3 call of
     phases 9-11: its live count (read on the host here) equals
     fused_world.solve_live_envs' sum and the envs it listed are the live
     ones
 10. K3 vs plain on phase 7's ram (N = 4) and at N = 1, E = 4096 (no bundle)
 11. K2 vs plain Collide + K3 on phase 6's input: K2's island step against
     the plain tire model, Collide and make_bundle followed by K3; both
     bars, manifold ids differing bounded. K3's count read here: one per
     world_step_batched call of phases 9-11
 12. two K3 launches bit-identical, on phase 6's input and on the all-near
     input (every env listed, in the order the list pass appended them);
     K3's ms per launch (CUDA graph, 50 launches) beside K2's on the same
     input (K1's at N = 1), its live envs, its bound (solve_island_flops /
     solve_island_bytes), the plain solve's ms and the plain tire + Collide
     + make_bundle ms: on phase 6's input, the all-far and all-near inputs,
     the spawn tick, and at N = 1 with no bundle (phase 3's cars)
 13. N = 2 main path: as phase 5 with K2 (K1's and K3's counts 0); then
     phase 12's times on the main path's last input, and K2's ms beside its
     bound on the all-far and all-near inputs
 14. K4/K5 vs plain at N = 1 and N = 2, E = 4096, and N = 4, E = 1024: on a
     state driven until tiles are newly visited (at N >= 2, until a car
     earns a second-visitor share), on a spawn tick, on that tick with the
     wheels lifted away, and on the cull's edges (track_cases.cull_cases:
     hull origins on the road and past the kerb, across the start seam, on
     a kerb, 30 m off the road, where the loop comes nearest to itself, and
     wheels on the road with both origins 1 km away); the track bars; two
     launches bit-identical; every tile the plain pass marks kept by the
     cull's plain predicate (track_engine.track_candidates), and the
     candidates per car (mean and max). Then on track_cases.cull_probes
     (centreline points moved 12 m off the quads, wheels only and origins
     only), where the cull drops marks: K4/K5 equal to
     track_engine.track_pass_culled_plain under the track bars, which pins
     the kernel's cull radii to the plain predicate's
 15. state-PPO rollout at N = 2, E = 4096: chunks of 64 steps with state
     observations, reset_done_envs between chunks, until a chunk has run
     after the time-limit reset; obs (E, 2, 38) finite, the time-limited envs
     at most one chunk old, at least 16 pool tracks in use; K2's and the
     track kernel's counts (set to 0 just before the first reset) each equal
     the first reset plus the steps plus the reset ticks, K1's count and the
     plain track pass's calls on the card are 0; env-steps/s and the ms of
     observations and of resets per chunk
 16. K6 vs plain, every byte equal, and two launches bit-identical: at N = 2,
     E = 4096, the spawn tick (every view warm), a state driven 60 steps
     (steady), that state at t = 0.25, 0.5 and 0.75 s (a third of the envs
     each: warm, mid zoom), that state with every camera jittered by
     sub-pixel amounts from a numpy seed (edges near pixel centres and cell
     corners), a mixed batch after
     reset_done_envs refreshed a third of the envs, and that state with
     driving_backward set in a third of the views (the flag); at N = 1 with
     CW direction (E = 1024) and at N = 4 with use_ego_color (E = 512), on
     the spawn tick and after 60 steps; then the five 96x96 golden frames
     (tests/fixtures/golden, loaded through convert.env_state_from_leaves),
     byte for byte
 17. pixel main path: bench.py's pixel workload (random direction per
     track) -- reset + 10 warm-up + 100 timed steps at E = 4096, N = 2 with
     a frame after the reset and after every step; K6's count equals the
     111 frames and the plain painter ran 0 times on the card; env-steps/s
     with frames, K6's ms per launch (CUDA events over 50 launches) on the
     last state (steady), on that state at t = 0.5 s (mid zoom) and on the
     spawn tick, its bounds (paint_work), the mean road and car candidates
     per 8x8 cell at mid zoom (the plain cull predicate,
     pixels.paint_candidates), its ptxas registers and spills, the plain
     painter's ms, the
     view_inputs ms, and a stage table
 18. pixel-PPO env side at E = 1024, N = 2 (learner/ppo.py's pixel shape):
     a pool of 32 host tracks, chunks of 32 decisions with action repeat 4
     (128 steps, a frame per decision), reset_done_envs between chunks, 9
     chunks = 1152 steps past the 1000-step limit, so warm and steady views
     mix within launches; K6 = frames, K2 = K4/K5 = 1 + steps + reset ticks,
     K1 and the plain painter 0; env-steps/s and the frame ms per chunk
 19. the kernels JSON line, the nvidia-smi line, and the result line

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

from multi_car_racing_tpu_torch import EnvConfig, _cuda, convert  # noqa: E402
from multi_car_racing_tpu_torch import env as penv, obs as pobs, seeding  # noqa: E402
from multi_car_racing_tpu_torch.render import pixels  # noqa: E402
from multi_car_racing_tpu_torch.physics import collide, fused_world  # noqa: E402
from multi_car_racing_tpu_torch.physics import tire, track_cases, track_engine  # noqa: E402
from multi_car_racing_tpu_torch.physics import world  # noqa: E402
from multi_car_racing_tpu_torch.physics.collide import ContactState  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls, create_cars  # noqa: E402
from multi_car_racing_tpu_torch.util import tree_leaves, tree_map  # noqa: E402

E = 4096
SEEDS = tuple(range(16))
WARMUP = 10
T = 100
KERNEL_TIMING_LAUNCHES = 50
L2_FLUSH_BYTES = 128 << 20     # read between K4/K5's timed launches: 2.5x the H100's L2
PROFILE_STEPS = 10             # env steps in K4/K5's main-path profiler trace
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
# K3 replaces the solve-only Pallas kernel: _make_solve_kernel :865, its
# pallas_call :1237 from world_step_batched :1181.
SOLVE_TPU_KERNEL = "multi_car_racing_tpu/physics/pallas_world.py:865"
NEAR_SHARE = 0.10              # drive phase 6 until this share of envs is near
NEAR_MAX_STEPS = 120
ALL_FAR_SHIFT = 500.0          # the all-far input: car 1 of every env moved this far in x
ALL_NEAR_PULL = 0.55           # the all-near input: the spawn tick's car 1 moved toward car 0
#                                by this share of their 6 m (2.7 m apart: every env near)
N4_E = 1024                    # phase 7's N = 4 near state
PILE_ENVS, PILE_SEED = 8, 5    # four overlapping cars per env, > 32 live rows
PILE_STEP, PILE_TURN = 0.3, 0.15   # car c moved 0.3 m at c * 90 degrees, turned c * 0.15 rad
RAM_STEPS = (100, 160)         # phase 7 looks for the contact in this window
# K4/K5 replaces both TPU track-pass kernels: v1 (pallas_call :252 through
# track_pass_batched :190) and v2 (_make_kernel_v2 :304, pallas_call :498
# through track_pass_batched_v2 :440).
TRACK_TPU_KERNEL = "multi_car_racing_tpu/physics/track_engine.py:54"
TRACK_TPU_KERNEL_V2 = "multi_car_racing_tpu/physics/track_engine.py:304"
TRACK_NAMES = track_engine.OUTPUT_NAMES
BONUS_TOL = 2e-5               # tests/test_track_engine.py's bar
TRACK_MIN_STEPS, TRACK_MAX_STEPS = 5, 60   # phase 10 drives within this window
# Phase 11: the env side of learner/ppo.py's state rollout (rollout_len 64,
# pool_size 32) at the reference's time limit.
ROLLOUT_N = 2
ROLLOUT_CHUNK = 64
POOL_SEEDS = tuple(range(100, 132))
# K6 replaces the Pallas painter: _make_kernel :353 / _paint_view :389, its
# pallas_call :638 from render_pixels :587.
PAINT_TPU_KERNEL = "multi_car_racing_tpu/render/pallas_raster.py:353"
PIXEL_DRIVE = 60                # steps to a steady (post zoom-out) state
MID_ZOOM_TS = (0.25, 0.5, 0.75)  # a warm batch at mid zoom (the view zooms out over 1 s)
MID_ZOOM_T = 0.5                # phase 17 times K6 on the last state at this t
JITTER_SEED = 11
JITTER_SHIFT, JITTER_TURN = 0.3, 0.01   # world units, rad: about half a pixel each
CAND_CHUNK = 256                # envs per pass of the plain cull predicate
PIXEL_E1, PIXEL_E4 = 1024, 512  # envs of the N = 1 CW and N = 4 ego-colour checks
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                          "golden")
GOLDENS = ("steady_2agent", "warmup_2agent", "cw_1agent", "egocolor_4agent",
           "backwards_flag")
# Phase 14: learner/ppo.py's pixel rollout at the multi2px shape.
PPO_E = 1024
PPO_DECISIONS = 32              # decisions per chunk
PPO_REPEAT = 4                  # physics steps per decision
PPO_CHUNKS = 9                  # 9 * 128 = 1152 steps, past the 1000-step limit


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


def graph_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` (launches only, nothing that waits on
    the host): ``reps`` calls captured in one CUDA graph, timed by CUDA
    events over one replay after a warm-up replay. A kernel of a few tens of
    microseconds finishes before the host has launched the next through its
    Python wrapper, so cuda_ms would time the host there."""
    fn()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def cold_graph_ms(fn, reps: int) -> tuple[float, float]:
    """(device time per call of ``fn`` with an L2 cache that holds other
    data, the cost of the flush): graph_ms of a read of L2_FLUSH_BYTES
    followed by ``fn``, less graph_ms of the read alone. graph_ms replays
    ``fn`` on one unchanged input, whose bytes can stay in the 50 MB L2
    from one call to the next."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, device="cuda")
    total = torch.empty((), device="cuda")

    def flush():
        torch.sum(buf, dim=0, out=total)

    flush_ms = graph_ms(flush, reps)
    both_ms = graph_ms(lambda: (flush(), fn()), reps)
    return both_ms - flush_ms, flush_ms


def profiled_kernel_ms(cfg, state, actions, kernel: str) -> float | None:
    """Device time per launch of the kernels named ``kernel`` over
    PROFILE_STEPS env steps from ``state`` (after two unprofiled ones), from
    a torch.profiler trace: the kernel among the main path's other work.
    None where the trace holds no device time for it."""
    from torch.profiler import ProfilerActivity, profile

    for t in range(2):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for t in range(PROFILE_STEPS):
            state, _, _ = penv.step(cfg, state, actions[(2 + t) % 8])
        torch.cuda.synchronize()
    for ev in prof.key_averages():
        if kernel in ev.key and ev.count:
            us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0)
            return us / 1e3 / ev.count if us else None
    return None


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
    fused_world.world_step_batched.launches = 0
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
    if getattr(fused_world.island_step, other) or fused_world.world_step_batched.launches:
        raise AssertionError(f"{label}: the other island kernel or K3 was launched")
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
            "solve_launches": fused_world.world_step_batched.launches, "step_ms": step_ms}


def kernel_times(cfg, run: dict, actions) -> dict:
    """Kernel, plain-version and per-stage times on the main path's last
    inputs, and the kernel's bound from the work this input needs."""
    state, step_ms = run["state"], run["step_ms"]
    n = cfg.num_agents
    action = actions[(WARMUP + T) % 8]
    pre = apply_controls(state.cars, action)
    lagged = state.wheel_on_road
    fin, ls_in = fused_world.pack_inputs(pre, lagged)
    kernel_ms = graph_ms(lambda: island_kernel(cfg, fin, ls_in, state.contacts),
                        KERNEL_TIMING_LAUNCHES)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_out = fused_world.island_step_plain(pre, lagged, state.contacts)[0]
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    b = island_bound(pre, n, int((p_out.limit_state != 0).sum()))
    phase(f"island kernel {kernel_ms:.5f} ms/launch ({kernel_ms / step_ms:.1%} of a step), "
          f"plain {plain_ms:.3f} ms; bound {b['bound_ms']:.5f} ms ({b['flops']} fp32 ops, "
          f"{b['bytes']} bytes, {b['work']})")
    stages = stage_times(cfg, state, action)
    phase("step stages (ms, CUDA events, 20 reps each): "
          + ", ".join(f"{k} {v:.4f}" for k, v in stages.items())
          + f"; sum {sum(stages.values()):.4f} of {step_ms:.4f} ms/step")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": b["bound_ms"],
            "bound_by": b["bound_by"]}


def island_bound(pre, n: int, n_limit: int) -> dict:
    """The island kernel's (K1's or K2's) bound on pre-solve cars ``pre``
    from the work this input needs, ``n_limit`` joints at a limit."""
    n_cars = pre.hull_a.numel()
    if n == 1:
        flops = fused_world.island_flops(n_cars, n_limit)
        nbytes = fused_world.island_bytes(n_cars)
        counts = {}
    else:
        counts = fused_world.contact_island_work(pre)
        flops = fused_world.contact_island_flops(n_cars, n_limit, n, **counts)
        nbytes = fused_world.contact_island_bytes(n_cars, n)
    flop_ms = 1e3 * flops / PEAK_FP32_FLOPS
    byte_ms = 1e3 * nbytes / PEAK_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes, "bound_ms": max(flop_ms, byte_ms),
            "bound_by": "operations" if flop_ms >= byte_ms else "bytes", "counts": counts,
            "work": ", ".join([f"{n_limit} joints at a limit"] + [
                f"{k[2:].replace('_', ' ')} {v}" for k, v in counts.items()])}


def track_times(cfg, run: dict, actions) -> dict:
    """K4/K5's time per launch on packed inputs (cold_graph_ms, beside the
    warm replay of graph_ms and its device time among the main path's work
    from profiled_kernel_ms), the plain track stage's (for the record), the
    candidates per car of the cull's plain predicate, and the kernel's bound
    from the work this input needs -- the culled count (valid tiles,
    candidates, the tiles whose curb the post-solve origin may lie in) --
    beside the un-culled kernel's (every table of every valid tile), on the
    main path's last inputs."""
    state, n = run["state"], cfg.num_agents
    pre = apply_controls(state.cars, actions[(WARMUP + T) % 8])
    post, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
    wheels, origins = track_engine.pack_cars(pre, post.hull_origin)

    def launch():
        track_engine.launch(state.track, wheels, origins, state.visited, state.tile_touched)

    warm_ms = graph_ms(launch, KERNEL_TIMING_LAUNCHES)
    ms, flush_ms = cold_graph_ms(launch, KERNEL_TIMING_LAUNCHES)
    path_ms = profiled_kernel_ms(cfg, state, actions, "track_pass_kernel")
    plain_ms = cuda_ms(lambda: track_engine.track_pass_plain(
        state.track, pre, post.hull_origin, state.visited, state.tile_touched, n), 5)
    mt = state.track.max_tiles
    valid = int(state.track.n_tiles.sum())
    cand = track_engine.track_candidates(state.track, pre, post.hull_origin)
    near_post = track_engine.post_candidates(state.track, post.hull_origin)
    per_car = cand.sum(-1)

    def bound(nbytes, flops):
        byte_ms, flop_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOPS
        return {"bound_ms": max(byte_ms, flop_ms), "bytes": nbytes, "flops": flops,
                "bound_by": "operations" if flop_ms >= byte_ms else "bytes"}

    culled = bound(*track_engine.track_pass_work(E, n, mt, valid_tiles=valid, candidates=cand,
                                                 near_post=near_post))
    full = bound(*track_engine.track_pass_work(E, n, mt, valid_tiles=valid))
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": culled["bound_ms"],
           "bound_by": culled["bound_by"], "warm_l2_ms": warm_ms, "l2_flush_ms": flush_ms,
           "main_path_profiled_ms": path_ms, "uncull_bound_ms": full["bound_ms"],
           "uncull_bound_by": full["bound_by"], "cand_mean": float(per_car.float().mean()),
           "cand_max": int(per_car.max())}
    path = "no device time in the trace" if path_ms is None else f"{path_ms:.5f} ms"
    phase(f"track kernel (N={n}) {ms:.5f} ms/launch after an L2 flush ({ms / run['step_ms']:.1%} "
          f"of a step; the flush's {L2_FLUSH_BYTES} bytes alone {flush_ms:.5f} ms), "
          f"{warm_ms:.5f} replayed warm; on the main path (torch.profiler, {PROFILE_STEPS} "
          f"steps) {path}; plain track stage {plain_ms:.4f} ms; candidates per car mean "
          f"{out['cand_mean']:.4f}, max {out['cand_max']}; bound {culled['bound_ms']:.5f} ms "
          f"({culled['bound_by']}: {culled['bytes']} bytes, {culled['flops']} fp32 ops, "
          f"{valid} valid tiles); the un-culled kernel's bound {full['bound_ms']:.5f} ms "
          f"({full['bytes']} bytes, {full['flops']} fp32 ops)")
    return out


def ptxas_table(name: str) -> dict:
    """Registers and spill bytes per entry function of a kernel's build."""
    out, cur = {}, None
    for ln in _cuda.build_info[name]["ptxas"]:
        if "Compiling entry function" in ln:
            words = [w for w in ln.replace("'", " ").split() if w.startswith("_Z")]
            cur = next((k for k in ("near_pass", "far_pass", "list_pass", "solve_pass",
                                    "joints_island", "track_pass", "paint_view")
                        if words and k in words[0]), ln)
            out[cur] = {}
        elif cur is not None and "spill stores" in ln:
            out[cur]["spill_stores"] = int(ln.split("bytes spill stores")[0].split()[-1])
            out[cur]["spill_loads"] = int(ln.split("bytes spill loads")[0].split()[-1])
        elif cur is not None and "registers" in ln:
            out[cur]["registers"] = int(ln.split("Used")[1].split()[0])
    return out


def spawn_batch(cfg, envs: int, seed: int, dev):
    """The state before a spawn tick at ``envs`` envs from the SEEDS tracks,
    episodes drawn from ``seed``."""
    pool = penv.make_track_pool(cfg, SEEDS, device=dev)
    idx, orders, dirs = penv.draw_episodes(cfg, envs, len(SEEDS),
                                           torch.Generator(device=dev).manual_seed(seed))
    return penv.spawn_state(cfg, tree_map(lambda x: x.index_select(0, idx), pool), orders, dirs)


def move_car1(cars, offset: torch.Tensor):
    """Car 1 of every env (hull and wheels) moved by ``offset`` (E, 2)."""
    hc, wc = cars.hull_c.clone(), cars.wheel_c.clone()
    hc[:, 1] += offset
    wc[:, 1] += offset[:, None]
    return cars.replace(hull_c=hc, wheel_c=wc)


def piled_cars(device):
    """PILE_ENVS envs of four cars on one pose, car c moved PILE_STEP m in
    direction c * 90 degrees and turned by c * PILE_TURN (no two faces
    parallel; numpy seed PILE_SEED): every pair overlaps, with more than 32
    live manifold rows per env."""
    rng = np.random.RandomState(PILE_SEED)
    c = np.arange(4) * (np.pi / 2)
    pos = (np.repeat(rng.uniform(-300, 300, (PILE_ENVS, 1, 2)), 4, 1)
           + PILE_STEP * np.stack([np.cos(c), np.sin(c)], -1)[None])
    ang = (np.repeat(rng.uniform(-np.pi, np.pi, (PILE_ENVS, 1)), 4, 1)
           + PILE_TURN * np.arange(4)[None])
    cars = create_cars(torch.as_tensor(pos, dtype=torch.float32, device=device),
                       torch.as_tensor(ang, dtype=torch.float32, device=device))
    return (cars, torch.ones((PILE_ENVS, 4, 4), dtype=torch.bool, device=device),
            collide.init_contact_state(PILE_ENVS, 4, device=device))


def live_rows(cars, n: int) -> tuple[float, int]:
    """Mean and largest number of live manifold rows per near env
    (fused_world.live_routing on the plain Collide pass)."""
    near = fused_world.near_flags(cars)
    rows = fused_world.live_routing(collide.collide(cars, n).point_ok, n)[1][near]
    return (float(rows.float().mean()) if rows.numel() else 0.0,
            int(rows.max()) if rows.numel() else 0)


def far_pass_check(pre, wheel_on_road, contacts, n: int, label: str) -> dict:
    """K2's far pass on one input: every far env's cars byte-equal to the same
    cars through K1, its carry zero impulses and ids -1, and K2's near count
    (read on the host here, after the launch) equal to near_flags' sum."""
    fin, ls_in = fused_world.pack_inputs(pre, wheel_on_road)
    fout, ls_out, cs = fused_world.launch_contacts(fin, ls_in, contacts, n)
    count = int(fused_world.launch_contacts.near_count)
    k1_out, k1_ls = fused_world.launch(fin, ls_in, fin.shape[1])
    near = fused_world.near_flags(pre)
    torch.cuda.synchronize()
    far = (~near)[:, None].expand(-1, n).reshape(-1)
    same = torch.equal(fout[:, far], k1_out[:, far]) and torch.equal(ls_out[:, far], k1_ls[:, far])
    carry = (not bool(cs.normal_imp[~near].any()) and not bool(cs.tangent_imp[~near].any())
             and bool((cs.ids[~near] == -1).all()))
    out = {"far_envs": int((~near).sum()), "near_count": count, "near_flags_sum": int(near.sum()),
           "far_byte_equal_k1": same, "far_carry_zero": carry}
    phase(f"{label}: far envs {out['far_envs']}, their cars byte-equal to K1: {same}, carry "
          f"zero / ids -1: {carry}; K2's near count {count}, near_flags sum "
          f"{out['near_flags_sum']}")
    if not (same and carry and count == out["near_flags_sum"]):
        raise AssertionError(f"{label}: K2's far pass {out}")
    return out


def k2_time_and_bound(pre, wheel_on_road, contacts, n: int) -> dict:
    """K2's ms per launch (graph_ms) on one input and its bound from the
    work this input needs."""
    fin, ls_in = fused_world.pack_inputs(pre, wheel_on_road)
    ms = graph_ms(lambda: fused_world.launch_contacts(fin, ls_in, contacts, n),
                  KERNEL_TIMING_LAUNCHES)
    ls_out = fused_world.launch_contacts(fin, ls_in, contacts, n)[1]
    b = island_bound(pre, n, int((ls_out != 0).sum()))
    return {"ms": ms, "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "near_envs": b["counts"]["n_near_envs"]}


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


def solve_inputs(pre, wheel_on_road, contacts, n: int):
    """K3's inputs from pre-solve cars: the plain tire model and, at n >= 2,
    the plain Collide pass and make_bundle. Returns (post-tire cars, wheel
    force, motor speed, bundle or None, skid, manifolds or None)."""
    post, force, motor, skid = tire.tire_step(pre, wheel_on_road)
    if n == 1:
        return post, force, motor, None, skid, None
    man = collide.collide(post, n)
    return post, force, motor, collide.make_bundle(man, contacts, post, n), skid, man


def compare_solve(inputs, n: int, label: str) -> dict:
    """K3 (``world_step_batched`` on the card) against the plain
    ``world.world_step`` on the same card tensors and bundle: every CarState
    field and, with a bundle, both impulses within both bars (the step's
    change taken from K3's input), limit states equal. Fails if a bundle
    gives no env a live contact."""
    post, force, motor, bundle = inputs[:4]
    k_cars, k_imp = fused_world.world_step_batched(post, force, motor, bundle, n)
    live_list_check(bundle, post.hull_a.shape[0], label)
    p_cars, p_bundle = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    devs = compare_cars(k_cars, p_cars, post, label)
    if bundle is not None:
        devs.update(compare_fields(
            {"normal_imp": k_imp[0], "tangent_imp": k_imp[1]},
            {"normal_imp": p_bundle.normal_imp, "tangent_imp": p_bundle.tangent_imp},
            {"normal_imp": bundle.normal_imp, "tangent_imp": bundle.tangent_imp}, label))
        live = int(p_bundle.normal_imp.gt(0).any(-1).any(-1).sum())
        k_live = int(k_imp[0].gt(0).any(-1).any(-1).sum())
        phase(f"{label}: {int(bundle.man.point_ok.sum())} live contact points; envs with a "
              f"normal impulse: plain {live}, K3 {k_live}; max |normal_imp| K3 "
              f"{float(k_imp[0].abs().max()):.4f}")
        if k_live == 0:
            raise AssertionError(f"{label}: no env with a live contact")
    return devs


def live_list_check(bundle, envs: int, label: str) -> int:
    """K3's last call: its live count (read on the host here) equals
    solve_live_envs' sum, and the envs it listed are the live ones. Returns
    the count."""
    live = fused_world.solve_live_envs(bundle, envs)
    count = int(fused_world.launch_solve.live_count)
    listed = torch.sort(fused_world.launch_solve.live_list[:count].long()).values
    same = torch.equal(listed.cpu(), live.nonzero().flatten().cpu())
    phase(f"{label}: K3's live count {count}, solve_live_envs sum {int(live.sum())}, the "
          f"listed envs are the live ones: {same}")
    if count != int(live.sum()) or not same:
        raise AssertionError(f"{label}: K3's live list differs from solve_live_envs")
    return count


def solve_times(pre, wheel_on_road, contacts, n: int) -> dict:
    """On one step's input: K3's time per launch (graph_ms over the bare
    launch on packed inputs, both its kernels), K2's (the whole island, tire
    model and Collide included; K1's at n = 1), the plain tire model +
    Collide + make_bundle that feed K3, the plain solve's time, K3's live
    envs and its bound from the work this bundle needs."""
    post, force, motor, bundle = solve_inputs(pre, wheel_on_road, contacts, n)[:4]
    fin, ls_in = fused_world.pack_solve_inputs(post, force, motor)
    ms = graph_ms(lambda: fused_world.launch_solve(fin, ls_in, bundle, n), KERNEL_TIMING_LAUNCHES)
    envs = post.hull_a.shape[0]
    live_envs = int(fused_world.solve_live_envs(bundle, envs).sum())
    fin2, ls_in2 = fused_world.pack_inputs(pre, wheel_on_road)
    k2_ms = graph_ms(lambda: fused_world.launch_contacts(fin2, ls_in2, contacts, n)
                     if n > 1 else fused_world.launch(fin2, ls_in2, envs),
                     KERNEL_TIMING_LAUNCHES)
    collide_ms = cuda_ms(lambda: solve_inputs(pre, wheel_on_road, contacts, n), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_cars, _ = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    n_limit = int((p_cars.limit_state != 0).sum())
    counts = fused_world.solve_island_work(bundle, n)
    flops = fused_world.solve_island_flops(envs * n, n_limit, **counts)
    mm = 0 if bundle is None else bundle.man.normal.shape[1]
    nbytes = fused_world.solve_island_bytes(envs * n, envs * mm)
    flop_ms, byte_ms = 1e3 * flops / PEAK_FP32_FLOPS, 1e3 * nbytes / PEAK_BYTES_PER_S
    out = {"ms": ms, "plain_ms": plain_ms, "bound_ms": max(flop_ms, byte_ms),
           "bound_by": "operations" if flop_ms >= byte_ms else "bytes", "flops": flops,
           "bytes": nbytes, "k2_ms_same_input": k2_ms, "solve_share_of_k2": ms / k2_ms,
           "plain_collide_ms": collide_ms, "live_envs": live_envs}
    island = "K2" if n > 1 else "K1"
    phase(f"K3 {ms:.5f} ms/launch (CUDA graph, {KERNEL_TIMING_LAUNCHES} launches; {live_envs} "
          f"of {envs} envs live); bound {out['bound_ms']:.5f} ms ({flops} fp32 ops = "
          f"{flop_ms:.5f} ms, {nbytes} bytes = {byte_ms:.5f} ms; {n_limit} joints at a limit, "
          f"{counts['n_live_points']} live points, {counts['n_touched_bodies']} touched bodies); "
          f"{island} on the same step {k2_ms:.5f} ms, so the solve is {ms / k2_ms:.1%} of "
          f"{island}; plain tire + Collide + make_bundle {collide_ms:.4f} ms; plain solve "
          f"{plain_ms:.3f} ms")
    return out


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


def track_inputs(cfg, actions, envs: int = E) -> list:
    """K4/K5's inputs at ``envs`` envs of cfg.num_agents cars: (label, the
    track pass's arguments) for the next step of a driven batch that gains
    tiles (at N >= 2 with a second-visitor share), a spawn tick, that tick
    with every wheel lifted 1 km away (each touched tile from the hull-centre
    term alone), and track_cases.cull_cases on the spawn tick's tracks."""
    n = cfg.num_agents
    state, stepped = penv.reset_batch(cfg, SEEDS, envs), None
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
    sp = spawn_batch(cfg, envs, n, state.steps.device)
    base = (sp.track, sp.cars, sp.cars.hull_origin, sp.visited, sp.tile_touched, n)
    lifted = (sp.track, sp.cars.replace(wheel_c=sp.cars.wheel_c + 1000.0)) + base[2:]
    return [stepped, (f"N={n}, a spawn tick", base),
            (f"N={n}, a spawn tick with the wheels lifted away (hull centres only)", lifted)] + [
        (f"N={n}, {name}", (sp.track, cars, post, visited, touched, n))
        for name, (cars, post, visited, touched) in track_cases.cull_cases(sp.track, n).items()]


def track_phase(cfg, actions, envs: int = E) -> dict:
    """K4/K5 against the plain track pass on track_inputs: the track bars,
    two launches bit-identical, and every tile the plain pass marks kept by
    the cull's plain predicate (track_engine.track_candidates). Then, on
    track_cases.cull_probes (the spawn tick's tracks with their centreline
    points moved off the quads), K4/K5 against
    track_engine.track_pass_culled_plain under the same bars, where that
    differs from the full plain pass: the kernel's cull radii are the plain
    predicate's."""
    n = cfg.num_agents
    results = {}
    inputs = track_inputs(cfg, actions, envs)
    for i, (label, args) in enumerate(inputs):
        k = track_engine.track_pass(*args)
        k2 = track_engine.track_pass(*args)
        p = track_engine.track_pass_plain(*args)
        cand = track_engine.track_candidates(*args[:3])
        missed = int((track_engine.plain_marks(*args[:3]) & ~cand).sum())
        torch.cuda.synchronize()
        r = compare_track(k, p, args[0], label)
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        per_car = cand.sum(-1)
        r.update(cand_mean=float(per_car.float().mean()), cand_max=int(per_car.max()),
                 marked_culled=missed)
        phase(f"{label}: two launches bit-identical: {same}; candidates per car mean "
              f"{r['cand_mean']:.4f}, max {r['cand_max']}; marked tiles outside the "
              f"candidates {missed}")
        if not same:
            raise AssertionError(f"{label}: two K4/K5 launches on one input differ")
        if missed:
            raise AssertionError(f"{label}: the cull drops {missed} tiles the plain pass marks")
        if i == 2:                                   # the lifted wheels
            if r["new_tiles"] or r["touched"] < envs:
                raise AssertionError(f"{label}: expected no new tile and a touched tile "
                                     f"under each env's hull centres")
        elif i < 2 and (r["gained"] == 0 or (n >= 2 and r["share"] == 0)):
            raise AssertionError(f"{label}: no env gained a tile"
                                 + ("" if n == 1 else " or no second-visitor share"))
        elif i > 2 and "off-road" not in label and not bool(p[0].any()):
            raise AssertionError(f"{label}: no wheel on the road")
        results[label] = r
    spawn_track = inputs[1][1][0]
    for name, args in track_cases.cull_probes(spawn_track, n).items():
        label, args = f"N={n}, {name}", args + (n,)
        k = track_engine.track_pass(*args)
        k2 = track_engine.track_pass(*args)
        p = track_engine.track_pass_culled_plain(*args)
        full = track_engine.track_pass_plain(*args)
        torch.cuda.synchronize()
        r = compare_track(k, p, args[0], f"{label} (vs the culled plain pass)")
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        dropped = {nm: int((a != b).sum()) for nm, a, b in zip(TRACK_NAMES, p, full)
                   if not torch.equal(a, b)}
        per_car = track_engine.track_candidates(*args[:3]).sum(-1)
        r.update(cand_mean=float(per_car.float().mean()), cand_max=int(per_car.max()),
                 dropped_by_cull=dropped)
        phase(f"{label}: two launches bit-identical: {same}; candidates per car mean "
              f"{r['cand_mean']:.4f}, max {r['cand_max']}; elements where the cull drops a "
              f"mark (culled vs full plain pass) {dropped}")
        if not same:
            raise AssertionError(f"{label}: two K4/K5 launches on one input differ")
        if not dropped:
            raise AssertionError(f"{label}: the probe drops no mark, so it tests nothing")
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


def compare_pixels(cfg, state, label: str) -> dict:
    """K6 against the plain painter on one batch: every byte equal, and two
    launches bit-identical. Prints what the input exercised; raises past
    the bar (equality)."""
    args = pixels.paint_inputs(cfg, state)
    k = pixels.paint_views(*args)
    k2 = pixels.paint_views(*args)
    p = pixels.paint_views_plain(*args)
    torch.cuda.synchronize()
    cam, p8 = args[0], args[3]
    warm = cam[..., 5] > 0
    flag = p8.shape[2] > 4 * cfg.num_agents
    out = {"views": warm.numel(), "warm_views": int(warm.sum()),
           "differing_bytes": int((k != p).sum()),
           "max_abs_err": int((k.int() - p.int()).abs().max()),
           "bit_identical": torch.equal(k, k2),
           "flag_views": int((p8[:, :, -1, 25] > 0).sum()) if flag else 0,
           "mean_active_quads": float(cam[..., 6][~warm].mean()) if bool((~warm).any()) else 0.0}
    phase(f"{label}: {out['views']} views ({out['warm_views']} warm, {out['flag_views']} with "
          f"the backwards flag, {out['mean_active_quads']:.2f} active road slots per steady "
          f"view); bytes differing from the plain painter {out['differing_bytes']}; two "
          f"launches bit-identical: {out['bit_identical']}")
    if out["differing_bytes"] or not out["bit_identical"]:
        raise AssertionError(f"{label}: K6 vs plain {out}")
    return out


def drive(cfg, state, actions, steps: int):
    for t in range(steps):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    return state


def jitter(state, seed: int):
    """The cameras moved by sub-pixel amounts at the steady zoom, from a
    numpy seed, so that edges fall near pixel centres and cell corners: each
    car shifted by up to JITTER_SHIFT world units (half a pixel at the steady
    zoom), its heading and its velocity turned by up to JITTER_TURN rad (half
    a pixel at the window's edge; the view follows the velocity above
    0.5 m/s)."""
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


def mean_candidates(args) -> tuple[float, float]:
    """Mean road and car candidates per 8x8 cell of K6 on these painter
    arguments, from the plain cull predicate (pixels.paint_candidates), in
    chunks of CAND_CHUNK envs."""
    road = cars = 0.0
    views = args[0].shape[0] * args[0].shape[1]
    for e0 in range(0, args[0].shape[0], CAND_CHUNK):
        r, c, _ = pixels.paint_candidates(*(x[e0:e0 + CAND_CHUNK] for x in args))
        road += float(r.sum())
        cars += float(c.sum())
    return road / (views * pixels.CELLS), cars / (views * pixels.CELLS)


def pixel_checks(dev: torch.device, pool) -> dict:
    """Phase 12: K6 against the plain painter on every kind of input the
    pixel paths give it, then on the golden frames."""
    res = {}
    cfg2 = EnvConfig(num_agents=2)
    acts2 = cycled_actions(E, 2, dev)
    spawn = penv.reset_batch(cfg2, SEEDS, E)
    res["N=2 spawn tick"] = r = compare_pixels(cfg2, spawn, f"N=2, E={E}, spawn tick")
    if r["warm_views"] != r["views"]:
        raise AssertionError("the spawn tick's views are not all warm")
    steady = drive(cfg2, spawn, acts2, PIXEL_DRIVE)
    res["N=2 steady"] = r = compare_pixels(cfg2, steady, f"N=2, E={E}, after {PIXEL_DRIVE} "
                                                         f"steps")
    if r["warm_views"]:
        raise AssertionError(f"warm views after {PIXEL_DRIVE} steps")
    mid_t = torch.as_tensor(MID_ZOOM_TS, device=dev)[torch.arange(E, device=dev) % 3]
    res["N=2 mid zoom"] = r = compare_pixels(
        cfg2, steady.replace(t=mid_t), f"N=2, E={E}, mid zoom (a third each at t = "
        f"{', '.join(map(str, MID_ZOOM_TS))} s, on the driven poses)")
    if r["warm_views"] != r["views"]:
        raise AssertionError("the mid-zoom views are not all warm")
    jittered = jitter(steady, JITTER_SEED)
    res["N=2 jitter"] = compare_pixels(
        cfg2, jittered, f"N=2, E={E}, cameras jittered (seed {JITTER_SEED}: cars shifted up to "
        f"{JITTER_SHIFT} world units, turned up to {JITTER_TURN} rad)")
    done = torch.arange(E, device=dev) % 3 == 0
    mixed = penv.reset_done_envs(cfg2, steady.replace(done=done), pool,
                                 torch.Generator(device=dev).manual_seed(1))
    res["N=2 mixed"] = r = compare_pixels(cfg2, mixed, f"N=2, E={E}, after reset_done_envs "
                                                       f"refreshed {int(done.sum())} envs")
    if r["warm_views"] != 2 * int(done.sum()):
        raise AssertionError("the refreshed envs' views are not the warm ones")
    backward = (torch.arange(2 * E, device=dev) % 3 == 1).view(E, 2)
    bwd = mixed.replace(driving_backward=backward)
    res["N=2 backward"] = r = compare_pixels(cfg2, bwd, f"N=2, E={E}, driving_backward in a "
                                                       f"third of the views")
    forward = mixed.replace(driving_backward=torch.zeros_like(backward))
    flagged = (pixels.render_pixels(cfg2, bwd)
               != pixels.render_pixels(cfg2, forward)).flatten(2).any(-1)
    if r["flag_views"] != int(backward.sum()) or not torch.equal(flagged, backward):
        raise AssertionError("the backwards flag is not painted on exactly the backward views")
    cfg1 = EnvConfig(num_agents=1, direction="CW", use_random_direction=False)
    st1 = penv.reset_batch(cfg1, SEEDS, PIXEL_E1)
    res["N=1 CW spawn tick"] = compare_pixels(cfg1, st1, f"N=1 CW, E={PIXEL_E1}, spawn tick")
    st1 = drive(cfg1, st1, cycled_actions(PIXEL_E1, 1, dev), PIXEL_DRIVE)
    res["N=1 CW steady"] = compare_pixels(cfg1, st1, f"N=1 CW, E={PIXEL_E1}, after "
                                                     f"{PIXEL_DRIVE} steps")
    cfg4 = EnvConfig(num_agents=4, use_ego_color=True)
    st4 = penv.reset_batch(cfg4, SEEDS, PIXEL_E4)
    res["N=4 ego spawn tick"] = compare_pixels(cfg4, st4, f"N=4 ego colour, E={PIXEL_E4}, "
                                                          f"spawn tick")
    st4 = drive(cfg4, st4, cycled_actions(PIXEL_E4, 4, dev), PIXEL_DRIVE)
    res["N=4 ego steady"] = compare_pixels(cfg4, st4, f"N=4 ego colour, E={PIXEL_E4}, after "
                                                      f"{PIXEL_DRIVE} steps")
    goldens = {}
    for name in GOLDENS:
        d = np.load(os.path.join(GOLDEN_DIR, name + ".npz"), allow_pickle=False)
        gcfg = EnvConfig(**json.loads(str(d["meta"]))["cfg"])
        gst = convert.env_state_from_leaves([d[f"leaf_{i}"][None] for i in range(52)])
        res[f"golden {name}"] = compare_pixels(gcfg, gst, f"golden {name}")
        img = pobs.pixel_observation_batched(gcfg, gst)[0].cpu().numpy()
        goldens[name] = int((img != d["frame"]).any(-1).sum())
    phase(f"golden frames, pixels differing from the fixture: {goldens}")
    if any(goldens.values()):
        raise AssertionError(f"K6 differs from the golden frames: {goldens}")
    return {"checks": res, "goldens": goldens}


def pixel_main_path(smi: str, dev: torch.device) -> dict:
    """Phase 13: bench.py's pixel workload through the entry points, K6's
    count zeroed just before the reset and read just after the last frame;
    then K6's times and bounds, and the stage table."""
    cfg = EnvConfig(num_agents=2)
    actions = cycled_actions(E, 2, dev)
    fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
    track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
    pixels.paint_views.launches = pixels.paint_views_plain.cuda_calls = 0
    t0 = time.perf_counter()
    state = penv.reset_batch(cfg, SEEDS, E)
    spawn = state
    frame = pobs.pixel_observation_batched(cfg, state)
    for t in range(WARMUP):
        state, r, _ = penv.step(cfg, state, actions[t % 8])
        frame = pobs.pixel_observation_batched(cfg, state)
    float(r.sum())
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    ret = torch.zeros_like(r)
    t0 = time.perf_counter()
    for t in range(T):
        state, r, _ = penv.step(cfg, state, actions[(WARMUP + t) % 8])
        frame = pobs.pixel_observation_batched(cfg, state)
        ret = ret + r
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches, plain_calls = pixels.paint_views.launches, pixels.paint_views_plain.cuda_calls
    island = fused_world.island_step.contact_launches
    if tuple(frame.shape) != (E, 2, 96, 96, 3) or frame.dtype != torch.uint8:
        raise AssertionError(f"frames {tuple(frame.shape)} {frame.dtype}")
    if launches != 1 + WARMUP + T or plain_calls:
        raise AssertionError(f"K6 launched {launches} times (expected {1 + WARMUP + T}), the "
                             f"plain painter ran {plain_calls} times on the card (expected 0)")
    if island != 1 + WARMUP + T or track_engine.track_pass.launches != 1 + WARMUP + T:
        raise AssertionError("the pixel main path's steps did not all go through K2 and K4/K5")
    assert_finite(state)
    road = (frame[..., 0] == frame[..., 1]) & (frame[..., 1] == frame[..., 2]) \
        & (frame[..., 0] >= 102) & (frame[..., 0] <= 107)
    road_share = float(road.float().mean())
    if not 0.02 < road_share < 0.9:
        raise AssertionError(f"road grey covers {road_share:.3f} of the last frames")
    step_ms = 1e3 * elapsed / T
    phase(f"pixel main path: reset + first frame + {WARMUP} steps with frames {warm_s:.3f} s; "
          f"{T} steps with frames in {elapsed:.4f} s = {step_ms:.4f} ms/step, "
          f"{E * T / elapsed:.1f} env-steps/s on {smi}; K6 launches {launches}, plain painter "
          f"calls on the card {plain_calls}; road grey on {road_share:.3f} of the last frames")

    mid = state.replace(t=torch.full_like(state.t, MID_ZOOM_T))
    steady_args = pixels.paint_inputs(cfg, state)
    spawn_args = pixels.paint_inputs(cfg, spawn)
    mid_args = pixels.paint_inputs(cfg, mid)
    ms = cuda_ms(lambda: pixels.paint_views(*steady_args), KERNEL_TIMING_LAUNCHES)
    spawn_ms = cuda_ms(lambda: pixels.paint_views(*spawn_args), KERNEL_TIMING_LAUNCHES)
    mid_ms = cuda_ms(lambda: pixels.paint_views(*mid_args), KERNEL_TIMING_LAUNCHES)
    plain_ms = cuda_ms(lambda: pixels.paint_views_plain(*steady_args), 1)
    out = {"launches": launches, "plain_calls": plain_calls, "step_ms": step_ms,
           "env_steps_per_s": E * T / elapsed, "ms": ms, "spawn_ms": spawn_ms,
           "mid_zoom_ms": mid_ms, "mid_zoom_t": MID_ZOOM_T, "plain_ms": plain_ms}
    for key, st, kms, label in (("", state, ms, "steady"),
                                ("spawn_", spawn, spawn_ms, "spawn tick"),
                                ("mid_zoom_", mid, mid_ms, f"mid zoom (t = {MID_ZOOM_T} s)")):
        nbytes, flops = pixels.paint_work(cfg, st)
        byte_ms, flop_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOPS
        out.update({f"{key}bound_ms": max(byte_ms, flop_ms),
                    f"{key}bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                    f"{key}bytes": nbytes, f"{key}flops": flops})
        phase(f"K6 {label}: {kms:.5f} ms/launch (CUDA events, "
              f"{KERNEL_TIMING_LAUNCHES} launches); bound {max(byte_ms, flop_ms):.5f} ms "
              f"({nbytes} bytes = {byte_ms:.5f} ms, {flops} fp32 ops = {flop_ms:.5f} ms)")
    out["road_candidates_per_cell"], out["car_candidates_per_cell"] = mean_candidates(mid_args)
    out["ptxas"] = _cuda.build_info[pixels.KERNEL]["ptxas"]
    painted = float((mid_args[10].sum(-1) + mid_args[11].sum(-1)).float().mean())
    phase(f"K6 at mid zoom (t = {MID_ZOOM_T} s): {out['road_candidates_per_cell']:.4f} road and "
          f"{out['car_candidates_per_cell']:.4f} car candidates per 8x8 cell (the plain cull "
          f"predicate), of {painted:.1f} painted world quads and {8 * 2 + 4 * 2} car slots per "
          f"view; ptxas: " + " | ".join(out["ptxas"][1:]))
    a0 = actions[0]
    stages = {
        "env.step": cuda_ms(lambda: penv.step(cfg, state, a0), 10),
        "view_inputs": cuda_ms(lambda: pixels.view_inputs(cfg, state), 20),
        "K6 (paint_views), steady": ms,
        f"K6, mid zoom t = {MID_ZOOM_T} s": mid_ms,
        "K6, spawn tick": spawn_ms,
        "pixel_observation_batched": cuda_ms(
            lambda: pobs.pixel_observation_batched(cfg, state), 20),
    }
    out["view_inputs_ms"] = stages["view_inputs"]
    out["stages"] = stages
    phase("pixel step stages (ms, CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()) + f"; plain painter {plain_ms:.3f} ms "
        f"(steady); {step_ms:.4f} ms per step with its frame")
    return out


def pixel_rollout_phase(smi: str, dev: torch.device, pool) -> dict:
    """Phase 14: the env side of learner/ppo.py's pixel rollout at E = 1024,
    N = 2: a frame per decision, PPO_REPEAT steps per decision, chunks of
    PPO_DECISIONS decisions with reset_done_envs between them, past the
    time limit. Counts zeroed just before the first reset."""
    cfg = EnvConfig(num_agents=2)
    gen = torch.Generator(device=dev).manual_seed(0)
    idx, orders, dirs = penv.draw_episodes(cfg, PPO_E, len(POOL_SEEDS), gen)
    fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
    track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
    pixels.paint_views.launches = pixels.paint_views_plain.cuda_calls = 0
    state = penv.reset_from_parts(cfg, tree_map(lambda x: x.index_select(0, idx), pool),
                                  orders, dirs)
    actions = cycled_actions(PPO_E, 2, dev)
    events, warm_counts, limited, resets = [], [], 0, 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for c in range(PPO_CHUNKS):
        for d in range(PPO_DECISIONS):
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            frame = pobs.pixel_observation_batched(cfg, state)
            b.record()
            events.append((a, b))
            warm_counts.append((state.t < 0.999).sum())
            for _ in range(PPO_REPEAT):
                state, _, _ = penv.step(cfg, state, actions[(c * PPO_DECISIONS + d) % 8])
        if c < PPO_CHUNKS - 1:
            limited += int((state.steps >= cfg.max_episode_steps).sum())
            state = penv.reset_done_envs(cfg, state, pool, gen)
            resets += 1
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    steps, frames = PPO_CHUNKS * PPO_DECISIONS * PPO_REPEAT, PPO_CHUNKS * PPO_DECISIONS
    warm = torch.stack(warm_counts).tolist()
    mixed = sum(0 < w < PPO_E for w in warm)
    frame_ms = sum(a.elapsed_time(b) for a, b in events) / PPO_CHUNKS
    counts = {"k6_launches": pixels.paint_views.launches,
              "plain_paint_calls": pixels.paint_views_plain.cuda_calls,
              "contact_launches": fused_world.island_step.contact_launches,
              "track_launches": track_engine.track_pass.launches,
              "k1_launches": fused_world.island_step.launches,
              "plain_track_calls": track_engine.track_pass_plain.cuda_calls}
    want = 1 + steps + resets
    out = {"envs": PPO_E, "chunks": PPO_CHUNKS, "steps": steps, "frames": frames,
           "env_steps_per_s": PPO_E * steps / elapsed, "frame_ms_per_chunk": frame_ms,
           "frames_mixing_warm_and_steady": mixed, "reset_at_limit": limited, **counts}
    phase(f"pixel-PPO env side: {PPO_CHUNKS} chunks of {PPO_DECISIONS} decisions x "
          f"{PPO_REPEAT} steps at E={PPO_E}, N=2 in {elapsed:.3f} s = "
          f"{out['env_steps_per_s']:.1f} env-steps/s on {smi} (frames and resets included); "
          f"frames {frame_ms:.4f} ms per chunk (CUDA events); {mixed} of {frames} frames mix "
          f"warm and steady views; {limited} envs reset at the time limit; launches: K6 "
          f"{counts['k6_launches']} (expected {frames}), K2 {counts['contact_launches']} and "
          f"K4/K5 {counts['track_launches']} (expected {want}), K1 {counts['k1_launches']}, "
          f"plain painter {counts['plain_paint_calls']}, plain track pass "
          f"{counts['plain_track_calls']}")
    if (counts["k6_launches"] != frames or counts["contact_launches"] != want
            or counts["track_launches"] != want or counts["k1_launches"]
            or counts["plain_paint_calls"] or counts["plain_track_calls"]):
        raise AssertionError(f"pixel rollout: launch counts {counts}")
    if tuple(frame.shape) != (PPO_E, 2, 96, 96, 3) or not mixed or not limited:
        raise AssertionError("pixel rollout: wrong frames, no mixed launch or no time limit")
    return out


def report(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
           max_err_over_bar: float, times: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err,
            "max_err_over_bar": max_err_over_bar, **times, "library_ms": None, **extra}


def main() -> int:
    start = time.perf_counter()
    phase("1/19 device")
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

    phase("2/19 build (one nvcc per kernel, started together)")
    t0 = time.perf_counter()
    kernels = (fused_world.KERNEL, fused_world.CONTACT_KERNEL, fused_world.SOLVE_KERNEL,
               track_engine.KERNEL, pixels.KERNEL)
    with ThreadPoolExecutor(len(kernels)) as pool:
        list(pool.map(_cuda.load, kernels))
    fused_world._library(fused_world.KERNEL)
    fused_world._library(fused_world.CONTACT_KERNEL)
    fused_world._library(fused_world.SOLVE_KERNEL)
    track_engine._library()
    pixels._library()
    for name in kernels:
        info = _cuda.build_info[name]
        phase(f"built {name} in {info['seconds']:.2f} s: " + " | ".join(info["ptxas"]))
    phase(f"all kernels loaded {time.perf_counter() - t0:.2f} s after the builds started")
    ptx = {"K1": ptxas_table(fused_world.KERNEL), "K2": ptxas_table(fused_world.CONTACT_KERNEL),
           "K3": ptxas_table(fused_world.SOLVE_KERNEL), "K4/K5": ptxas_table(track_engine.KERNEL)}
    phase("registers and spills: " + "; ".join(
        f"{k} {fn}: {v.get('registers')} registers, {v.get('spill_stores')} B spill stores, "
        f"{v.get('spill_loads')} B spill loads" for k, t in ptx.items() for fn, v in t.items()))

    cfg = EnvConfig(num_agents=1, use_random_direction=False)
    actions = cycled_actions(E, cfg.num_agents, dev)

    phase(f"3/19 K1 vs plain at E={E} after 20 steps")
    state = penv.reset_batch(cfg, SEEDS, E)
    for t in range(20):
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    pre = apply_controls(state.cars, actions[20 % 8])
    pre1, road1 = pre, state.wheel_on_road          # K3 at N = 1 (phase 10) reads it too
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
    fin1, ls1 = fused_world.pack_inputs(pre, state.wheel_on_road)
    k1_phase3_ms = graph_ms(lambda: fused_world.launch(fin1, ls1, E), KERNEL_TIMING_LAUNCHES)
    phase(f"K1 on this input {k1_phase3_ms:.5f} ms/launch (CUDA graph of "
          f"{KERNEL_TIMING_LAUNCHES} launches); "
          f"{ptx['K1'].get('joints_island', {}).get('registers')} registers")

    phase(f"4/19 small input: {len(SMALL_SEEDS)} envs x {SMALL_STEPS} steps, card vs CPU")
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

    phase(f"5/19 N=1 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run1 = main_path(cfg, actions, "N=1", smi)
    times1 = kernel_times(cfg, run1, actions)
    track1 = track_times(cfg, run1, actions)
    k1 = report(fused_world.KERNEL, "multi_car_racing_tpu_torch/csrc/joints_island.cu",
                TPU_KERNEL, run1["launches"], max_abs_err, max_err_over_bar, times1,
                variant="force_no_contacts=True", fuel_spent_abs_err=devs["fuel_spent"][0],
                phase3_ms=k1_phase3_ms, ptxas=ptx["K1"])

    cfg2 = EnvConfig(num_agents=2, use_random_direction=False)
    actions2 = cycled_actions(E, cfg2.num_agents, dev)
    phase(f"6/19 K2 vs plain at N=2, E={E}, driven until {NEAR_SHARE:.0%} of envs are near")
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
    live_mean, live_max = live_rows(pre, 2)
    phase(f"live rows per near env (fused_world.live_routing): mean {live_mean:.4f}, max "
          f"{live_max}")
    far_checks = {"phase 6": far_pass_check(pre, state.wheel_on_road, cs_pre, 2,
                                            "far pass on phase 6's input")}
    k2_phase6 = k2_time_and_bound(pre, state.wheel_on_road, cs_pre, 2)
    phase(f"K2 on this input {k2_phase6['ms']:.5f} ms/launch (CUDA graph); far pass "
          f"{ptx['K2'].get('far_pass', {}).get('registers')} registers, near pass "
          f"{ptx['K2'].get('near_pass', {}).get('registers')}")
    # The all-far input: phase 6's cars with car 1 of every env moved away.
    far_in = (move_car1(pre, torch.tensor([ALL_FAR_SHIFT, 0.0], device=dev).expand(E, 2)),
              state.wheel_on_road, cs_pre)
    far_checks["all-far"] = far_pass_check(*far_in, 2, f"all-far (car 1 moved {ALL_FAR_SHIFT} m)")
    devs_far = compare_contact_step(fused_world.island_step(*far_in),
                                    fused_world.island_step_plain(*far_in), far_in[0], cs_pre,
                                    "K2 vs plain (all-far)")[0]
    # The all-near input: a spawn tick (6 m between a env's cars, none
    # near) with car 1 pulled toward car 0.
    sp = spawn_batch(cfg2, E, 2, dev)
    sp_cars, sp_road, sp_cs = sp.cars, sp.wheel_on_road, sp.contacts
    spawn_near = float(fused_world.near_flags(sp_cars).float().mean())
    near_in = (move_car1(sp_cars, -ALL_NEAR_PULL * (sp_cars.hull_c[:, 1] - sp_cars.hull_c[:, 0])),
               sp_road, sp_cs)
    near_live = live_rows(near_in[0], 2)
    phase(f"spawn tick: near share {spawn_near:.4f}; all-near (car 1 pulled by "
          f"{ALL_NEAR_PULL} of the 6 m): live rows per near env mean {near_live[0]:.4f}, max "
          f"{near_live[1]}")
    far_checks["all-near"] = far_pass_check(*near_in, 2, "all-near")
    if far_checks["all-near"]["near_count"] != E:
        raise AssertionError("the all-near input has far envs")
    devs_near, id_near, skid_near = compare_contact_step(
        fused_world.island_step(*near_in), fused_world.island_step_plain(*near_in), near_in[0],
        sp_cs, "K2 vs plain (all-near)")
    phase(f"all-near: envs whose manifold ids differ {id_near}; skid flags differing {skid_near}")
    if id_near > E // 1000 or skid_near > E // 1000:
        raise AssertionError(f"K2 vs plain (all-near): {id_near} envs' ids, {skid_near} skid "
                             f"flags differ")

    phase("7/19 rear-end ram (N=4, E=1): K2 vs plain at the first step with contact")
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

    phase(f"7/19 (cont.) N=4, E={N4_E}, driven until {NEAR_SHARE:.0%} of envs are near: K2 vs "
          f"plain, the far pass, and K2 beside K3")
    cfg4 = EnvConfig(num_agents=4, use_random_direction=False)
    actions4 = cycled_actions(N4_E, 4, dev)
    state4 = penv.reset_batch(cfg4, SEEDS, N4_E)
    for t4 in range(NEAR_MAX_STEPS + 1):
        pre4 = apply_controls(state4.cars, actions4[t4 % 8])
        near4 = fused_world.near_flags(pre4)
        if t4 == NEAR_MAX_STEPS or (t4 >= 10 and float(near4.float().mean()) >= NEAR_SHARE):
            break
        state4, _, _ = penv.step(cfg4, state4, actions4[t4 % 8])
    in4 = (pre4, state4.wheel_on_road, state4.contacts)
    live4 = live_rows(pre4, 4)
    phase(f"N=4 after {t4} steps: near {float(near4.float().mean()):.4f} of envs "
          f"({int(near4.sum())}); live rows per near env mean {live4[0]:.4f}, max {live4[1]}")
    devs4, id4, skid4 = compare_contact_step(fused_world.island_step(*in4),
                                             fused_world.island_step_plain(*in4), pre4,
                                             in4[2], f"K2 vs plain (N=4, E={N4_E})")
    if id4 > N4_E // 1000 + 1 or skid4 > N4_E // 1000 + 1:
        raise AssertionError(f"K2 vs plain (N=4): {id4} envs' ids, {skid4} skid flags differ")
    far_checks["N=4"] = far_pass_check(*in4, 4, f"far pass at N=4, E={N4_E}")
    times4 = solve_times(*in4, 4)
    pile = piled_cars(dev)
    pile_live = live_rows(pile[0], 4)
    phase(f"four overlapping cars (N=4, E={PILE_ENVS}): live rows per env mean "
          f"{pile_live[0]:.4f}, max {pile_live[1]}")
    if pile_live[1] <= 32:
        raise AssertionError("the overlapping cars have no env past 32 live rows")
    devs_pile, id_pile, _ = compare_contact_step(fused_world.island_step(*pile),
                                                 fused_world.island_step_plain(*pile), pile[0],
                                                 pile[2], "K2 vs plain (N=4, > 32 live rows)")
    phase(f"> 32 live rows: envs whose manifold ids differ {id_pile}")

    phase("8/19 determinism: two K2 launches on phase 6's input")
    fin, ls_in = fused_world.pack_inputs(pre, state.wheel_on_road)
    a = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    b = fused_world.launch_contacts(fin, ls_in, cs_pre, cfg2.num_agents)
    same = all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
        (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
    fin_n, ls_n = fused_world.pack_inputs(near_in[0], near_in[1])
    a = fused_world.launch_contacts(fin_n, ls_n, near_in[2], 2)
    b = fused_world.launch_contacts(fin_n, ls_n, near_in[2], 2)
    same_near = all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
        (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
    phase(f"bit-identical: {same}; on the all-near input ({E} envs listed in the order the "
          f"far pass appended them): {same_near}")
    if not (same and same_near):
        raise AssertionError("two K2 launches on the same input differ")

    # K3's path: world_step_batched on the card, its count set to 0 here and
    # read after phase 11; each call below launches K3 once.
    fused_world.world_step_batched.launches = 0
    phase(f"9/19 K3 vs plain at N=2, E={E}, full {cfg2.velocity_iters}/"
          f"{cfg2.position_iters}, on phase 6's input (plain tire model, Collide, make_bundle)")
    solve2 = solve_inputs(pre, state.wheel_on_road, cs_pre, 2)
    devs3 = compare_solve(solve2, 2, "K3 vs plain (N=2)")

    phase("10/19 K3 vs plain on phase 7's ram (N=4, E=1) and at N=1, E=4096 (no bundle)")
    devs3.update({f"ram {f}": v for f, v in compare_solve(
        solve_inputs(ram_pre, ram.wheel_on_road, ram.contacts, 4), 4,
        "K3 vs plain (ram, N=4)").items()})
    devs3.update({f"N=1 {f}": v for f, v in compare_solve(
        solve_inputs(pre1, road1, None, 1), 1, "K3 vs plain (N=1)").items()})

    phase("11/19 K2 vs plain Collide + K3 on phase 6's input")
    post2, _, _, _, skid2, man2 = solve2
    k3_cars, (k3_ni, k3_ti) = fused_world.world_step_batched(*solve2[:4], 2)
    live_list_check(solve2[3], E, "K3 on phase 6's input")
    k3_out = (k3_cars, skid2, ContactState(normal_imp=k3_ni, tangent_imp=k3_ti, ids=man2.ids))
    devs23, id_miss23, skid_miss23 = compare_contact_step(k_out, k3_out, pre, cs_pre,
                                                          "K2 vs plain Collide + K3")
    phase(f"envs whose manifold ids differ (K2 vs plain Collide): {id_miss23}; skid flags "
          f"differing: {skid_miss23}")
    if id_miss23 > E // 1000 or skid_miss23 > E // 1000:
        raise AssertionError(f"K2 vs plain Collide + K3: {id_miss23} envs' ids, {skid_miss23} "
                             f"skid flags differ")
    k3_launches = fused_world.world_step_batched.launches
    phase(f"K3 launches on its path (phases 9-11): {k3_launches}")
    if k3_launches != 4:
        raise AssertionError(f"K3 launched {k3_launches} times on its path, expected 4")

    phase(f"12/19 K3 determinism and times at N=2, E={E} on phase 6's input, beside K2 on {smi}")
    same3 = []
    for solve_in in (solve2, solve_inputs(*near_in, 2)):
        fin3, ls3 = fused_world.pack_solve_inputs(*solve_in[:3])
        a = fused_world.launch_solve(fin3, ls3, solve_in[3], 2)
        b = fused_world.launch_solve(fin3, ls3, solve_in[3], 2)
        same3.append(all(torch.equal(x, y) for x, y in zip(a, b)))
    near_listed = int(fused_world.launch_solve.live_count)
    phase(f"two K3 launches bit-identical: {same3[0]}; on the all-near input ({near_listed} "
          f"envs listed in the order the list pass appended them): {same3[1]}")
    if not all(same3) or near_listed != E:
        raise AssertionError("two K3 launches on the same input differ, or the all-near input "
                             "has dead envs")
    times3 = solve_times(pre, state.wheel_on_road, cs_pre, 2)
    times3_more = {}
    for name, args in (("all-far", (*far_in, 2)), ("all-near", (*near_in, 2)),
                       ("spawn tick", (sp_cars, sp_road, sp_cs, 2)),
                       ("N=1, no bundle", (pre1, road1, None, 1))):
        phase(f"K3 on the {name} input:")
        times3_more[name] = solve_times(*args)

    phase(f"13/19 N=2 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
          f"warm-up + {T} steps")
    run2 = main_path(cfg2, actions2, "N=2", smi)
    times2 = kernel_times(cfg2, run2, actions2)
    last2 = run2["state"]
    phase("K3 beside K2 on the main path's last input (more envs near than phase 6's):")
    times3_last = solve_times(apply_controls(last2.cars, actions2[(WARMUP + T) % 8]),
                              last2.wheel_on_road, last2.contacts, 2)
    track2 = track_times(cfg2, run2, actions2)
    extra2 = {"all-far": k2_time_and_bound(*far_in, 2), "all-near": k2_time_and_bound(*near_in, 2)}
    phase("K2 on the all-far and all-near inputs: " + "; ".join(
        f"{k} {v['ms']:.5f} ms/launch, bound {v['bound_ms']:.5f} ms ({v['bound_by']}), "
        f"{v['near_envs']} near envs" for k, v in extra2.items()))
    all2 = {**devs2, **{f"ram {f}": v for f, v in devs_ram.items()},
            **{f"{lab} {f}": v for lab, d in (("all-far", devs_far), ("all-near", devs_near),
                                             ("N=4", devs4), ("> 32 rows", devs_pile))
               for f, v in d.items()}}
    k2 = report(fused_world.CONTACT_KERNEL,
                "multi_car_racing_tpu_torch/csrc/contact_island.cu", TPU_KERNEL,
                run2["launches"],
                max(d for f, (d, _, _) in all2.items() if not f.endswith("fuel_spent")),
                max(max(rv, rs) for _, rv, rs in all2.values()), times2,
                variant="full contact", near_share=float(near.float().mean()),
                live_envs=k_live_envs,
                id_miss_envs=id_miss, ram_max_normal_imp=ram_imp,
                launches_per_call="2 (far pass, then near pass)", phase6_ms=k2_phase6["ms"],
                live_rows_per_near_env={"mean": live_mean, "max": live_max},
                far_pass_checks=far_checks,
                **{f"{k.replace('-', '_')}_{f}": v[f] for k, v in extra2.items()
                   for f in ("ms", "bound_ms", "bound_by", "near_envs")},
                n4_e1024={"ms": times4["k2_ms_same_input"], "k3_ms": times4["ms"],
                          "solve_share_of_k2": times4["solve_share_of_k2"]},
                over_32_rows={"max_live_rows": pile_live[1], "id_miss_envs": id_pile,
                              "max_err_over_bar": max(max(rv, rs)
                                                      for _, rv, rs in devs_pile.values())},
                ptxas=ptx["K2"])

    phase(f"14/19 K4/K5 vs plain at E={E}, N=1 and N=2, and E={N4_E}, N=4: a stepped state, "
          f"a spawn tick, lifted wheels, and the cull's edges (on-road, seam, kerb, off-road, "
          f"self-approach, wheels-only); the cull's probes (wheels only, origins only)")
    checks = {**track_phase(cfg, actions), **track_phase(cfg2, actions2),
              **track_phase(cfg4, actions4, N4_E)}
    worst = max(r["bonus_err"] for r in checks.values())
    k45 = report(track_engine.KERNEL, "multi_car_racing_tpu_torch/csrc/track_pass.cu",
                 TRACK_TPU_KERNEL, run2["track_launches"], worst, worst / BONUS_TOL, track2,
                 variant="v1 and v2 (one kernel)", also_replaces=TRACK_TPU_KERNEL_V2,
                 main_path="N=2", launches_n1=run1["track_launches"],
                 **{f"{k}_n1": v for k, v in track1.items()},
                 ptxas=ptx["K4/K5"],
                 checks={k: {"gained": r["gained"], "second_visitor_shares": r["share"],
                             "cand_mean": r["cand_mean"], "cand_max": r["cand_max"]}
                         for k, r in checks.items()})

    phase(f"15/19 state-PPO rollout: E={E}, N={ROLLOUT_N}, pool of {len(POOL_SEEDS)} host "
          f"tracks, chunks of {ROLLOUT_CHUNK} steps, past the time limit")
    rollout = rollout_phase(smi, dev)

    phase("16/19 K6 vs plain: N=2 spawn tick, steady, mid zoom, camera jitter, mixed and "
          "backward at E=4096; N=1 CW; N=4 ego colour; the golden frames")
    pool = penv.make_track_pool(EnvConfig(num_agents=2), POOL_SEEDS, device=dev)
    t16 = time.perf_counter()
    px_checks = pixel_checks(dev, pool)
    phase(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    phase(f"17/19 pixel main path: reset_batch E={E}, N=2 + {WARMUP} warm-up + {T} steps, a "
          f"frame after the reset and after every step")
    t17 = time.perf_counter()
    px_run = pixel_main_path(smi, dev)
    phase(f"phase 17 took {time.perf_counter() - t17:.1f} s")

    phase(f"18/19 pixel-PPO env side: E={PPO_E}, N=2, {PPO_CHUNKS} chunks of {PPO_DECISIONS} "
          f"decisions x {PPO_REPEAT} steps, autoreset, past the time limit")
    px_rollout = pixel_rollout_phase(smi, dev, pool)
    k6 = report(pixels.KERNEL, "multi_car_racing_tpu_torch/csrc/paint_view.cu",
                PAINT_TPU_KERNEL, px_run["launches"],
                float(max(r["max_abs_err"] for r in px_checks["checks"].values())),
                0.0,  # the bar is equality: compare_pixels raised on any differing byte
                {k: px_run[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                differing_bytes=sum(r["differing_bytes"] for r in px_checks["checks"].values()),
                main_path=f"E={E}, N=2, a frame per step", spawn_ms=px_run["spawn_ms"],
                spawn_bound_ms=px_run["spawn_bound_ms"], spawn_bound_by=px_run["spawn_bound_by"],
                mid_zoom_ms=px_run["mid_zoom_ms"], mid_zoom_t=px_run["mid_zoom_t"],
                mid_zoom_bound_ms=px_run["mid_zoom_bound_ms"],
                mid_zoom_bound_by=px_run["mid_zoom_bound_by"],
                mid_zoom_road_candidates_per_cell=px_run["road_candidates_per_cell"],
                mid_zoom_car_candidates_per_cell=px_run["car_candidates_per_cell"],
                ptxas=px_run["ptxas"],
                view_inputs_ms=px_run["view_inputs_ms"], launches_pixel_ppo=px_rollout[
                    "k6_launches"],
                checks={k: {"views": r["views"], "warm_views": r["warm_views"],
                            "flag_views": r["flag_views"]}
                        for k, r in px_checks["checks"].items()})

    k3 = report(fused_world.SOLVE_KERNEL, "multi_car_racing_tpu_torch/csrc/solve_island.cu",
                SOLVE_TPU_KERNEL, k3_launches,
                max(d for f, (d, _, _) in devs3.items() if not f.endswith("fuel_spent")),
                max(max(rv, rs) for _, rv, rs in devs3.values()),
                {k: times3[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
                main_path="world_step_batched (phases 9-11)",
                launches_env_step=run2["solve_launches"],
                k2_ms_same_input=times3["k2_ms_same_input"],
                solve_share_of_k2=times3["solve_share_of_k2"],
                plain_collide_ms=times3["plain_collide_ms"],
                **{f"{k}_main_path_last_input": times3_last[k] for k in
                   ("ms", "bound_ms", "k2_ms_same_input", "solve_share_of_k2")},
                k2_vs_collide_k3_max_err_over_bar=max(max(rv, rs) for _, rv, rs in
                                                      devs23.values()),
                k2_vs_collide_k3_id_miss_envs=id_miss23,
                **{f"{k}_n4_e1024": times4[k] for k in
                   ("ms", "bound_ms", "k2_ms_same_input", "solve_share_of_k2")},
                launches_per_call="2 (list pass, then solve pass); 1 without a bundle",
                live_envs=times3["live_envs"],
                live_envs_main_path_last_input=times3_last["live_envs"],
                more_inputs={name: {k: t[k] for k in ("ms", "bound_ms", "bound_by", "plain_ms",
                                                      "k2_ms_same_input", "live_envs")}
                             for name, t in times3_more.items()},
                ptxas=ptx["K3"])
    phase(f"19/19 report: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"kernels": [k1, k2, k3, k45, k6], "rollout": rollout,
                      "pixel_main_path": {k: v for k, v in px_run.items()},
                      "pixel_rollout": px_rollout}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
