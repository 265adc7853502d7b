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

The learner's paths (phases 19-22) run those kernels through the env's
entry points: the four committed policies evaluated on the card (K1 at
N = 1, K2 at N = 2, K4/K5 on every step, K6 on every pixel-policy step) and
three PPO train steps at each recipe's shape, with a checkpoint saved and
restored on the card. No learner module has a kernel of its own: the JAX
learner is XLA, so the network and the updates are plain torch ops. Their
tracks, and the batched facade's (phases 27-29: ``VectorMultiCarRacing``
runs K1 or K2 and K4/K5 on every step, K6 on every pixel frame), are
generated on the card by ``track/device.py``, plain torch ops as JAX's is
XLA. Phase 30 drives K2 and K3 past N = 9, where a warp's arrays move from
shared memory to a global scratch buffer, and past N = 32, where a lane of
their warps carries two cars; phase 34 drives K4/K5 and K6 there and
``gym_api.make("MultiCarRacing-v0", num_agents=33)``. Phases 31-32 run the learner data
parallel (``parallel/mesh.py``): a world of one over NCCL, and two ranks
sharing the card over gloo, each launching K1, or K2, K4/K5 and K6, on its
rows of the env batch; phase 33 runs ``demo.py``. Phase 36 builds the
native host track generator that every host reset uses and drives the
track follower closed-loop through K2 and K4/K5 (``oracle/episodes.py``).

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
 19. the learner's network: each of the four committed policies
     (learner/policies) on the card -- cuDNN's bf16 convolutions for the
     pixel torso -- against the same policy on the CPU, on the observations
     of 64 cars driven 20 steps on the card; 1e-5 * max(1, |x|) for the
     state nets, 1e-2 * max(1, max|CPU|) on mean and value for the pixel
     nets (tests/test_torch_networks.py's bars)
 20. the learner's evaluation: each committed policy deterministically over
     100 fresh episodes on tracks generated on the card (seed 7) through
     learner/evaluate.py; fails when its mean misses the recorded one by more than
     2.58 * sqrt((sigma_rec^2 + sigma_port^2) / 100); mean, std, min, max,
     best agent, tile fraction, length, the three worst episodes, wall
     seconds, env-steps/s and the network's forward ms at E * N rows; each
     evaluation's counts (zeroed after its reset) equal 1000 island and
     K4/K5 launches and one K6 launch per policy step for the pixel policies
 21. PPO at the pixel recipe's shape (multi2px: N = 2, E = 1024, T = 32,
     R = 4, K = 2, squash, lr 1e-4, kl_target 0.03, grass 0.5, skip 2.0,
     anneal, 4 epochs x 8 minibatches): three train steps from a fresh
     learner; every metric finite, the parameters moved, K2 = K4/K5 = 3 *
     (128 steps + the autoreset tick), K6 = 3 * 33 frames; rollout, GAE,
     update and reset times (CUDA events), env-steps/s with the learner;
     then checkpoint.save and restore on the card, every tensor equal
 22. PPO at the state recipe's shape (CarRacing-v0, E = 1024, T = 32, R = 4,
     normalize, width 512, the same shaping): as phase 21, with K1
 23. the Gym facade (gym_api.make) on the card, MultiCarRacing-v0 (K2) and
     CarRacing-v0 (K1): reset with a seed, 100 steps of cycled actions
     through step(); launches (zeroed after the reset) exactly one island,
     one K4/K5 and one K6 per step and no other; every 25th observation, the
     reset's and the last byte-equal to the plain painter on the card;
     facade steps per second
 24. the 600x400 rgb_array painter (render.raster.render_observation, plain
     torch ops: JAX paints it with XLA, not Pallas): the rgb_array_skid
     golden state's frame with skid trails byte-equal to the fixture (0
     differing pixels), ms per frame; a CarRacing-v0 facade launched 30
     steps and braked 5: its skid segments counted, its frame byte-equal to
     the same state's on the CPU, trail pixels counted, a warm frame timed
 25. monitor.Monitor around a CarRacing-v0 facade: one 10-step episode cut
     by the TimeLimit; stats.json, and a video when an encoder is installed
 26. python -m multi_car_racing_tpu_torch.train as a subprocess: 3 updates
     at CarRacing-v0, E = 256, an 8-episode evaluation, a checkpoint and a
     JSONL log, then --resume for one more update (train.main in this
     process); every row finite, the updates 1, 2, 3 (+ the eval row), 4;
     scripts/curve.py reads the log
 27. tracks generated on the card (track/device.py, plain torch ops: JAX
     leaves the generator to XLA): a checked pool of 32 and device_reset at
     E = 4096, N = 2, each timed; every track ok and structurally sound
     (tests/test_track_device.py's checks); the reset's spawn tick one K2
     and one K4/K5 launch; one attempt of 32 tracks from uniforms drawn on
     the card against the same uniforms through the plain run on the CPU:
     ok flags and tile counts equal, centre points within 2e-2, headings
     within 2e-3, curb flags differing on under 2% of tiles
 28. gym_api.VectorMultiCarRacing at E = 4096, N = 2, obs="pixels", a
     20-step time limit, 30 steps of cycled actions: autoreset inside the
     phase; counts zeroed before its reset: K2 and K4/K5 once per reset
     tick, step and autoreset tick, K6 once per frame, nothing else;
     steps/s with the numpy outputs
 29. the same at N = 1, obs="state" (K1), and at N = 2, obs="none"
 30. K2 and K3 past N = 9, where a warp's arrays (244,936 bytes at N = 10)
     leave the block's shared memory for a global scratch buffer: at N = 6
     and 8 (shared layout; its bytes are held against the parent's by
     compare_parent.py) the scratch layout forced onto 7 slots within the
     plain versions' bars; at N = 10 and 12, E = 64: reset and drive on the
     card to a quarter of the envs near and a contact (K2 and K4/K5
     counted), K2 against
     the plain island on the all-near spawn tick and the driven state, K3
     against world.world_step on the driven state (the island bars; near
     envs, live contacts), the wrapper's scratch slots byte-equal to 7
     slots, two launches bit-identical, K2's and K3's ms and bounds; the
     same at N = 33 and 64 (PAST_WARP_NS: each lane carries two cars), with
     the plain island's ms, and K2 and K3 against plain on 8 envs of piled
     groups of four cars at rest (hundreds of live rows an env, past row
     2^16 at N = 64)
 31. a world of one over NCCL (parallel/mesh.py's init in this process,
     a process group on 127.0.0.1): the state recipe's learner (phase 22's
     shape) from one start, DP_UPDATES = 2 updates run twice without a
     world and once in the world (every collective of the sharded step on
     one rank): the world's metrics and learner bytes (parameters, Adam's
     moments and count, obs_rms, the generator's state) equal the plain
     runs' wherever those repeat each other byte for byte, else its metrics
     within 1e-4 * max(1, |x|); K1 and K4/K5 once per step and reset tick
 32. two ranks sharing the card over gloo (this script as two processes,
     ``--rank-drill``): at the state recipe (K1, rows 512 + 512) one
     update, whose metrics match phase 31's one-process update 1 within
     1e-4 * max(1, |x|); at the pixel recipe (phase 21's shape: K2, K4/K5
     and K6 on each rank's 512 rows) two updates and a collective
     checkpoint. After every update the learner's hash is equal on both
     ranks and every metric finite and equal; each rank's counts equal its
     steps and frames. No metric bar across layouts at the pixel recipe:
     cuDNN's bf16 convolutions may pick other algorithms at 512 rows. The
     checkpoint restored in this process equals the ranks' rows joined,
     and hashes as their learner. Each rank's env-steps/s
 33. demo.py on the card: 50 steps of the track follower at N = 2 through
     the facade, a GIF written through Pillow; counts zeroed before it:
     K2 and K4/K5 once per step and for the reset's spawn tick, K6 once per
     frame (the reset's and each step's)
 34. past 32 cars an env: on phase 30's driven states at N = 33 and 64
     (E = 64), K4/K5 against the plain track pass (track bars, two launches
     bit-identical) and K6 against the plain painter on the warm views and 2
     s later (byte for byte), each with its ms (graph_ms), plain ms and
     bound; then MultiCarRacing-v0 with num_agents = 33 through the facade
     on the card, a reset and 20 steps with pixels (counts zeroed after the
     reset: K2, K4/K5 and K6 once a step, nothing else), the last
     observation against the plain painter
 35. the learner JSON line, the facade JSON line, the generation JSON line
     (phases 27-30 and 34), the data-parallel JSON line (phases 31-33), the
     phase-36 JSON line, the kernels JSON line (K2, K3, K4/K5 and K6 with
     their N = 33 and 64 times under ``past_32_cars``), the nvidia-smi line,
     and the result line
 36. (runs before phase 35's lines) the native host track generator
     (native.py, csrc/trackgen.cpp, built with g++ on this machine): 16
     tracks of seeds 16-23, two from each stream, bit-equal to the Python
     walk with their retries, and the next 16 draws of each stream equal;
     env.reset_batch takes its tracks from it (native.generate_track.calls).
     Then oracle/episodes.run_episodes_closed: the track follower at N = 2,
     E = 8 (seeds 100-103, both directions), 200 steps on the card, counts
     zeroed before its reset: K2 = K4/K5 = 201 (the spawn tick and the
     steps), nothing else; every car finite; the plain path on the CPU on
     the same actions (run_episodes_open): rewards within 2e-5 per step
     before each env's first car-car contact in either run

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from multi_car_racing_tpu_torch import EnvConfig, _cuda, checkpoint, convert  # noqa: E402
from multi_car_racing_tpu_torch import config as C  # noqa: E402
from multi_car_racing_tpu_torch.learner import evaluate, ppo as lppo  # noqa: E402
from multi_car_racing_tpu_torch import env as penv, obs as pobs, seeding  # noqa: E402
from multi_car_racing_tpu_torch import demo, gym_api, monitor, native, train  # noqa: E402
from multi_car_racing_tpu_torch.oracle import episodes as oep  # noqa: E402
from multi_car_racing_tpu_torch.parallel import mesh  # noqa: E402
from multi_car_racing_tpu_torch.render import pixels, raster  # noqa: E402
from multi_car_racing_tpu_torch.physics import collide, fused_world  # noqa: E402
from multi_car_racing_tpu_torch.physics import tire, track_cases, track_engine  # noqa: E402
from multi_car_racing_tpu_torch.physics import world  # noqa: E402
from multi_car_racing_tpu_torch.physics.collide import ContactState  # noqa: E402
from multi_car_racing_tpu_torch.physics.state import apply_controls, create_cars  # noqa: E402
from multi_car_racing_tpu_torch.track import device as tdev, host as thost  # noqa: E402
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
PILE_GAP = 25.0                 # metres between piled groups past 32 cars (phase 30)
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
LEARNER_SEED = 7                # the recorded evaluations' seed
LEARNER_EPISODES = 100
LEARNER_Z = 2.58                # two-sided 99% bound on the difference of two means
LEARNER_NET_OBS = 64            # cars observed per policy in phase 19
LEARNER_DRIVE = 20              # steps driven before phase 19's observations
LEARNER_STATE_TOL = 1e-5        # tests/test_torch_networks.py's bars
LEARNER_PIXEL_TOL = 1e-2
LEARNER_UPDATES = 3
LEARNER_WORST = 3               # the lowest-return episodes of each evaluation, reported
POLICY_NAMES = ("carracing_v0_solved", "pixels_solved", "multi2p", "multi2px")
CKPT_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multi_car_racing_tpu_torch",
                        "_build", "chip_smoke_checkpoints")
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", "fixtures",
                          "golden")
GOLDENS = ("steady_2agent", "warmup_2agent", "cw_1agent", "egocolor_4agent",
           "backwards_flag")
# Phases 23-26: the user entry points.
FACADE_STEPS = 100              # facade steps per env id (cycled actions)
FACADE_CHECK_EVERY = 25         # every 25th observation held against the plain painter
FACADE_LAUNCH_STEPS = 30        # gas steps before the braking frame
FACADE_BRAKE_STEPS = 5
TRACE_STEPS = 10                # facade steps (and frames) in each torch.profiler trace
MONITOR_STEPS = 10
SMOKE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multi_car_racing_tpu_torch",
                         "_build", "chip_smoke_entry_points")
TRAIN_ARGS = ("--carracing-v0", "--obs", "state", "--num-envs", "256", "--eval-every", "3",
              "--eval-episodes", "8", "--seed", "7")
# Phase 14: learner/ppo.py's pixel rollout at the multi2px shape.
PPO_E = 1024
PPO_DECISIONS = 32              # decisions per chunk
PPO_REPEAT = 4                  # physics steps per decision
PPO_CHUNKS = 9                  # 9 * 128 = 1152 steps, past the 1000-step limit
# Phases 27-29: tracks generated on the card, and the batched facade.
GEN_POOL, GEN_SEED = 32, 5      # the checked pool's size (VectorMultiCarRacing's default)
VEC_SEED = 9
VEC_LIMIT, VEC_STEPS = 20, 30   # the facade's time limit and steps: the autoreset fires
# Phase 30: K2 and K3 past N = 9, where a warp's arrays (196,252 bytes at
# N = 9, 244,936 at N = 10) leave the H100's 232,448 bytes of shared memory a
# block for a global scratch buffer, and past N = 32; phase 34 past N = 32.
NARROW_NS = (6, 8)              # shared layout, held byte-equal to the scratch layout
WIDE_NS = (10, 12)
PAST_WARP_NS = (33, 64)         # past one car a lane: a lane of K2's and K3's warps carries two
WIDE_E = 64
PAST_WARP_FACADE_STEPS = 20     # MultiCarRacing-v0 steps with pixels at num_agents=33
WIDE_NEAR_SHARE = 0.25          # drive until this share of the envs is near, and a contact
WIDE_MAX_STEPS = 400
SCRATCH_SLOTS = 7               # forced scratch slots: each warp loops over ~9 of 64 envs
# Phases 31-33: data parallelism (parallel/mesh.py) and the demo.
DP_UPDATES = 2                  # updates per run of phases 31 and 32
DP_RANKS = 2                    # phase 32's ranks, sharing the one card over gloo
DP_TIMEOUT = 600                # seconds phase 32 waits for its ranks
DP_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "multi_car_racing_tpu_torch",
                      "_build", "chip_smoke_ranks")
DP_METRIC_TOL = 1e-4            # tests/test_torch_multiprocess.py's bar on a metric
DEMO_STEPS = 50
# Phase 36: the native host track generator and a closed-loop follower run.
TRACKGEN_SEEDS = tuple(range(16, 24))   # 16, 17, 20 and 23 retry
FOLLOW_E, FOLLOW_N, FOLLOW_STEPS = 8, 2, 200
FOLLOW_RESETS = tuple((100 + s, 200 + s, d) for d in ("CCW", "CW")
                      for s in range(FOLLOW_E // 2))


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


def device_trace(fn, reps: int) -> dict:
    """Runs ``fn()`` ``reps`` times under torch.profiler (CUDA activity) and
    reads the trace, per call: the host's wall ms (to a synchronise after
    the last call), the card's busy ms (the union of its kernel, memcpy and
    memset intervals), the idle share 1 - busy / wall of the traced run, and
    the kernels, copies and memsets on the card. Busy ms and the counts are
    None where the trace holds no device event."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # The raw Kineto events: prof.events() builds a Python object per event
    # (~75 us each), seconds for a 600x400 frame's ~20k launches.
    spans, kinds = [], {"kernels": 0, "memcpy": 0, "memset": 0}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() != DeviceType.CUDA:
            continue
        spans.append((ev.start_ns(), ev.start_ns() + ev.duration_ns()))
        name = ev.name()
        kind = ("memcpy" if name.startswith("Memcpy") else
                "memset" if name.startswith("Memset") else "kernels")
        kinds[kind] += 1
    busy_ns, end = 0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy_ns, end = busy_ns + (b - a), b
        elif b > end:
            busy_ns, end = busy_ns + (b - end), b
    out = {"reps": reps, "wall_ms": wall_ms / reps}
    if not spans:
        return {**out, "busy_ms": None, "idle_share": None,
                **{k: None for k in kinds}}
    return {**out, "busy_ms": busy_ns / 1e6 / reps, "idle_share": 1.0 - busy_ns / 1e6 / wall_ms,
            **{k: v / reps for k, v in kinds.items()}}


def trace_line(label: str, tr: dict) -> str:
    if tr["busy_ms"] is None:
        return f"{label}: {tr['wall_ms']:.4f} ms each, no device event in the trace"
    return (f"{label}: {tr['wall_ms']:.4f} ms each under the profiler, card busy "
            f"{tr['busy_ms']:.4f} ms (idle share {tr['idle_share']:.4f}); {tr['kernels']:g} "
            f"kernels, {tr['memcpy']:g} copies, {tr['memset']:g} memsets each")


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
            if words and "ILb1ELb1E" in words[0]:   # past 32 cars: a lane carries several
                cur += "_scratch_wide"
            elif words and "ILb1E" in words[0]:     # the global-scratch instance of a template
                cur += "_scratch"
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
    pool = penv.make_host_track_pool(cfg, SEEDS, device=dev)
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


def piled_groups(n: int, device):
    """PILE_ENVS envs of ``n`` cars at rest in groups of four (the last one
    short at odd N), PILE_GAP m apart, each group piled as piled_cars piles
    its four (numpy seed PILE_SEED + n): every env holds more than 32 live
    manifold rows a group, the cars of a lane (c, c + 32) touch in
    different groups, and at N = 64 live rows lie past row 2^16. Returns
    the island's inputs (cars, wheel_on_road, contact carry)."""
    rng = np.random.RandomState(PILE_SEED + n)
    g, k = np.arange(n) // 4, np.arange(n) % 4
    c = k * (np.pi / 2)
    pos = (rng.uniform(-300, 300, (PILE_ENVS, 1, 2))
           + np.stack([PILE_GAP * g, np.zeros(n)], -1)[None]
           + PILE_STEP * np.stack([np.cos(c), np.sin(c)], -1)[None])
    ang = rng.uniform(-np.pi, np.pi, (PILE_ENVS, int(g[-1]) + 1))[:, g] + PILE_TURN * k[None]
    cars = create_cars(torch.as_tensor(pos, dtype=torch.float32, device=device),
                       torch.as_tensor(ang, dtype=torch.float32, device=device))
    return (cars, torch.ones((PILE_ENVS, n, 4), dtype=torch.bool, device=device),
            collide.init_contact_state(PILE_ENVS, n, device=device))


def pile_checks(n: int, dev: torch.device) -> dict:
    """K2 against the plain island and K3 against world.world_step on
    piled_groups at ``n`` cars (the wide instances' contact solve over
    hundreds of live rows an env), two launches of K2 bit-identical."""
    ins = piled_groups(n, dev)
    ok = collide.collide(ins[0], n).point_ok.any(-1)                  # (E, MM)
    rows = ok.sum(1)
    last = int(ok.nonzero()[:, 1].max())
    devs, id_miss, skid_miss = compare_contact_step(
        fused_world.island_step(*ins), fused_world.island_step_plain(*ins), ins[0], ins[2],
        f"K2 vs plain (N={n}, piled groups)")
    # At rest the velocity passes add no impulse; the position passes push
    # the groups apart (compare_solve would ask for a normal impulse).
    post, force, motor, bundle = solve_inputs(*ins, n)[:4]
    k_cars, k_imp = fused_world.world_step_batched(post, force, motor, bundle, n)
    p_cars, p_bundle = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    d3 = compare_cars(k_cars, p_cars, post, f"K3 vs plain (N={n}, piled groups)")
    d3.update(compare_fields(
        {"normal_imp": k_imp[0], "tangent_imp": k_imp[1]},
        {"normal_imp": p_bundle.normal_imp, "tangent_imp": p_bundle.tangent_imp},
        {"normal_imp": bundle.normal_imp, "tangent_imp": bundle.tangent_imp},
        f"K3 vs plain (N={n}, piled groups)"))
    fin, ls_in = fused_world.pack_inputs(ins[0], ins[1])
    a, b = (fused_world.launch_contacts(fin, ls_in, ins[2], n) for _ in range(2))
    same = all(torch.equal(x, y) for x, y in zip(
        (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
        (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
    out = {"live_rows_min": int(rows.min()), "live_rows_max": int(rows.max()),
           "last_live_row": last, "id_miss_envs": id_miss, "skid_miss": skid_miss,
           "two_launches_identical": same,
           "max_err_over_bar": max(max(rv, rs) for d in (devs, d3) for _, rv, rs in d.values())}
    phase(f"N={n}, {PILE_ENVS} envs of piled groups: live rows an env {out['live_rows_min']}-"
          f"{out['live_rows_max']}, the last live row {last}; ids differing in {id_miss} envs, "
          f"skid flags {skid_miss}; two K2 launches bit-identical {same}")
    if id_miss > 1 or skid_miss > 1 or not same or int(rows.min()) <= 32:
        raise AssertionError(f"N={n}, piled groups: {out}")
    return out


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


def compare_solve(inputs, n: int, label: str, plain_out: dict | None = None) -> dict:
    """K3 (``world_step_batched`` on the card) against the plain
    ``world.world_step`` on the same card tensors and bundle: every CarState
    field and, with a bundle, both impulses within both bars (the step's
    change taken from K3's input), limit states equal. Fails if a bundle
    gives no env a live contact. ``plain_out``, if given, receives the plain
    solve's results and ms ("cars", "bundle", "ms")."""
    post, force, motor, bundle = inputs[:4]
    k_cars, k_imp = fused_world.world_step_batched(post, force, motor, bundle, n)
    live_list_check(bundle, post.hull_a.shape[0], label)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p_cars, p_bundle = world.world_step(post, force, motor, contacts=bundle)
    torch.cuda.synchronize()
    if plain_out is not None:
        plain_out.update(cars=p_cars, bundle=p_bundle, ms=1e3 * (time.perf_counter() - t0))
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


def solve_times(pre, wheel_on_road, contacts, n: int, plain: dict | None = None) -> dict:
    """On one step's input: K3's time per launch (graph_ms over the bare
    launch on packed inputs, both its kernels), K2's (the whole island, tire
    model and Collide included; K1's at n = 1), the plain tire model +
    Collide + make_bundle that feed K3, the plain solve's time (taken from
    ``plain``, compare_solve's ``plain_out`` on the same input, if given),
    K3's live envs and its bound from the work this bundle needs."""
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
    if plain is None:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        p_cars, _ = world.world_step(post, force, motor, contacts=bundle)
        torch.cuda.synchronize()
        plain = {"cars": p_cars, "ms": 1e3 * (time.perf_counter() - t0)}
    p_cars, plain_ms = plain["cars"], plain["ms"]
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
    pool = penv.make_host_track_pool(cfg, POOL_SEEDS, device=dev)
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
    launches bit-identical, with the plain painter's ms. Prints what the
    input exercised; raises past the bar (equality)."""
    args = pixels.paint_inputs(cfg, state)
    k = pixels.paint_views(*args)
    k2 = pixels.paint_views(*args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = pixels.paint_views_plain(*args)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    cam, p8 = args[0], args[3]
    warm = cam[..., 5] > 0
    flag = p8.shape[2] > 4 * cfg.num_agents
    out = {"views": warm.numel(), "warm_views": int(warm.sum()),
           "differing_bytes": int((k != p).sum()),
           "max_abs_err": int((k.int() - p.int()).abs().max()),
           "bit_identical": torch.equal(k, k2),
           "flag_views": int((p8[:, :, -1, 25] > 0).sum()) if flag else 0,
           "mean_active_quads": float(cam[..., 6][~warm].mean()) if bool((~warm).any()) else 0.0}
    out["plain_ms"] = plain_ms
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


def track_structure(tracks, label: str) -> dict:
    """tests/test_track_device.py's structural checks on every track of a
    batch: 200 <= tiles <= max_tiles, valid tiles = n_tiles, centre points
    finite and inside the playfield, 10 < curb tiles < n_tiles, and the loop
    closed as the generator closes it (mcr:283-291: the gap between the
    last and the first point, each axis weighted by the first tile's
    direction, at most one detail step). The plain distance of that gap is
    reported (JAX's test holds it under three detail steps on its 8 tracks;
    the weighted test lets an axis the first tile barely weighs open
    further)."""
    n = tracks.n_tiles.long()
    mt = tracks.max_tiles
    first = tracks.xy[:, 0]
    last = torch.gather(tracks.xy, 1, (n - 1)[:, None, None].expand(-1, 1, 2))[:, 0]
    b0 = tracks.beta[:, 0]
    glue = torch.sqrt(torch.square(torch.cos(b0) * (first[:, 0] - last[:, 0]))
                      + torch.square(torch.sin(b0) * (first[:, 1] - last[:, 1])))
    gap = (first - last).norm(dim=-1) / C.TRACK_DETAIL_STEP
    inside = torch.arange(mt, device=n.device)[None] < n[:, None]
    xy_ok = (torch.isfinite(tracks.xy).all(-1) & (tracks.xy.abs() < C.PLAYFIELD).all(-1)) | ~inside
    curbs = tracks.has_curb.sum(1)
    checks = {"tiles_in_range": bool(((n >= 200) & (n <= mt)).all()),
              "valid_is_n_tiles": bool((tracks.valid.sum(1) == n).all()),
              "inside_playfield": bool(xy_ok.all()),
              "closed": bool((glue <= C.TRACK_DETAIL_STEP * (1 + 1e-5)).all()),
              "curbs": bool(((curbs > 10) & (curbs < n)).all())}
    wide = (gap >= 3).nonzero().flatten()
    out = {"tracks": int(n.numel()), "mean_tiles": float(n.float().mean()),
           "min_tiles": int(n.min()), "max_tiles": int(n.max()), **checks,
           "max_gap_in_steps": float(gap.max()), "gaps_of_3_steps_or_more": int(wide.numel()),
           "first_heading_of_those": [float(b0[i]) for i in wide[:8].tolist()]}
    phase(f"{label}: {out['tracks']} tracks, tiles mean {out['mean_tiles']:.2f} (min "
          f"{out['min_tiles']}, max {out['max_tiles']}); structure {checks}; the closing gap "
          f"at most {out['max_gap_in_steps']:.3f} detail steps, {int(wide.numel())} tracks at 3 "
          f"or more (first headings {out['first_heading_of_those']})")
    if not all(checks.values()):
        raise AssertionError(f"{label}: a track fails the structural checks {checks}")
    return out


def generation_phase(smi: str, dev: torch.device) -> dict:
    """Phase 27: tracks generated on the card (track/device.py, plain torch
    ops: JAX leaves it to XLA). A checked pool of GEN_POOL and device_reset
    at E = 4096, N = 2, each timed (host clock, synchronised), each track
    ok and structurally sound, the reset's spawn tick one K2 and one K4/K5
    launch (counts zeroed just before); then one attempt on GEN_POOL
    uniforms drawn on the card, held against the same uniforms through the
    plain run on the CPU: ok flags and tile counts equal, centre points
    within 2e-2, headings within 2e-3, curb flags differing on under 2% of
    tiles (tests/test_torch_track_device.py's bars)."""
    cfg = EnvConfig(num_agents=2)
    g = torch.Generator(device=dev).manual_seed(GEN_SEED)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pool = penv.make_track_pool_checked(cfg, g, GEN_POOL)
    torch.cuda.synchronize()
    pool_s = time.perf_counter() - t0
    zero_counts()
    t0 = time.perf_counter()
    state = penv.device_reset(cfg, g, E)
    torch.cuda.synchronize()
    reset_s = time.perf_counter() - t0
    counts = read_counts()
    failed = int(state.done.sum())
    assert_finite(state)
    phase(f"checked pool of {GEN_POOL} in {pool_s:.3f} s; device_reset E={E}, N=2 in "
          f"{reset_s:.3f} s ({failed} envs failed generation); launches {counts} on {smi}")
    want = {"k1": 0, "k2": 1, "k3": 0, "k4_k5": 1, "k6": 0, "plain_track_calls": 0,
            "plain_paint_calls": 0}
    if failed or counts != want or int(state.tile_visited_count.sum()) == 0:
        raise AssertionError(f"device_reset: {failed} failed envs, counts {counts}")
    out = {"pool_s": pool_s, "reset_s": reset_s, "reset_launches": counts,
           "pool": track_structure(pool, f"pool of {GEN_POOL}"),
           "reset": track_structure(state.track, f"device_reset E={E}")}
    u = torch.rand((GEN_POOL, C.CHECKPOINTS, 2), generator=g, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    card = tdev._attempt(*tdev.checkpoints_from_uniforms(u), cfg.max_tiles, cfg.max_track_points)
    torch.cuda.synchronize()
    attempt_s = time.perf_counter() - t0
    cpu = tdev._attempt(*tdev.checkpoints_from_uniforms(u.cpu()), cfg.max_tiles,
                        cfg.max_track_points)
    built = [tdev._build_track(*parts[:4], parts[4].clamp(min=1), cfg.max_tiles)
             for parts in (card, cpu)]
    ok_c, ok_p = card[5].cpu(), cpu[5]
    L = cpu[4]
    same = bool(torch.equal(ok_c, ok_p)) and bool(torch.equal(card[4].cpu(), L))
    xy_err = beta_err = curb_miss = 0.0
    for e in ok_p.nonzero().flatten().tolist():
        n = int(L[e])
        xy_err = max(xy_err, float((built[0].xy[e, :n].cpu() - built[1].xy[e, :n]).abs().max()))
        beta_err = max(beta_err,
                       float((built[0].beta[e, :n].cpu() - built[1].beta[e, :n]).abs().max()))
        curb_miss = max(curb_miss, float((built[0].has_curb[e, :n].cpu()
                                          != built[1].has_curb[e, :n]).float().mean()))
    out.update(attempt_s=attempt_s, card_vs_cpu={
        "ok_and_tiles_equal": same, "ok": int(ok_p.sum()), "max_xy_err": xy_err,
        "max_beta_err": beta_err, "max_curb_miss_share": curb_miss})
    phase(f"one attempt of {GEN_POOL} tracks on the card in {attempt_s:.3f} s "
          f"({cfg.max_track_points} walk steps); card vs CPU on the same uniforms: ok flags and "
          f"tile counts equal {same} ({int(ok_p.sum())} ok), max |xy| err {xy_err:.3g}, max "
          f"|beta| err {beta_err:.3g}, max curb miss share {curb_miss:.3g}")
    if not (same and xy_err <= 2e-2 and beta_err <= 2e-3 and curb_miss < 0.02):
        raise AssertionError(f"tracks on the card differ from the CPU's: {out['card_vs_cpu']}")
    return out


def vector_phase(obs: str, n: int, smi: str, dev: torch.device) -> dict:
    """Phases 28-29: gym_api.VectorMultiCarRacing at E = 4096 with ``n`` cars
    and observation ``obs``, its time limit VEC_LIMIT steps: reset (the
    checked pool, device_reset), then VEC_STEPS steps of cycled actions,
    which autoreset inside the phase. Counts zeroed just before the reset
    and read just after the last step: the island (K1 at one car, K2 above)
    and K4/K5 once per reset tick, step and autoreset tick, K6 once per
    frame (pixels: the reset's and each step's), nothing else; the
    observations' shape, rewards finite; steps/s (host clock around each
    step with its numpy outputs)."""
    venv = gym_api.VectorMultiCarRacing(E, num_agents=n, obs=obs, seed=VEC_SEED,
                                        max_episode_steps=VEC_LIMIT, device=dev,
                                        use_random_direction=n > 1)
    actions = cycled_actions(E, n, dev).cpu().numpy()
    zero_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    o = venv.reset()
    reset_s = time.perf_counter() - t0
    resets = 0
    wall = 0.0
    for t in range(VEC_STEPS):
        resets += int(bool(penv.episode_over(venv.cfg, venv.state).any()))
        t0 = time.perf_counter()
        o, r, d, _ = venv.step(actions[t % 8])
        wall += time.perf_counter() - t0
        if not np.isfinite(r).all() or r.shape != (E, n) or d.shape != (E,):
            raise AssertionError(f"vector {obs}: rewards {r.shape} finite "
                                 f"{np.isfinite(r).all()}, dones {d.shape}")
    torch.cuda.synchronize()
    counts = read_counts()
    island, other = ("k1", "k2") if n == 1 else ("k2", "k1")
    ticks = 1 + VEC_STEPS + resets
    want = {island: ticks, other: 0, "k3": 0, "k4_k5": ticks,
            "k6": 1 + VEC_STEPS if obs == "pixels" else 0, "plain_track_calls": 0,
            "plain_paint_calls": 0}
    shape = {"pixels": (E, n, 96, 96, 3), "state": (E, n, pobs.STATE_OBS_DIM)}.get(obs)
    out = {"obs": obs, "num_agents": n, "envs": E, "steps": VEC_STEPS, "limit": VEC_LIMIT,
           "reset_s": reset_s, "step_s": wall, "steps_per_s": VEC_STEPS / wall,
           "env_steps_per_s": E * VEC_STEPS / wall, "autoresets": resets, "launches": counts}
    phase(f"VectorMultiCarRacing obs={obs}, E={E}, N={n}: reset {reset_s:.3f} s; {VEC_STEPS} "
          f"steps in {wall:.3f} s = {out['steps_per_s']:.2f} steps/s = "
          f"{out['env_steps_per_s']:.1f} env-steps/s on {smi}; {resets} steps began with an "
          f"autoreset; launches {counts}")
    if counts != want or resets == 0 or (None if o is None else o.shape) != shape:
        raise AssertionError(f"vector {obs}: counts {counts} (expected {want}), {resets} "
                             f"autoresets, obs {None if o is None else o.shape}")
    venv.close()
    return out


def wide_states(n: int, envs: int, dev):
    """(cfg, spawn, driven, steps) at ``n`` cars: ``envs`` envs on the SEEDS
    tracks in turn (spawn order 0..n-1, CCW). ``spawn``: the state before
    the spawn tick with each odd car pulled toward its even partner by
    ALL_NEAR_PULL of their 6 m, phase 6's all-near input pair by pair (every
    env near; an odd N's last car stays where it spawned). ``driven``: the
    state after the spawn tick driven by env.step on the card with cycled
    actions until WIDE_NEAR_SHARE of the envs are broadphase-near and the
    next step's Collide pass has a live row in some env (at least 10 steps,
    at most WIDE_MAX_STEPS), whose step count is returned."""
    cfg = EnvConfig(num_agents=n, use_random_direction=False)
    pool = penv.make_host_track_pool(cfg, SEEDS, device=dev)
    idx = torch.arange(envs, device=dev) % len(SEEDS)
    order = torch.arange(n, dtype=torch.int32, device=dev).expand(envs, n).contiguous()
    tracks = tree_map(lambda x: x.index_select(0, idx), pool)
    dirs = torch.zeros(envs, dtype=torch.bool, device=dev)
    spawn = penv.spawn_state(cfg, tracks, order, dirs)
    hc, wc = spawn.cars.hull_c.clone(), spawn.cars.wheel_c.clone()
    m = 2 * (n // 2)                       # an odd N's last car has no partner
    pull = ALL_NEAR_PULL * (hc[:, 0:m:2] - hc[:, 1:m:2])
    hc[:, 1:m:2] += pull
    wc[:, 1:m:2] += pull[:, :, None]
    spawn = spawn.replace(cars=spawn.cars.replace(hull_c=hc, wheel_c=wc))
    state = penv.reset_from_parts(cfg, tracks, order, dirs)
    actions = cycled_actions(envs, n, dev)
    for t in range(WIDE_MAX_STEPS + 1):
        pre = apply_controls(state.cars, actions[t % 8])
        share = float(fused_world.near_flags(pre).float().mean())
        if t == WIDE_MAX_STEPS or (t >= 10 and share >= WIDE_NEAR_SHARE
                                   and live_rows(pre, n)[1] > 0):
            break
        state, _, _ = penv.step(cfg, state, actions[t % 8])
    return cfg, spawn, state.replace(cars=pre), t


def scratch_checks(inputs, n: int, label: str, plain: dict | None = None) -> dict:
    """K2 and K3 forced into the global scratch layout with SCRATCH_SLOTS
    slots (each warp looping over several envs) on one island input: K2
    against the plain island and K3 against world.world_step within their
    bars, and the elements where each differs from the wrapper's own layout
    (shared memory up to N = 9: another build of the same arithmetic, whose
    contractions into fused multiply-adds may differ in the last bit; past
    N = 9 the same build, so 0). ``plain``: the plain island's and solve's
    results on this input, if already computed ("island"; "cars",
    "bundle")."""
    plain = plain or {}
    pre, road, cs = inputs
    fin, ls_in = fused_world.pack_inputs(pre, road)
    out2 = [fused_world.launch_contacts(fin, ls_in, cs, n, scratch_warps=w)
            for w in (None, SCRATCH_SLOTS)]
    k_cars, k_skid = fused_world.unpack_outputs(pre, *out2[1][:2])
    p_island = plain["island"] if "island" in plain else fused_world.island_step_plain(*inputs)
    devs, id_miss, skid_miss = compare_contact_step(
        (k_cars, k_skid, out2[1][2]), p_island, pre, cs,
        f"K2 in {SCRATCH_SLOTS} scratch slots vs plain ({label})")
    if id_miss > WIDE_E // 1000 + 1 or skid_miss > WIDE_E // 1000 + 1:
        raise AssertionError(f"{label}: {id_miss} envs' ids, {skid_miss} skid flags differ")
    post, force, motor, bundle = solve_inputs(pre, road, cs, n)[:4]
    fin3, ls3 = fused_world.pack_solve_inputs(post, force, motor)
    out3 = [fused_world.launch_solve(fin3, ls3, bundle, n, scratch_warps=w)
            for w in (None, SCRATCH_SLOTS)]
    envs = post.hull_a.shape[0]
    p_cars, p_bundle = ((plain["cars"], plain["bundle"]) if "cars" in plain
                        else world.world_step(post, force, motor, contacts=bundle))
    k3 = post.replace(**fused_world._solved_fields(out3[1][0], out3[1][1], envs, n))
    devs3 = compare_cars(k3, p_cars, post, f"K3 in {SCRATCH_SLOTS} scratch slots vs plain "
                                           f"({label})")
    devs3.update(compare_fields(
        {"normal_imp": out3[1][2], "tangent_imp": out3[1][3]},
        {"normal_imp": p_bundle.normal_imp, "tangent_imp": p_bundle.tangent_imp},
        {"normal_imp": bundle.normal_imp, "tangent_imp": bundle.tangent_imp},
        f"K3 in {SCRATCH_SLOTS} scratch slots vs plain ({label})"))
    torch.cuda.synchronize()

    def differ(a, b):
        return sum(int((x != y).sum()) for x, y in zip(a, b))

    k2_out = [[o[0], o[1], o[2].normal_imp, o[2].tangent_imp, o[2].ids] for o in out2]
    out = {"k2_max_err_over_bar": max(max(rv, rs) for _, rv, rs in devs.values()),
           "k3_max_err_over_bar": max(max(rv, rs) for _, rv, rs in devs3.values()),
           "k2_elements_differing_from_wrapper_layout": differ(*k2_out),
           "k3_elements_differing_from_wrapper_layout": differ(*out3)}
    phase(f"{label}: K2 and K3 in {SCRATCH_SLOTS} scratch slots within their bars; elements "
          f"differing from the wrapper's layout: K2 {out['k2_elements_differing_from_wrapper_layout']}"
          f", K3 {out['k3_elements_differing_from_wrapper_layout']}")
    return out


def wide_contact_phase(dev: torch.device, smi: str) -> tuple[dict, dict]:
    """Phase 30: K2 and K3 past N = 9, where a warp's arrays leave shared
    memory for the global scratch, and past N = 32 (PAST_WARP_NS), where a
    lane carries two cars. At N = 6 and 8 (the shared layout) the
    scratch layout forced with SCRATCH_SLOTS slots, on a driven near state,
    within the bars of the plain versions (scratch_checks; the shared
    layout's bytes are held against the parent's by compare_parent.py). At
    N = 10 and 12 (WIDE_E envs): the reset and the drive to a near state
    with a contact through env.step on the card (K2 and K4/K5 once per
    tick, counts zeroed just before the reset), then K2 against the plain
    island on the all-near spawn tick and on the driven state, and K3
    against world.world_step on the driven state, within their bars (both inputs
    with near envs, the driven one with live contacts); the scratch layout
    with SCRATCH_SLOTS slots byte-equal to the wrapper's (the same build),
    two launches of each bit-identical, and their ms and bounds on the
    driven state; past N = 32 also on piled groups (pile_checks). Returns
    (the results, {N: (cfg, driven state)} past N = 32 for phase 34)."""
    out, states = {}, {}
    for n in NARROW_NS:
        _, _, driven, steps = wide_states(n, WIDE_E, dev)
        out[f"N={n}"] = {"driven_steps": steps, **scratch_checks(
            (driven.cars, driven.wheel_on_road, driven.contacts), n,
            f"N={n}, E={WIDE_E}, driven {steps} steps")}
    for n in WIDE_NS + PAST_WARP_NS:
        t_n = time.perf_counter()
        mm = len(collide.car_pairs(n)) * collide.M_PER_PAIR
        lib2 = fused_world._library(fused_world.CONTACT_KERNEL)
        lib3 = fused_world._library(fused_world.SOLVE_KERNEL)
        slots = (lib2.contact_island_scratch_warps(WIDE_E, n, mm),
                 lib3.solve_island_scratch_warps(WIDE_E, n, mm))
        floats = lib2.contact_island_warp_floats(n, mm)
        zero_counts()
        cfg, spawn, state, steps = wide_states(n, WIDE_E, dev)
        torch.cuda.synchronize()
        counts = read_counts()
        assert_finite(state)
        want = {"k1": 0, "k2": 1 + steps, "k3": 0, "k4_k5": 1 + steps, "k6": 0,
                "plain_track_calls": 0, "plain_paint_calls": 0}
        phase(f"N={n}, E={WIDE_E}: {mm} rows an env, {4 * floats} bytes of arrays a warp; "
              f"scratch slots K2 {slots[0]}, K3 {slots[1]}; reset + {steps} env steps on the "
              f"card: launches {counts}")
        if counts != want or min(slots) <= 0:
            raise AssertionError(f"N={n}: counts {counts} (expected {want}), scratch {slots}")
        driven = (state.cars, state.wheel_on_road, state.contacts)
        res = {"rows": mm, "warp_bytes": 4 * floats, "driven_steps": steps,
               "scratch_slots": {"k2": slots[0], "k3": slots[1]}, "launches": counts}
        worst, plain = {}, {}
        # Past 32 cars the driven state's near envs (54 and 60 of 64 in PR
        # 18's runs) stand for the spawn tick's, and its plain results feed
        # the later checks: each plain island of 64 cars takes ~2.5 s.
        cases = (("driven", driven),) if n > fused_world.LANE_CARS else (
            ("all-near spawn tick", (spawn.cars, spawn.wheel_on_road, spawn.contacts)),
            ("driven", driven))
        for name, ins in cases:
            label = f"N={n} {name}"
            k_out = fused_world.island_step(*ins)
            near = int(fused_world.launch_contacts.near_count)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            p_out = fused_world.island_step_plain(*ins)
            torch.cuda.synchronize()
            plain.update(island=p_out, island_ms=1e3 * (time.perf_counter() - t0))
            devs, id_miss, skid_miss = compare_contact_step(
                k_out, p_out, ins[0], ins[2], f"K2 vs plain ({label})")
            live = int(k_out[2].normal_imp.gt(0).any(-1).any(-1).sum())
            phase(f"{label}: near envs {near}, envs with a normal impulse {live}; ids differing "
                  f"in {id_miss} envs, skid flags {skid_miss}")
            if id_miss > WIDE_E // 1000 + 1 or skid_miss > WIDE_E // 1000 + 1:
                raise AssertionError(f"K2 vs plain ({label}): {id_miss} envs' ids, {skid_miss} "
                                     f"skid flags differ")
            if near == 0 or (name == "driven" and live == 0):
                raise AssertionError(f"{label}: no near env or no live contact")
            worst[f"k2 {name}"] = max(max(rv, rs) for _, rv, rs in devs.values())
            res[f"{name.replace(' ', '_')}_near_envs"] = near
            res[f"{name.replace(' ', '_')}_live_envs"] = live
        d3 = compare_solve(solve_inputs(*driven, n), n, f"K3 vs plain (N={n} driven)", plain)
        worst["k3 driven"] = max(max(rv, rs) for _, rv, rs in d3.values())
        slot_checks = scratch_checks(driven, n, f"N={n} driven, the wrapper's {slots[0]} / "
                                               f"{slots[1]} slots against {SCRATCH_SLOTS}",
                                     plain)
        fin, ls_in = fused_world.pack_inputs(driven[0], driven[1])
        a, b = (fused_world.launch_contacts(fin, ls_in, driven[2], n) for _ in range(2))
        same = all(torch.equal(x, y) for x, y in zip(
            (a[0], a[1], a[2].normal_imp, a[2].tangent_imp, a[2].ids),
            (b[0], b[1], b[2].normal_imp, b[2].tangent_imp, b[2].ids)))
        post, force, motor, bundle = solve_inputs(*driven, n)[:4]
        fin3, ls3 = fused_world.pack_solve_inputs(post, force, motor)
        a3, b3 = (fused_world.launch_solve(fin3, ls3, bundle, n) for _ in range(2))
        same = same and all(torch.equal(x, y) for x, y in zip(a3, b3))
        phase(f"N={n} driven: two K2 launches and two K3 launches bit-identical {same}")
        if (not same or slot_checks["k2_elements_differing_from_wrapper_layout"]
                or slot_checks["k3_elements_differing_from_wrapper_layout"]):
            raise AssertionError(f"N={n}: the scratch layout is not reproducible")
        res.update(max_err_over_bar=worst, slot_checks=slot_checks,
                   two_launches_identical=same, k2=k2_time_and_bound(*driven, n))
        phase(f"K2 at N={n} on the driven state: {res['k2']['ms']:.5f} ms/launch, bound "
              f"{res['k2']['bound_ms']:.5f} ms ({res['k2']['bound_by']}), "
              f"{res['k2']['near_envs']} near envs, on {smi}")
        res["k3"] = solve_times(*driven, n, plain)
        res["k2"]["plain_ms"] = plain["island_ms"]
        res["seconds"] = time.perf_counter() - t_n
        phase(f"K2 at N={n}: the plain island on the driven state {plain['island_ms']:.3f} ms; "
              f"N={n} took {res['seconds']:.1f} s")
        if n > fused_world.LANE_CARS:
            res["piled_groups"] = pile_checks(n, dev)
            states[n] = (cfg, state)
        out[f"N={n}"] = res
    return out, states


def past_warp_phase(states: dict, dev: torch.device, smi: str) -> dict:
    """Phase 34: K4/K5 and K6 past 32 cars an env, and the Gym facade there.
    On phase 30's driven states at N = 33 and 64 (WIDE_E envs): K4/K5 on the
    next step's inputs against the plain track pass (track bars, two
    launches bit-identical), K6 against the plain painter on the driven
    (warm) views and 2 s later (steady), byte for byte, and each kernel's ms
    (graph_ms), plain ms and bound. Then ``gym_api.make("MultiCarRacing-v0",
    num_agents=33)`` on the card: a reset and PAST_WARP_FACADE_STEPS steps
    with pixels, the counts set to 0 after the reset and read after the last
    step (one K2, one K4/K5 and one K6 launch a step, nothing else), and the
    last observation against the plain painter."""
    out = {}
    for n, (cfg, state) in states.items():
        actions = cycled_actions(WIDE_E, n, dev)
        pre = apply_controls(state.cars, actions[0])
        post, _, _ = fused_world.island_step(pre, state.wheel_on_road, state.contacts)
        args = (state.track, pre, post.hull_origin, state.visited, state.tile_touched, n)
        k, k2 = track_engine.track_pass(*args), track_engine.track_pass(*args)
        p = track_engine.track_pass_plain(*args)
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(k, k2))
        track = compare_track(k, p, state.track, f"K4/K5 vs plain (N={n}, E={WIDE_E}, "
                                                 f"bit-identical {same})")
        if not same:
            raise AssertionError(f"N={n}: two K4/K5 launches differ")
        wheels, origins = track_engine.pack_cars(pre, post.hull_origin)
        mt = state.track.max_tiles
        k45_ms = graph_ms(lambda: track_engine.launch(state.track, wheels, origins,
                                                      state.visited, state.tile_touched),
                          KERNEL_TIMING_LAUNCHES)
        k45_plain = cuda_ms(lambda: track_engine.track_pass_plain(*args), 3)
        nbytes, flops = track_engine.track_pass_work(
            WIDE_E, n, mt, valid_tiles=int(state.track.n_tiles.sum()),
            candidates=track_engine.track_candidates(state.track, pre, post.hull_origin),
            near_post=track_engine.post_candidates(state.track, post.hull_origin))
        byte_ms, flop_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOPS
        res = {"k4_k5": {"ms": k45_ms, "plain_ms": k45_plain, "bound_ms": max(byte_ms, flop_ms),
                         "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                         "bonus_err": track["bonus_err"], "new_tiles": track["new_tiles"],
                         "second_visitor_shares": track["share"]}}
        steady = state.replace(t=state.t + 2.0)
        px = {lab: compare_pixels(cfg, st, f"K6 vs plain (N={n}, E={WIDE_E}, {lab})")
              for lab, st in (("driven", state), ("steady", steady))}
        pargs = pixels.paint_inputs(cfg, steady)
        k6_ms = graph_ms(lambda: pixels.paint_views(*pargs), KERNEL_TIMING_LAUNCHES)
        k6_plain = px["steady"]["plain_ms"]
        nbytes, flops = pixels.paint_work(cfg, steady)
        byte_ms, flop_ms = 1e3 * nbytes / PEAK_BYTES_PER_S, 1e3 * flops / PEAK_FP32_FLOPS
        res["k6"] = {"ms": k6_ms, "plain_ms": k6_plain, "bound_ms": max(byte_ms, flop_ms),
                     "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
                     "smem_bytes": pixels.paint_smem_bytes(n, mt),
                     "checks": {lab: {k: r[k] for k in ("views", "warm_views", "flag_views",
                                                        "differing_bytes")}
                                for lab, r in px.items()}}
        phase(f"N={n}, E={WIDE_E} on {smi}: K4/K5 {k45_ms:.5f} ms/launch (CUDA graph), plain "
              f"{k45_plain:.3f} ms, bound {res['k4_k5']['bound_ms']:.5f} ms; K6 steady "
              f"{k6_ms:.5f} ms/launch (CUDA graph, {pixels.paint_smem_bytes(n, mt)} bytes of "
              f"shared memory a view), plain {k6_plain:.3f} ms, bound "
              f"{res['k6']['bound_ms']:.5f} ms ({res['k6']['bound_by']})")
        out[f"N={n}"] = res

    n = PAST_WARP_NS[0]
    env = gym_api.make("MultiCarRacing-v0", num_agents=n, verbose=0)
    actions = cycled_actions(1, n, dev)[:, 0].cpu().numpy()
    env.seed(0)
    zero_counts()
    first = env.reset()
    torch.cuda.synchronize()
    reset_counts = read_counts()
    zero_counts()
    ret = np.zeros(n)
    t0 = time.perf_counter()
    for t in range(PAST_WARP_FACADE_STEPS):
        o, r, done, info = env.step(actions[t % 8])
        ret += r
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    phase(f"MultiCarRacing-v0 num_agents={n} on the card: launches in the reset {reset_counts}; "
          f"in {PAST_WARP_FACADE_STEPS} steps with pixels {counts} ({wall:.3f} s); return "
          f"{ret.round(3).tolist()}")
    check_counts(f"facade N={n}", counts, PAST_WARP_FACADE_STEPS, PAST_WARP_FACADE_STEPS, n)
    plain = pixels.paint_views_plain(*pixels.paint_inputs(env.env.cfg, env.state))[0]
    bad = int((plain.cpu().numpy() != o).any(-1).sum())
    if (bad or first.shape != (n, 96, 96, 3) or o.shape != (n, 96, 96, 3)
            or not np.isfinite(ret).all() or min(reset_counts[k] for k in ("k2", "k4_k5")) < 1):
        raise AssertionError(f"facade N={n}: {bad} pixels differ from the plain painter, "
                             f"observations {first.shape} {o.shape}, returns {ret}, reset "
                             f"launches {reset_counts}")
    out["facade"] = {"num_agents": n, "steps": PAST_WARP_FACADE_STEPS, "wall_s": wall,
                     "reset_launches": reset_counts, "launches": counts,
                     "differing_pixels": bad, "return": ret.tolist()}
    env.close()
    return out


def zero_counts() -> None:
    fused_world.island_step.launches = fused_world.island_step.contact_launches = 0
    track_engine.track_pass.launches = track_engine.track_pass_plain.cuda_calls = 0
    pixels.paint_views.launches = pixels.paint_views_plain.cuda_calls = 0
    fused_world.world_step_batched.launches = 0


def read_counts() -> dict:
    return {"k1": fused_world.island_step.launches,
            "k2": fused_world.island_step.contact_launches,
            "k3": fused_world.world_step_batched.launches,
            "k4_k5": track_engine.track_pass.launches,
            "k6": pixels.paint_views.launches,
            "plain_track_calls": track_engine.track_pass_plain.cuda_calls,
            "plain_paint_calls": pixels.paint_views_plain.cuda_calls}


def check_counts(label: str, counts: dict, steps: int, frames: int, n_agents: int) -> None:
    """The path's kernels launched once per env step (the island, K1 at N = 1
    and K2 above; the track pass) and once per frame (K6); every other
    kernel and plain version on the card never."""
    island, other = ("k1", "k2") if n_agents == 1 else ("k2", "k1")
    want = {island: steps, other: 0, "k3": 0, "k4_k5": steps, "k6": frames,
            "plain_track_calls": 0, "plain_paint_calls": 0}
    if counts != want:
        raise AssertionError(f"{label}: launch counts {counts}, expected {want}")


def policy_observations(name: str, dev: torch.device):
    """The observations a committed policy sees on LEARNER_NET_OBS cars of
    envs driven LEARNER_DRIVE steps on the card (stacked, normalised)."""
    net, rms, env_cfg, flags, _ = evaluate.load_policy(name, dev)
    pcfg = lppo.PPOConfig(**flags)
    envs = LEARNER_NET_OBS // env_cfg.num_agents
    state = evaluate.episode_state(env_cfg, envs, LEARNER_SEED, dev)
    actions = cycled_actions(envs, env_cfg.num_agents, dev)
    obs_now = lppo._observe(env_cfg, pcfg, state)
    frames = lppo.init_frames(pcfg, obs_now)
    for t in range(LEARNER_DRIVE):
        state, _, _ = penv.step(env_cfg, state, actions[t % 8])
        frames = lppo._push_frames(frames, obs_now)
        obs_now = lppo._observe(env_cfg, pcfg, state)
    obs = lppo._stack_obs(frames, obs_now)
    if rms is not None:
        obs = lppo._rms_normalize(rms, obs)
    return net, obs


def network_phase(dev: torch.device) -> dict:
    """Phase 19: each committed policy's network on the card against the
    same policy on the CPU, on the same observations."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled: the float32 layers must not use them")
    out = {}
    for name in POLICY_NAMES:
        net, obs = policy_observations(name, dev)
        cpu_net = evaluate.load_policy(name, "cpu")[0]
        with torch.no_grad():
            got = [t.detach().cpu() for t in net(obs)]
            want = [t.detach() for t in cpu_net(obs.cpu())]
        pixel = net.obs_type == "pixels"
        tol = LEARNER_PIXEL_TOL if pixel else LEARNER_STATE_TOL
        errs = {}
        for label, g, w in zip(("mean", "log_std", "value"), got, want):
            err = float((g - w).abs().max())
            bar = tol * max(1.0, float(w.abs().max()))
            errs[label] = {"max_abs_err": err, "bar": bar, "max_abs": float(w.abs().max())}
            if not err <= bar:
                raise AssertionError(f"{name}: {label} on the card {err:.3g} from the CPU, bar "
                                     f"{bar:.3g}")
        out[name] = {"cars": int(obs.shape[0] * obs.shape[1]), **errs}
        phase(f"{name}: {out[name]['cars']} observations, card vs CPU max |err| mean "
              f"{errs['mean']['max_abs_err']:.4g} (bar {errs['mean']['bar']:.4g}), value "
              f"{errs['value']['max_abs_err']:.4g} (bar {errs['value']['bar']:.4g}; "
              f"max |value| {errs['value']['max_abs']:.4g})")
    return out


def evaluation_phase(smi: str, dev: torch.device) -> dict:
    """Phase 20: each committed policy evaluated deterministically over
    LEARNER_EPISODES fresh episodes on tracks generated on the card
    (evaluate.episode_state: env.device_reset, seed LEARNER_SEED) on the
    card, held to its recorded mean by a two-sample bound."""
    out, specs = {}, evaluate.policy_specs()
    for name in POLICY_NAMES:
        rec = specs[name]["record"]
        net, rms, env_cfg, flags, _ = evaluate.load_policy(name, dev)
        pcfg = lppo.PPOConfig(num_envs=LEARNER_EPISODES, **flags)
        t0 = time.perf_counter()
        state = evaluate.episode_state(env_cfg, LEARNER_EPISODES, LEARNER_SEED, dev)
        torch.cuda.synchronize()
        reset_s = time.perf_counter() - t0
        with torch.no_grad():
            obs0 = lppo._observe(env_cfg, pcfg, state)
            obs = lppo._stack_obs(lppo.init_frames(pcfg, obs0), obs0)
            if rms is not None:
                obs = lppo._rms_normalize(rms, obs)
            forward_ms = cuda_ms(lambda: net(obs), 20)
        eval_fn = evaluate.make_eval_fn(env_cfg, pcfg, LEARNER_EPISODES)
        zero_counts()
        t0 = time.perf_counter()
        res = eval_fn(net, rms, state)
        s = evaluate.summarize(res)
        wall = time.perf_counter() - t0
        counts = read_counts()
        per_episode = res["returns"].mean(-1).cpu()
        worst = [{"episode": i, "return": float(per_episode[i]),
                  "tiles": res["tiles"][i].tolist(), "n_tiles": int(res["n_tiles"][i]),
                  "length": int(res["length"][i])}
                 for i in torch.argsort(per_episode)[:LEARNER_WORST].tolist()]
        env_steps = -(-env_cfg.max_episode_steps // pcfg.action_repeat) * pcfg.action_repeat
        check_counts(name, counts, env_steps,
                     env_steps // pcfg.action_repeat if pcfg.obs_type == "pixels" else 0,
                     env_cfg.num_agents)
        bar = LEARNER_Z * float(np.sqrt((rec["std"] ** 2 + s["eval_return_std"] ** 2)
                                        / LEARNER_EPISODES))
        miss = abs(s["eval_return"] - rec["mean"])
        out[name] = {**s, "record_mean": rec["mean"], "record_std": rec["std"],
                     "record_source": rec["source"], "bar": bar, "miss": miss,
                     "reset_s": reset_s, "wall_s": wall,
                     "env_steps_per_s": LEARNER_EPISODES * env_steps / wall,
                     "forward_ms": forward_ms, "forward_rows": LEARNER_EPISODES *
                     env_cfg.num_agents, "launches": counts, "worst_episodes": worst}
        phase(f"{name}: {s['eval_return']:.4f} +- {s['eval_return_std']:.4f} per car over "
              f"{LEARNER_EPISODES} episodes (min {s['eval_return_min']:.4f}, max "
              f"{s['eval_return_max']:.4f}, best agent {s['eval_best_agent_return']:.4f}, "
              f"tiles {s['eval_tiles_frac']:.4f}, length {s['eval_len']:.2f}); recorded "
              f"{rec['mean']} +- {rec['std']} ({rec['source']}): miss {miss:.4f}, bar "
              f"{bar:.4f}; {wall:.3f} s = {out[name]['env_steps_per_s']:.1f} env-steps/s on "
              f"{smi} (reset {reset_s:.3f} s); forward {forward_ms:.4f} ms at "
              f"{out[name]['forward_rows']} rows; launches {counts}; worst episodes "
              + "; ".join(f"{w['return']:.1f} ({w['tiles']} of {w['n_tiles']} tiles, episode "
                          f"{w['episode']})" for w in worst))
        if not miss <= bar:
            raise AssertionError(f"{name}: evaluated {s['eval_return']:.4f}, recorded "
                                 f"{rec['mean']}: the miss {miss:.4f} exceeds {bar:.4f}")
    return out


def train_states_equal(a, b) -> bool:
    tensors_a = [*a.net.state_dict().values(), *tree_leaves(a.env_state), *tree_leaves(a.pool),
                 a.generator.get_state()]
    tensors_b = [*b.net.state_dict().values(), *tree_leaves(b.env_state), *tree_leaves(b.pool),
                 b.generator.get_state()]
    oa, ob = a.opt.state_dict(), b.opt.state_dict()
    tensors_a += [*oa["mu"], *oa["nu"], oa["count"]]
    tensors_b += [*ob["mu"], *ob["nu"], ob["count"]]
    for x, y in ((a.obs_rms, b.obs_rms), (a.frames, b.frames)):
        if (x is None) != (y is None):
            return False
    if a.obs_rms is not None:
        tensors_a += [a.obs_rms[k] for k in sorted(a.obs_rms)]
        tensors_b += [b.obs_rms[k] for k in sorted(b.obs_rms)]
    if a.frames is not None:
        tensors_a.append(a.frames)
        tensors_b.append(b.frames)
    return (len(tensors_a) == len(tensors_b) and a.update_i == b.update_i
            and a.env_cfg == b.env_cfg and a.ppo_cfg == b.ppo_cfg
            and all(x.device == y.device and torch.equal(x, y)
                    for x, y in zip(tensors_a, tensors_b)))


def ppo_phase(label: str, env_cfg, pcfg, smi: str, dev: torch.device) -> dict:
    """Phases 21-22: LEARNER_UPDATES PPO train steps from a fresh learner on
    the card; finite metrics, moved parameters, exact launch counts, stage
    times; then a checkpoint saved and restored on the card, tensor-equal."""
    t0 = time.perf_counter()
    ts = lppo.init_train_state(env_cfg, pcfg, LEARNER_SEED, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    before = [p.detach().clone() for p in ts.net.parameters()]
    step = lppo.make_train_step(env_cfg, pcfg)
    env_steps = pcfg.num_envs * pcfg.rollout_len * pcfg.action_repeat
    zero_counts()
    updates = []
    for u in range(LEARNER_UPDATES):
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        stages = lppo.stage_ms(step.marks)
        updates.append({"wall_s": wall, "env_steps_per_s": env_steps / wall,
                        "stage_ms": stages, **metrics})
        phase(f"{label} update {u + 1}: {wall:.3f} s = {env_steps / wall:.1f} env-steps/s "
              f"with the learner on {smi}; rollout {stages['rollout'] / 1e3:.3f} s, GAE "
              f"{stages['gae'] / 1e3:.3f} s, update {stages['update'] / 1e3:.3f} s, reset "
              f"{stages['reset'] / 1e3:.3f} s; loss {metrics['loss']:.5g}, v_loss "
              f"{metrics['v_loss']:.5g}, approx_kl_max {metrics['approx_kl_max']:.4g}, "
              f"grad_norm_max {metrics['grad_norm_max']:.4g}, skipped_updates "
              f"{metrics['skipped_updates']:.0f}, nan_envs {metrics['nan_envs']:.0f}, "
              f"episodes_finished {metrics['episodes_finished']:.0f}")
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{label}: metrics not finite: {bad}")
    counts = read_counts()
    steps = LEARNER_UPDATES * (pcfg.rollout_len * pcfg.action_repeat + 1)   # + reset ticks
    frames = LEARNER_UPDATES * (pcfg.rollout_len + 1) if pcfg.obs_type == "pixels" else 0
    check_counts(label, counts, steps, frames, env_cfg.num_agents)
    moved = max(float((a - b.detach()).abs().max()) for a, b in zip(before, ts.net.parameters()))
    if not moved > 0 or not all(bool(torch.isfinite(p).all()) for p in ts.net.parameters()):
        raise AssertionError(f"{label}: parameters did not move or are not finite")
    path = os.path.join(CKPT_DIR, label.replace(" ", "_"))
    t0 = time.perf_counter()
    checkpoint.save(path, ts)
    back = checkpoint.restore(path, device=dev)
    torch.cuda.synchronize()
    ckpt_s = time.perf_counter() - t0
    same = train_states_equal(ts, back)
    remove_checkpoint(path)
    phase(f"{label}: parameters moved (max |change| {moved:.4g}); launches {counts}; "
          f"checkpoint save + restore on the card {ckpt_s:.3f} s, every tensor equal: {same}")
    if not same:
        raise AssertionError(f"{label}: the restored checkpoint differs from the saved state")
    return {"envs": pcfg.num_envs, "agents": env_cfg.num_agents, "rollout_len":
            pcfg.rollout_len, "action_repeat": pcfg.action_repeat, "init_s": init_s,
            "updates": updates, "launches": counts, "param_max_change": moved,
            "checkpoint_s": ckpt_s, "checkpoint_equal": same}


LEARNER_BASE = dict(rollout_len=32, action_repeat=4, train_grass_cost=0.5, train_skip_cost=2.0,
                    anneal_lr=True, epochs=4, minibatches=8)


def pixel_recipe():
    """multi2px's shape: N=2, E=1024, T=32, R=4, K=2, squash, lr 1e-4, kl_target 0.03."""
    return EnvConfig(num_agents=2), lppo.PPOConfig(
        num_envs=1024, obs_type="pixels", frame_stack=2, squash_actions=True, lr=1e-4,
        kl_target=0.03, total_updates=1500, **LEARNER_BASE)


def state_recipe():
    """The state recipe's shape: CarRacing-v0, E=1024, T=32, R=4, normalize, width 512."""
    return (EnvConfig(num_agents=1, use_random_direction=False, backwards_flag=False),
            lppo.PPOConfig(num_envs=1024, normalize_obs=True, width=512, total_updates=1200,
                           **LEARNER_BASE))


def learner_phases(smi: str, dev: torch.device) -> dict:
    phase(f"19/36 the committed policies' networks on the card vs the CPU ({LEARNER_NET_OBS} "
          f"observations each, after {LEARNER_DRIVE} driven steps)")
    nets = network_phase(dev)
    phase(f"20/36 the committed policies evaluated on the card: {LEARNER_EPISODES} fresh "
          f"episodes each on tracks generated on the card, seed {LEARNER_SEED}, "
          f"deterministic")
    t20 = time.perf_counter()
    evals = evaluation_phase(smi, dev)
    phase(f"phase 20 took {time.perf_counter() - t20:.1f} s")
    phase("21/36 three PPO updates at the pixel recipe's shape (multi2px: N=2, E=1024, T=32, "
          "R=4, K=2, squash, lr 1e-4, kl_target 0.03)")
    pixel = ppo_phase("pixel PPO", *pixel_recipe(), smi, dev)
    phase("22/36 three PPO updates at the state recipe's shape (CarRacing-v0, E=1024, T=32, "
          "R=4, normalize, width 512)")
    state = ppo_phase("state PPO", *state_recipe(), smi, dev)
    return {"networks": nets, "evaluations": evals, "ppo_pixels": pixel, "ppo_state": state}


def facade_phase(env_id: str, smi: str, dev: torch.device) -> dict:
    """Phase 23: ``gym_api.make(env_id)`` on the card: reset with a seed,
    FACADE_STEPS steps of cycled actions through ``step`` (counts set to 0
    after the reset, read after the last step: one island, one K4/K5 and
    one K6 launch per step, nothing else), facade steps per second; then
    every FACADE_CHECK_EVERY-th observation, the reset's and the last,
    against the plain painter on the card, byte for byte."""
    env = gym_api.make(env_id, verbose=0)
    n = env.num_agents
    actions = cycled_actions(1, n, dev)[:, 0].cpu().numpy()             # (8, N, 3)
    env.seed(0)
    t0 = time.perf_counter()
    first = env.reset()
    reset_s = time.perf_counter() - t0
    held = [(env.state, first)]
    zero_counts()
    ret = np.zeros(n)
    t0 = time.perf_counter()
    for t in range(FACADE_STEPS):
        o, r, done, info = env.step(actions[t % 8])
        ret += r
        if (t + 1) % FACADE_CHECK_EVERY == 0 or t + 1 == FACADE_STEPS:
            held.append((env.state, o))
    wall = time.perf_counter() - t0
    counts = read_counts()
    check_counts(f"facade {env_id}", counts, FACADE_STEPS, FACADE_STEPS, n)
    if first.shape != (n, 96, 96, 3) or o.dtype != np.uint8 or not np.isfinite(ret).all():
        raise AssertionError(f"facade {env_id}: observation {first.shape} {o.dtype}, returns "
                             f"{ret}")
    bad = 0
    for st, ob in held:
        plain = pixels.paint_views_plain(*pixels.paint_inputs(env.env.cfg, st))[0].cpu().numpy()
        bad += int((plain != ob).any(-1).sum())
    out = {"env_id": env_id, "agents": n, "steps": FACADE_STEPS, "reset_s": reset_s,
           "wall_s": wall, "steps_per_s": FACADE_STEPS / wall, "launches": counts,
           "checked_frames": len(held), "differing_pixels": bad,
           "return": ret.tolist(), "tiles": [int(x) for x in env.tile_visited_count],
           "track_length": env.track_length}
    phase(f"facade {env_id}: reset {reset_s:.3f} s; {FACADE_STEPS} steps in {wall:.4f} s = "
          f"{FACADE_STEPS / wall:.2f} facade steps/s on {smi}; launches {counts}; "
          f"{len(held)} observations vs the plain painter on the card, differing pixels {bad}; "
          f"return {ret.round(4).tolist()}, tiles {out['tiles']} of {env.track_length}")
    if bad:
        raise AssertionError(f"facade {env_id}: {bad} observation pixels differ from the plain "
                             f"painter's")
    # Where a step's time goes: traces of the facade step, of its parts
    # (the core env.step; the observation, view_inputs + K6) on the same state.
    cfg, st = env.env.cfg, env.state
    act = torch.as_tensor(actions[0], device=dev)[None]
    out["trace"] = {
        "facade_step": device_trace(lambda: env.step(actions[1]), TRACE_STEPS),
        "env_step": device_trace(lambda: penv.step(cfg, st, act), TRACE_STEPS),
        "observation": device_trace(lambda: pobs.pixel_observation_batched(cfg, st),
                                    TRACE_STEPS)}
    for k, tr in out["trace"].items():
        phase(trace_line(f"facade {env_id} trace, {k} x{TRACE_STEPS}", tr))
    return out


def rgb_array_phase(smi: str, dev: torch.device) -> dict:
    """Phase 24: the 600x400 rgb_array painter on the card: the golden
    state's frame byte-equal to tests/fixtures/golden/rgb_array_skid.npz
    (0 differing pixels, or the phase fails); then a CarRacing-v0 facade
    launched FACADE_LAUNCH_STEPS steps and braked FACADE_BRAKE_STEPS through
    ``step``: its skid segments counted, its rgb_array frame timed (warm
    and steady) and byte-equal to the same state's frame on the CPU."""
    d = np.load(os.path.join(GOLDEN_DIR, "rgb_array_skid.npz"))
    meta = json.loads(str(d["meta"]))
    st = convert.env_state_from_leaves([d[f"leaf_{i}"][None] for i in range(meta["n_leaves"])],
                                       device=dev)
    cfg = EnvConfig(**meta["cfg"])
    frame = raster.render_observation(cfg, st, 600, 400, draw_particles=True)[0].cpu().numpy()
    golden_bad = int((frame != d["frame"]).any(-1).sum())
    steady_ms = cuda_ms(lambda: raster.render_observation(cfg, st, 600, 400,
                                                          draw_particles=True), 5)
    phase(f"rgb_array golden frame on the card: {golden_bad} pixels differ from the fixture; "
          f"{steady_ms:.3f} ms per 600x400 frame of 2 views (steady, CUDA events, 5 frames)")
    if golden_bad:
        raise AssertionError(f"rgb_array: {golden_bad} pixels differ from the golden frame")
    env = gym_api.make("CarRacing-v0", verbose=0)
    env.seed(0)
    env.reset()
    warm_ms = cuda_ms(lambda: env.render("rgb_array"), 2)
    # One traced frame of each kind: the golden state's (steady zoom) and the
    # fresh reset's (the first-second zoom-out paints the whole track).
    trace = {
        "steady_frame": device_trace(lambda: raster.render_observation(
            cfg, st, 600, 400, draw_particles=True), 1),
        "warm_frame": device_trace(lambda: raster.render_observation(
            env.env.cfg, env.state, 600, 400, draw_particles=True), 1)}
    for k, tr in trace.items():
        phase(trace_line(f"rgb_array trace, {k}", tr))
    gas = torch.tensor([[[0.0, 1.0, 0.0]]], device=dev)
    for _ in range(FACADE_LAUNCH_STEPS):
        env.env._state, _, _ = penv.step(env.env.cfg, env.state, gas)
    launched = int(env.state.skid.valid.sum())
    counts = []
    for _ in range(FACADE_BRAKE_STEPS):
        env.step([0.0, 0.0, 1.0])
        counts.append(int(env.state.skid.valid.sum()))
    braked = env.render("rgb_array")
    cpu_state = tree_map(lambda x: x.cpu(), env.state)
    cpu_frame = raster.render_observation(env.env.cfg, cpu_state, 600, 400,
                                          draw_particles=True)[0].numpy()
    cpu_bad = int((braked != cpu_frame).any(-1).sum())
    no_trails = raster.render_observation(env.env.cfg, env.state, 600, 400)[0].cpu().numpy()
    trail_px = int((braked != no_trails).any(-1).sum())
    out = {"golden_differing_pixels": golden_bad, "steady_ms": steady_ms, "warm_ms": warm_ms,
           "segments_after_launch": launched, "segments_per_brake_step": counts,
           "trail_pixels": trail_px, "card_vs_cpu_differing_pixels": cpu_bad, "trace": trace}
    phase(f"braking: {launched} segments after a {FACADE_LAUNCH_STEPS}-step launch, then "
          f"{counts} over {FACADE_BRAKE_STEPS} brake steps; {trail_px} trail pixels in the "
          f"frame; card vs CPU frame differing pixels {cpu_bad}; warm frame {warm_ms:.3f} ms")
    if not (counts[-1] > launched and trail_px > 0) or cpu_bad:
        raise AssertionError(f"rgb_array after braking: {out}")
    return out


def monitor_phase(dev: torch.device) -> dict:
    """Phase 25: ``monitor.Monitor`` around a CarRacing-v0 facade on the
    card: one episode of MONITOR_STEPS steps (the TimeLimit cut), a video
    when this Python has an encoder, stats.json always."""
    encoders = monitor.encoders()
    out_dir = os.path.join(SMOKE_DIR, "monitor")
    env = monitor.Monitor(gym_api.make("CarRacing-v0", verbose=0), out_dir, force=True,
                          video_callable=(lambda i: True) if encoders else (lambda i: False))
    env.env.max_episode_steps = MONITOR_STEPS          # the TimeLimit inside the Monitor
    env.seed(3)
    env.reset()
    t0 = time.perf_counter()
    done = False
    while not done:
        _, _, done, info = env.step([0.0, 0.3, 0.0])
    env.close()
    wall = time.perf_counter() - t0
    stats = json.load(open(os.path.join(out_dir, "stats.json")))
    files = stats["episode_files"]
    size = os.path.getsize(os.path.join(out_dir, files[0])) if files[0] else 0
    phase(f"Monitor: encoders {encoders}; episode lengths {stats['episode_lengths']}, files "
          f"{files} ({size} bytes), {wall:.3f} s for {MONITOR_STEPS} steps with frames")
    if stats["episode_lengths"] != [MONITOR_STEPS] or not info.get("TimeLimit.truncated"):
        raise AssertionError(f"Monitor: stats {stats}, info {info}")
    if encoders and not size:
        raise AssertionError("Monitor: an encoder is present but no video was written")
    return {"encoders": encoders, "episode_lengths": stats["episode_lengths"],
            "episode_files": files, "video_bytes": size, "wall_s": wall}


def _train_cli(args: list, label: str) -> tuple[str, float]:
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "multi_car_racing_tpu_torch.train", *args],
                         cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                         text=True, timeout=300)
    wall = time.perf_counter() - t0
    if out.returncode != 0:
        raise AssertionError(f"train.py ({label}) exited {out.returncode}: "
                             f"{out.stderr[-2000:]}")
    return out.stdout, wall


def train_cli_phase() -> dict:
    """Phase 26: ``python -m multi_car_racing_tpu_torch.train`` on the card
    as a user runs it: 3 updates at CarRacing-v0, E = 256, an 8-episode
    evaluation at update 3, checkpoint and JSONL log; then ``--resume`` for
    one more update through ``train.main`` in this process. Every row
    finite, the resume at update 3, and scripts/curve.py reads the log."""
    os.makedirs(SMOKE_DIR, exist_ok=True)
    log, ck = os.path.join(SMOKE_DIR, "train.jsonl"), os.path.join(SMOKE_DIR, "ckpt")
    if os.path.exists(log):
        os.remove(log)
    first, wall1 = _train_cli([*TRAIN_ARGS, "--updates", "3", "--checkpoint", ck,
                               "--log", log], "3 updates")
    # The resume runs the same entry point in this process (a second
    # process start costs ~10 s of this phase's budget).
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main([*TRAIN_ARGS, "--updates", "1", "--resume", ck, "--log", log])
    second, wall2 = buf.getvalue(), time.perf_counter() - t0
    rows = [json.loads(line) for line in open(log)]
    bad = [(r.get("update"), k) for r in rows for k, v in r.items()
           if isinstance(v, float) and not np.isfinite(v)]
    updates = [r["update"] for r in rows]
    curve = subprocess.run([sys.executable, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "scripts", "curve.py"), log], capture_output=True, text=True, timeout=60)
    evals = [r for r in rows if "eval_return" in r]
    train_rows = [r for r in rows if "loss" in r]
    for line in (first + second).strip().splitlines():
        phase(f"train.py | {line}")
    phase(f"train.py: 3 updates + eval in {wall1:.2f} s (with the process's start), resume + "
          f"1 update in {wall2:.2f} s (train.main in this process); rows {updates}; curve.py: "
          f"{curve.stdout.strip().splitlines()[-1] if curve.stdout.strip() else curve.stderr}")
    if bad or updates != [1, 2, 3, 3, 4] or "resumed from" not in second or not evals:
        raise AssertionError(f"train.py: non-finite {bad}, updates {updates}")
    if curve.returncode != 0 or "| 3 |" not in curve.stdout:
        raise AssertionError(f"curve.py did not read the log: {curve.stdout} {curve.stderr}")
    return {"wall_s": wall1, "resume_in_process_s": wall2, "updates": updates,
            "env_steps_per_sec": [r.get("env_steps_per_sec") for r in train_rows],
            "update_s": [r["update_s"] for r in train_rows],
            "eval": {k: evals[0][k] for k in ("eval_return", "eval_return_std", "eval_len",
                                              "eval_tiles_frac", "eval_episodes")}}


def learner_tensors(ts) -> list:
    """What every rank must hold alike: the parameters, Adam's moments and
    count, obs_rms and the generator's state."""
    out = [*ts.net.parameters(), *ts.opt.mu, *ts.opt.nu, ts.opt.count, ts.generator.get_state()]
    if ts.obs_rms is not None:
        out += [ts.obs_rms[k] for k in sorted(ts.obs_rms)]
    return out


def dp_updates(step, ts, label: str, env_steps: int, updates: int,
               world: mesh.World = mesh.World()):
    """``updates`` train steps: each one's wall seconds, env-steps/s (of
    ``env_steps``, this rank's), metrics, and the hash of learner_tensors
    (checked equal on every rank of ``world``)."""
    out = []
    for u in range(updates):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ts, metrics = step(ts)
        metrics = {k: float(v) for k, v in metrics.items()}
        wall = time.perf_counter() - t0
        h = world.check_replicated(learner_tensors(ts), f"{label} update {u + 1}")
        out.append({"wall_s": wall, "env_steps_per_s": env_steps / wall, "hash": h,
                    "metrics": metrics})
        bad = [k for k, v in metrics.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{label} update {u + 1}: metrics not finite: {bad}")
    return ts, out


def remove_checkpoint(path: str) -> None:
    """Delete a checkpoint's two slots and pointer once its phase has read
    it back, so the checkout's disk holds one checkpoint at a time."""
    for name in checkpoint._slots(path):
        if os.path.exists(name):
            os.remove(name)


# The last line of a rank that died of gloo's sockets or of the rendezvous.
TRANSPORT_ERRORS = ("DistNetworkError", "DistStoreError", "Connection closed",
                    "Connection reset", "Connection refused", "Address already in use")


def transport_failure(out: str) -> bool:
    """Whether a rank's output ends in an error of the connection between
    the ranks rather than of the work or of a check."""
    last = out.strip().splitlines()[-1:]
    return bool(last) and any(e in last[0] for e in TRANSPORT_ERRORS)


def metric_misses(got: dict, want: dict) -> dict:
    """{key: |got - want| / max(1, |want|)} over the metrics past DP_METRIC_TOL."""
    rel = {k: abs(got[k] - v) / max(1.0, abs(v)) for k, v in want.items()}
    return {k: r for k, r in rel.items() if not r <= DP_METRIC_TOL}


def world_of_one_phase(smi: str, dev: torch.device) -> dict:
    """Phase 31: the state recipe's learner, two updates from one start, run
    twice without a world and once in a world of one over NCCL
    (parallel.mesh.init in this process): the world's metrics and learner
    bytes equal the plain runs' wherever those repeat each other byte for
    byte, else its metrics within DP_METRIC_TOL."""
    env_cfg, pcfg = state_recipe()
    os.makedirs(DP_DIR, exist_ok=True)
    start = os.path.join(DP_DIR, "world_of_one_start")
    t0 = time.perf_counter()
    checkpoint.save(start, lppo.init_train_state(env_cfg, pcfg, LEARNER_SEED, dev))
    init_s = time.perf_counter() - t0
    env_steps = pcfg.num_envs * pcfg.rollout_len * pcfg.action_repeat
    runs = {}
    for label in ("one process", "one process again"):
        ts = checkpoint.restore(start, device=dev)
        runs[label] = dp_updates(lppo.make_train_step(env_cfg, pcfg), ts, label, env_steps,
                                 DP_UPDATES)[1]
    t0 = time.perf_counter()
    world, wdev = mesh.init(f"127.0.0.1:{mesh.free_port()}", 1, 0, dev)
    init_group_s = time.perf_counter() - t0
    try:
        if world.backend != "nccl":
            raise AssertionError(f"a world of one on a card chose {world.backend}, not nccl")
        ts = checkpoint.restore(start, device=wdev, world=world)
        zero_counts()
        runs["world of one"] = dp_updates(lppo.make_train_step(env_cfg, pcfg, world), ts,
                                          "world of one", env_steps, DP_UPDATES, world)[1]
        counts = read_counts()
    finally:
        mesh.shutdown()
    remove_checkpoint(start)
    check_counts("world of one", counts,
                 DP_UPDATES * (pcfg.rollout_len * pcfg.action_repeat + 1), 0, 1)
    one, again, dist_run = runs["one process"], runs["one process again"], runs["world of one"]
    repeats = all(a["hash"] == b["hash"] and a["metrics"] == b["metrics"]
                  for a, b in zip(one, again))
    same = all(a["hash"] == d["hash"] and a["metrics"] == d["metrics"]
               for a, d in zip(one, dist_run))
    misses = [metric_misses(d["metrics"], a["metrics"]) for a, d in zip(one, dist_run)]
    for label, run in runs.items():
        phase(f"{label}: " + "; ".join(
            f"update {u + 1} {r['wall_s']:.3f} s = {r['env_steps_per_s']:.1f} env-steps/s, "
            f"loss {r['metrics']['loss']:.6g}, learner hash {r['hash'][:16]}"
            for u, r in enumerate(run)) + f" on {smi}")
    phase(f"world of one: backend {world.backend}, process group {init_group_s:.3f} s; init "
          f"{init_s:.3f} s; the plain run repeats itself byte for byte: {repeats}; the world "
          f"of one equals it byte for byte: {same}; metrics past {DP_METRIC_TOL}: {misses}; "
          f"launches {counts}")
    if (repeats and not same) or any(misses):
        raise AssertionError("the world of one differs from the run without a world")
    return {"backend": world.backend, "init_s": init_s, "process_group_s": init_group_s,
            "plain_repeats_bytes": repeats, "world_equals_plain_bytes": same,
            "launches": counts, "runs": runs}


def rank_drill(argv: list) -> int:
    """One rank of phase 32 (``chip_smoke.py --rank-drill RANK PORT DIR``):
    the state recipe (one update) and the pixel recipe (DP_UPDATES updates,
    then a collective checkpoint) on its rows; writes DIR/rank<r>.json and
    its pixel rows to DIR/rows<r>.pt."""
    rank, port, out_dir = int(argv[0]), int(argv[1]), argv[2]
    if not torch.cuda.is_available():
        return 2
    world, dev = mesh.init(f"127.0.0.1:{port}", DP_RANKS, rank, "cuda")
    res = {"rank": rank, "backend": world.backend, "device": str(dev)}
    try:
        # The backend's broadcast on a card tensor (train.py's evaluation
        # decision); the sums, maxima and gathers run in the steps below.
        got = float(world.broadcast(torch.full((1,), float(rank + 1), device=dev)))
        if got != 1.0:
            raise AssertionError(f"rank {rank}: broadcast gave {got}, not rank 0's 1.0")
        for label, (env_cfg, pcfg), updates in (("state", state_recipe(), 1),
                                                ("pixels", pixel_recipe(), DP_UPDATES)):
            lo, hi = world.rows(pcfg.num_envs)
            t0 = time.perf_counter()
            ts = lppo.init_train_state(env_cfg, pcfg, LEARNER_SEED, dev, world)
            torch.cuda.synchronize()
            init_s = time.perf_counter() - t0
            zero_counts()
            ts, ups = dp_updates(lppo.make_train_step(env_cfg, pcfg, world), ts,
                                 f"rank {rank} {label}", (hi - lo) * pcfg.rollout_len *
                                 pcfg.action_repeat, updates, world)
            res[label] = {"rows": [lo, hi], "init_s": init_s, "updates": ups,
                          "launches": read_counts()}
            res[label]["max_reserved_gib"] = torch.cuda.max_memory_reserved(dev) / 2**30
            print(f"rank {rank} {label}: rows {lo}:{hi}, init {init_s:.3f} s, " + "; ".join(
                f"update {u + 1} {r['wall_s']:.3f} s = {r['env_steps_per_s']:.1f} env-steps/s"
                for u, r in enumerate(ups)) + f"; at most {res[label]['max_reserved_gib']:.2f}"
                " GiB reserved", flush=True)
        t0 = time.perf_counter()
        checkpoint.save(os.path.join(out_dir, "pixels_ckpt"), ts, world)
        res["pixels"]["checkpoint_s"] = time.perf_counter() - t0
        torch.save({"env_state": [x.cpu() for x in tree_leaves(ts.env_state)],
                    "frames": ts.frames.cpu()}, os.path.join(out_dir, f"rows{rank}.pt"))
    finally:
        mesh.shutdown()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def two_rank_phase(smi: str, dev: torch.device, state_reference: list) -> dict:
    """Phase 32: DP_RANKS processes sharing the card over gloo (rank_drill).
    Each rank's counts equal its steps and frames; the learner hashes are
    equal across ranks after every update; the state recipe's update 1
    matches the one-process run of phase 31 within DP_METRIC_TOL; the
    two-rank checkpoint, restored here, equals the ranks' rows joined and
    hashes as the ranks' learner."""
    if os.path.isdir(DP_DIR):
        for name in os.listdir(DP_DIR):
            if name.startswith(("rank", "rows", "pixels_ckpt")):
                os.remove(os.path.join(DP_DIR, name))
    os.makedirs(DP_DIR, exist_ok=True)
    phase(f"this process holds {torch.cuda.memory_reserved(dev) / 2**30:.2f} GiB of the card "
          f"reserved as the ranks start; the checkout's disk has "
          f"{shutil.disk_usage(DP_DIR).free / 2**30:.2f} GiB free")
    for attempt in (1, 2):
        port = mesh.free_port()
        codes, outs, wall = mesh.run_processes(
            [[sys.executable, os.path.abspath(__file__), "--rank-drill", str(r), str(port),
              DP_DIR] for r in range(DP_RANKS)], cwd=os.path.dirname(os.path.abspath(__file__)),
            timeout=DP_TIMEOUT, logs=[os.path.join(DP_DIR, f"rank{r}.log")
                                      for r in range(DP_RANKS)])
        for r, (code, out) in enumerate(zip(codes, outs)):
            for line in out.strip().splitlines()[-12:]:
                phase(f"rank {r} | {line}")
        failed = [r for r, code in enumerate(codes) if code != 0]
        for r in failed:
            # The end of a failed rank's log goes to stderr as well, beside
            # the traceback below, where a reader of the error stream alone
            # sees it.
            print(f"[chip_smoke] attempt {attempt}: rank {r} exited {codes[r]} with "
                  f"{shutil.disk_usage(DP_DIR).free / 2**30:.2f} GiB free on the checkout's "
                  "disk; the end of its output:\n"
                  + "\n".join(outs[r].strip().splitlines()[-40:]), file=sys.stderr, flush=True)
        # One relaunch on a fresh port, as the tests' launcher does, and only
        # when every failed rank died of the sockets or the rendezvous: a
        # failed check of the port's own ends the phase.
        if not failed or attempt == 2 or not all(transport_failure(outs[r]) for r in failed):
            break
        phase(f"ranks {failed} lost their connection (attempt 1, {wall:.1f} s): relaunching "
              "once on a fresh port")
    if failed:
        raise AssertionError(f"ranks {failed} exited {[codes[r] for r in failed]} "
                             f"(phase 32, attempt {attempt}, {wall:.1f} s)")
    res = [json.load(open(os.path.join(DP_DIR, f"rank{r}.json"))) for r in range(DP_RANKS)]
    pcfg_s, pcfg_p = state_recipe()[1], pixel_recipe()[1]
    for r in res:
        if r["backend"] != "gloo":
            raise AssertionError(f"ranks sharing a card chose {r['backend']}, not gloo")
        check_counts(f"rank {r['rank']} state", r["state"]["launches"],
                     pcfg_s.rollout_len * pcfg_s.action_repeat + 1, 0, 1)
        check_counts(f"rank {r['rank']} pixels", r["pixels"]["launches"],
                     DP_UPDATES * (pcfg_p.rollout_len * pcfg_p.action_repeat + 1),
                     DP_UPDATES * (pcfg_p.rollout_len + 1), 2)
    for label in ("state", "pixels"):
        for u in range(len(res[0][label]["updates"])):
            ups = [r[label]["updates"][u] for r in res]
            if len({x["hash"] for x in ups}) != 1 or any(x["metrics"] != ups[0]["metrics"]
                                                         for x in ups):
                raise AssertionError(f"{label} update {u + 1}: the ranks differ")
    state_misses = metric_misses(res[0]["state"]["updates"][0]["metrics"],
                                 state_reference[0]["metrics"])
    back = checkpoint.restore(os.path.join(DP_DIR, "pixels_ckpt"), device=dev)
    rows = [torch.load(os.path.join(DP_DIR, f"rows{r}.pt"), weights_only=True)
            for r in range(DP_RANKS)]
    joined = all(torch.equal(leaf.cpu(), torch.cat([part["env_state"][i] for part in rows]))
                 for i, leaf in enumerate(tree_leaves(back.env_state)))
    joined = joined and torch.equal(back.frames.cpu(), torch.cat([p["frames"] for p in rows]))
    hash_same = mesh.tensor_hash(learner_tensors(back)) == res[0]["pixels"]["updates"][-1]["hash"]
    remove_checkpoint(os.path.join(DP_DIR, "pixels_ckpt"))
    for r in range(DP_RANKS):
        os.remove(os.path.join(DP_DIR, f"rows{r}.pt"))
    phase(f"two ranks on one card ({res[0]['backend']}): {wall:.1f} s with the processes' "
          f"start (attempt {attempt}); state update 1 against the one-process run: metrics past "
          f"{DP_METRIC_TOL}: {state_misses}; the checkpoint restored here equals the rows "
          f"joined: {joined}, the learner's hash the ranks': {hash_same}; " + "; ".join(
              f"rank {r['rank']} rows {r[k]['rows']} {k} " + ", ".join(
                  f"{x['env_steps_per_s']:.1f}" for x in r[k]["updates"]) + " env-steps/s"
              for r in res for k in ("state", "pixels")) + f" on {smi}")
    if state_misses or not joined or not hash_same:
        raise AssertionError("phase 32: the two ranks do not compute the one-process step, "
                             "or their checkpoint does not hold their rows")
    return {"wall_s": wall, "attempts": attempt, "ranks": res,
            "state_update1_misses": state_misses,
            "checkpoint_rows_joined": joined, "checkpoint_hash_equal": hash_same}


def demo_phase(dev: torch.device) -> dict:
    """Phase 33: ``demo.main`` for DEMO_STEPS steps on the card at N = 2
    (the track follower), writing a GIF; counts zeroed before it: one K2 and
    one K4/K5 per step and for the reset's spawn tick, one K6 per frame
    (the reset's and each step's), nothing else."""
    from PIL import Image

    out = os.path.join(DP_DIR, "demo.gif")
    zero_counts()
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        total = demo.main(["--steps", str(DEMO_STEPS), "--out", out, "--num-cars", "2"])
    wall = time.perf_counter() - t0
    counts = read_counts()
    for line in buf.getvalue().strip().splitlines():
        phase(f"demo.py | {line}")
    check_counts("demo", counts, DEMO_STEPS + 1, DEMO_STEPS + 1, 2)
    with Image.open(out) as gif:
        frames, size = gif.n_frames, gif.size
    phase(f"demo.py: {DEMO_STEPS} steps in {wall:.3f} s (reset and GIF included); returns "
          f"{[float(x) for x in total]}; GIF {frames} frames of {size}; launches {counts}")
    if frames < 2 or not np.isfinite(total).all():
        raise AssertionError(f"demo: {frames} GIF frames, returns {total}")
    return {"wall_s": wall, "returns": [float(x) for x in total], "gif_frames": frames,
            "launches": counts}


def trackgen_episode_phase(smi: str, dev: torch.device) -> dict:
    """Phase 36: the native track generator against the Python walk, its use
    by reset_batch, and the follower closed-loop on the card against the
    plain path on the CPU on the same actions."""
    t0 = time.perf_counter()
    if native.load() is None:
        raise AssertionError(f"the native track generator did not build: "
                             f"{native.build_error()}")
    build_s = time.perf_counter() - t0
    walk_s = fast_s = 0.0
    retried = 0
    for seed in TRACKGEN_SEEDS:
        fast_rng, walk_rng = seeding.np_random(seed)[0], seeding.np_random(seed)[0]
        for _ in range(2):              # the second track continues the stream
            t = time.perf_counter()
            fast = thost.generate_track_fast(fast_rng)
            fast_s += time.perf_counter() - t
            t = time.perf_counter()
            walk = thost.generate_track(walk_rng)
            walk_s += time.perf_counter() - t
            if not (np.array_equal(fast[0], walk[0]) and np.array_equal(fast[1], walk[1])
                    and fast[2] == walk[2]):
                raise AssertionError(f"native track of seed {seed} differs from the walk's")
            retried += fast[2] > 0
        if not np.array_equal(fast_rng.random_sample(16), walk_rng.random_sample(16)):
            raise AssertionError(f"seed {seed}: the native stream does not continue the walk's")
    tracks = 2 * len(TRACKGEN_SEEDS)
    phase(f"native generator built/loaded in {build_s:.2f} s; {tracks} tracks of seeds "
          f"{TRACKGEN_SEEDS[0]}-{TRACKGEN_SEEDS[-1]} ({retried} after a retry) bit-equal to the "
          f"Python walk, the next 16 draws equal; {1e3 * fast_s / tracks:.3f} ms a track "
          f"against the walk's {1e3 * walk_s / tracks:.3f} (host CPU)")
    cfg = EnvConfig(num_agents=FOLLOW_N)
    native.generate_track.calls = 0
    penv.reset_batch(cfg, TRACKGEN_SEEDS, len(TRACKGEN_SEEDS))
    if native.generate_track.calls != len(TRACKGEN_SEEDS):
        raise AssertionError(f"reset_batch made {native.generate_track.calls} native tracks, "
                             f"expected {len(TRACKGEN_SEEDS)}")

    zero_counts()
    t = time.perf_counter()
    card = oep.run_episodes_closed(cfg, FOLLOW_RESETS, max_steps=FOLLOW_STEPS)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t
    counts = read_counts()
    want = {"k1": 0, "k2": FOLLOW_STEPS + 1, "k3": 0, "k4_k5": FOLLOW_STEPS + 1, "k6": 0,
            "plain_track_calls": 0, "plain_paint_calls": 0}       # + the spawn tick
    if counts != want:
        raise AssertionError(f"follower run: launch counts {counts}, expected {want}")
    if not card["finite"].all():
        raise AssertionError("follower run: a car's state went nonfinite on the card")
    t = time.perf_counter()
    plain = oep.run_episodes_open(cfg, FOLLOW_RESETS, card["actions"], device="cpu")
    plain_s = time.perf_counter() - t
    # Before the first contact in either run, the two paths follow one
    # trajectory up to float32 noise; past it, the system is chaotic.
    first = np.where(card["contact_step"] >= 0, card["contact_step"], FOLLOW_STEPS)
    first = np.minimum(first, np.where(plain["contact_step"] >= 0, plain["contact_step"],
                                       FOLLOW_STEPS))
    before = np.arange(FOLLOW_STEPS)[:, None] < first[None]
    err = float(np.abs(card["rewards"] - plain["rewards"]).max(-1)[before].max(initial=0.0))
    out = {"build_s": build_s, "tracks": tracks, "retried": int(retried),
           "native_ms_per_track": 1e3 * fast_s / tracks,
           "walk_ms_per_track": 1e3 * walk_s / tracks, "follower_launches": counts,
           "follower_card_s": card_s, "follower_plain_cpu_s": plain_s,
           "steps_with_near_env": int((card["near"] > 0).sum()),
           "contact_step_card": card["contact_step"].tolist(),
           "contact_step_plain": plain["contact_step"].tolist(),
           "steps_compared": int(before.sum()), "reward_max_abs_err": err,
           "returns_card": card["rewards"].sum(0).sum(-1).tolist(),
           "returns_plain": plain["rewards"].sum(0).sum(-1).tolist()}
    phase(f"follower closed loop N={FOLLOW_N}, E={FOLLOW_E}, {FOLLOW_STEPS} steps on {smi}: "
          f"{card_s:.2f} s, launches {counts}, K2 near envs in {out['steps_with_near_env']} "
          f"steps, first contact steps {out['contact_step_card']}; the plain path on the CPU "
          f"on its actions {plain_s:.2f} s, first contacts {out['contact_step_plain']}; "
          f"max |reward card - plain| {err:.3g} over {out['steps_compared']} env-steps before "
          f"the first contact")
    if err > BONUS_TOL or out["steps_compared"] == 0:
        raise AssertionError(f"follower run: rewards on the card differ from the plain path's "
                             f"by {err:.3g} before the first contact (bar {BONUS_TOL})")
    return out


def report(name: str, source: str, replaces: str, launches: int, max_abs_err: float,
           max_err_over_bar: float, times: dict, **extra) -> dict:
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_abs_err,
            "max_err_over_bar": max_err_over_bar, **times, "library_ms": None, **extra}


def main() -> int:
    start = time.perf_counter()
    phase("1/36 device")
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

    phase("2/36 build (one nvcc per kernel, started together)")
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

    phase(f"3/36 K1 vs plain at E={E} after 20 steps")
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

    phase(f"4/36 small input: {len(SMALL_SEEDS)} envs x {SMALL_STEPS} steps, card vs CPU")
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

    phase(f"5/36 N=1 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
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
    phase(f"6/36 K2 vs plain at N=2, E={E}, driven until {NEAR_SHARE:.0%} of envs are near")
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

    phase("7/36 rear-end ram (N=4, E=1): K2 vs plain at the first step with contact")
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

    phase(f"7/36 (cont.) N=4, E={N4_E}, driven until {NEAR_SHARE:.0%} of envs are near: K2 vs "
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

    phase("8/36 determinism: two K2 launches on phase 6's input")
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
    phase(f"9/36 K3 vs plain at N=2, E={E}, full {cfg2.velocity_iters}/"
          f"{cfg2.position_iters}, on phase 6's input (plain tire model, Collide, make_bundle)")
    solve2 = solve_inputs(pre, state.wheel_on_road, cs_pre, 2)
    devs3 = compare_solve(solve2, 2, "K3 vs plain (N=2)")

    phase("10/36 K3 vs plain on phase 7's ram (N=4, E=1) and at N=1, E=4096 (no bundle)")
    devs3.update({f"ram {f}": v for f, v in compare_solve(
        solve_inputs(ram_pre, ram.wheel_on_road, ram.contacts, 4), 4,
        "K3 vs plain (ram, N=4)").items()})
    devs3.update({f"N=1 {f}": v for f, v in compare_solve(
        solve_inputs(pre1, road1, None, 1), 1, "K3 vs plain (N=1)").items()})

    phase("11/36 K2 vs plain Collide + K3 on phase 6's input")
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

    phase(f"12/36 K3 determinism and times at N=2, E={E} on phase 6's input, beside K2 on {smi}")
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

    phase(f"13/36 N=2 main path: reset_batch E={E} ({len(SEEDS)} tracks) + {WARMUP} "
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

    phase(f"14/36 K4/K5 vs plain at E={E}, N=1 and N=2, and E={N4_E}, N=4: a stepped state, "
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

    phase(f"15/36 state-PPO rollout: E={E}, N={ROLLOUT_N}, pool of {len(POOL_SEEDS)} host "
          f"tracks, chunks of {ROLLOUT_CHUNK} steps, past the time limit")
    rollout = rollout_phase(smi, dev)

    phase("16/36 K6 vs plain: N=2 spawn tick, steady, mid zoom, camera jitter, mixed and "
          "backward at E=4096; N=1 CW; N=4 ego colour; the golden frames")
    pool = penv.make_host_track_pool(EnvConfig(num_agents=2), POOL_SEEDS, device=dev)
    t16 = time.perf_counter()
    px_checks = pixel_checks(dev, pool)
    phase(f"phase 16 took {time.perf_counter() - t16:.1f} s")

    phase(f"17/36 pixel main path: reset_batch E={E}, N=2 + {WARMUP} warm-up + {T} steps, a "
          f"frame after the reset and after every step")
    t17 = time.perf_counter()
    px_run = pixel_main_path(smi, dev)
    phase(f"phase 17 took {time.perf_counter() - t17:.1f} s")

    phase(f"18/36 pixel-PPO env side: E={PPO_E}, N=2, {PPO_CHUNKS} chunks of {PPO_DECISIONS} "
          f"decisions x {PPO_REPEAT} steps, autoreset, past the time limit")
    px_rollout = pixel_rollout_phase(smi, dev, pool)
    learner = learner_phases(smi, dev)
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
    phase("23/36 the Gym facade on the card: MultiCarRacing-v0 and CarRacing-v0, "
          f"{FACADE_STEPS} steps each")
    t23 = time.perf_counter()
    facade = {env_id: facade_phase(env_id, smi, dev)
              for env_id in ("MultiCarRacing-v0", "CarRacing-v0")}
    seconds = {"23": time.perf_counter() - t23}
    phase("24/36 the 600x400 rgb_array painter on the card: the golden frame, and a frame "
          "after hard braking")
    t = time.perf_counter()
    facade["rgb_array"] = rgb_array_phase(smi, dev)
    seconds["24"] = time.perf_counter() - t
    phase("25/36 Monitor: one short episode")
    t = time.perf_counter()
    facade["monitor"] = monitor_phase(dev)
    seconds["25"] = time.perf_counter() - t
    phase("26/36 python -m multi_car_racing_tpu_torch.train: 3 updates, an evaluation, "
          "a checkpoint, then --resume")
    t = time.perf_counter()
    facade["train_cli"] = train_cli_phase()
    seconds["26"] = time.perf_counter() - t
    facade["seconds"] = seconds
    phase(f"phases 23-26 took {time.perf_counter() - t23:.1f} s: " + ", ".join(
        f"phase {k} {v:.1f} s" for k, v in seconds.items()))
    phase(f"27/36 tracks generated on the card: a checked pool of {GEN_POOL}, device_reset at "
          f"E={E}, N=2, and one attempt on the card against the CPU on the same uniforms")
    t = time.perf_counter()
    generation = generation_phase(smi, dev)
    seconds = {"27": time.perf_counter() - t}
    phase(f"28/36 VectorMultiCarRacing on the card: E={E}, N=2, obs=pixels, time limit "
          f"{VEC_LIMIT}, {VEC_STEPS} steps")
    t = time.perf_counter()
    vector = {"pixels": vector_phase("pixels", 2, smi, dev)}
    seconds["28"] = time.perf_counter() - t
    phase(f"29/36 VectorMultiCarRacing on the card: obs=state at N=1 (K1), obs=none at N=2")
    t = time.perf_counter()
    vector["state"] = vector_phase("state", 1, smi, dev)
    vector["none"] = vector_phase("none", 2, smi, dev)
    seconds["29"] = time.perf_counter() - t
    phase(f"30/36 K2 and K3 past shared memory: the scratch layout at N={NARROW_NS} and "
          f"N={WIDE_NS}, and past one car a lane at N={PAST_WARP_NS}, E={WIDE_E}, against the "
          f"plain versions")
    t = time.perf_counter()
    wide, wide_states_past = wide_contact_phase(dev, smi)
    seconds["30"] = time.perf_counter() - t
    phase("phases 27-30 took " + ", ".join(f"phase {k} {v:.1f} s" for k, v in seconds.items()))
    phase(f"31/36 a world of one over NCCL in this process: the state recipe, {DP_UPDATES} "
          f"updates, against the same updates without a world")
    t = time.perf_counter()
    dp = {"world_of_one": world_of_one_phase(smi, dev)}
    seconds = {"31": time.perf_counter() - t}
    phase(f"32/36 {DP_RANKS} ranks sharing the card over gloo (processes): the state recipe "
          f"(1 update) and the pixel recipe ({DP_UPDATES} updates, a checkpoint)")
    t = time.perf_counter()
    dp["two_ranks"] = two_rank_phase(smi, dev, dp["world_of_one"]["runs"]["one process"])
    seconds["32"] = time.perf_counter() - t
    phase(f"33/36 demo.py on the card: {DEMO_STEPS} steps at N=2, a GIF")
    t = time.perf_counter()
    dp["demo"] = demo_phase(dev)
    seconds["33"] = time.perf_counter() - t
    dp["seconds"] = seconds
    phase("phases 31-33 took " + ", ".join(f"phase {k} {v:.1f} s" for k, v in seconds.items()))
    for k, name in ((k2, "k2"), (k3, "k3")):
        k["past_shared_memory"] = {
            lab: {"ms": r[name]["ms"], "bound_ms": r[name]["bound_ms"],
                  "bound_by": r[name]["bound_by"], "scratch_slots": r["scratch_slots"][name],
                  "warp_bytes": r["warp_bytes"], "max_err_over_bar": max(
                      v for key, v in r["max_err_over_bar"].items() if key.startswith(name))}
            for lab, r in wide.items() if "k2" in r}
    phase(f"34/36 past 32 cars an env: K4/K5 and K6 against plain at N={PAST_WARP_NS}, "
          f"E={WIDE_E}, and MultiCarRacing-v0 with num_agents={PAST_WARP_NS[0]} on the card")
    t = time.perf_counter()
    past_warp = past_warp_phase(wide_states_past, dev, smi)
    phase(f"phase 34 took {time.perf_counter() - t:.1f} s")
    for k, name in ((k2, "k2"), (k3, "k3"), (k45, "k4_k5"), (k6, "k6")):
        src = wide if name in ("k2", "k3") else past_warp
        k["past_32_cars"] = {
            f"N={n}": {f: src[f"N={n}"][name][f] for f in ("ms", "plain_ms", "bound_ms",
                                                            "bound_by")}
            for n in PAST_WARP_NS}
    for k, name in ((k2, "k2"), (k45, "k4_k5"), (k6, "k6")):
        k["past_32_cars"]["facade_launches"] = past_warp["facade"]["launches"][name]
    phase("36/36 the native host track generator against the Python walk, reset_batch on it, "
          f"and the track follower closed-loop at N={FOLLOW_N}, E={FOLLOW_E} for "
          f"{FOLLOW_STEPS} steps on the card against the plain path on the CPU")
    t = time.perf_counter()
    trackgen = trackgen_episode_phase(smi, dev)
    trackgen["seconds"] = time.perf_counter() - t
    phase(f"phase 36 took {trackgen['seconds']:.1f} s")
    phase(f"35/36 report: every phase passed in {time.perf_counter() - start:.1f} s")
    print(json.dumps({"learner": learner}), flush=True)
    print(json.dumps({"facade": facade}), flush=True)
    print(json.dumps({"generation": generation, "vector": vector,
                      "past_shared_memory": wide, "past_32_cars": past_warp}), flush=True)
    print(json.dumps({"data_parallel": dp}), flush=True)
    print(json.dumps({"trackgen_and_follower": trackgen}), flush=True)
    print(json.dumps({"kernels": [k1, k2, k3, k45, k6], "rollout": rollout,
                      "pixel_main_path": {k: v for k, v in px_run.items()},
                      "pixel_rollout": px_rollout}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank-drill"]:
        sys.exit(rank_drill(sys.argv[2:]))
    sys.exit(main())
