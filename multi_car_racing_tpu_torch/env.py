"""Environment core: batched EnvState + reset/step over E lockstep envs.

Port of the JAX package's ``env.py`` for one car per env (CarRacing-v0 and
MultiCarRacing-v0 at ``num_agents=1``). Every tensor carries the env axis
first; the JAX package's single-env shapes follow it.

Step order preserves the reference's (mcr:410-509 + Box2D internals):
  1. apply controls (steer/gas/brake setters)
  2. the fused physics stage (``physics/fused_world.island_step``): tire
     forces from the *lagged* tile contacts (Box2D collides at the start of
     world.Step), joint limit init, constraint solve + integration
  3. the track stage on the pre-solve pose: wheel-tile SAT (friction mask
     for the next step), tile-visit rewards (FrictionDetector, mcr:80-123),
     render color flattening; then nearest-tile heading and the on-grass
     flag on the post-solve pose
  4. post-step analysis: -0.1 step cost, backward/on-grass flags,
     all-tiles-visited / off-playfield termination (mcr:433-508)

Car-car contacts (``num_agents > 1``) and skid trails are the next slices:
``step`` raises ``NotImplementedError`` for them rather than computing
something else.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from . import config as C
from . import seeding
from .physics import overlap
from .physics.fused_world import island_step
from .physics.state import CarState, apply_controls, create_cars
from .track import host as track_host
from .track.common import Track, pack_track_arrays, track_from_arrays
from .util import resolve_device, tree_map

M_PER_PAIR = 48          # fixture pairs per car pair (collide.py, next slice)
MAX_SEGMENTS = 256       # skid segments per car (render/particles.py)


@dataclasses.dataclass(frozen=True)
class ContactState:
    """Car-car contact warm-start carry; all zeros at one car per env."""
    normal_imp: torch.Tensor    # (E, MM, 2)
    tangent_imp: torch.Tensor   # (E, MM, 2)
    ids: torch.Tensor           # (E, MM) int32


@dataclasses.dataclass(frozen=True)
class SkidState:
    """Render-only tire-mark trails (kept at their initial values)."""
    seg: torch.Tensor      # (E, N, K, 4)
    grass: torch.Tensor    # (E, N, K) bool
    valid: torch.Tensor    # (E, N, K) bool
    head: torch.Tensor     # (E, N) int32
    prev: torch.Tensor     # (E, N, 4, 2)
    active: torch.Tensor   # (E, N, 4) bool


@dataclasses.dataclass(frozen=True)
class EnvState:
    cars: CarState
    track: Track
    wheel_on_road: torch.Tensor      # (E, N, 4) bool — lagged tile contact per wheel
    visited: torch.Tensor            # (E, N, MT) bool — per-car visited tiles
    tile_touched: torch.Tensor       # (E, MT) bool — any-fixture contact (render)
    reward: torch.Tensor             # (E, N) cumulative score (mcr:145)
    prev_reward: torch.Tensor        # (E, N)
    tile_visited_count: torch.Tensor  # (E, N) int32
    driving_backward: torch.Tensor   # (E, N) bool
    driving_on_grass: torch.Tensor   # (E, N) bool
    direction_cw: torch.Tensor       # (E,) bool — episode direction is CW
    t: torch.Tensor                  # (E,) f32 sim time
    steps: torch.Tensor              # (E,) int32 steps since reset
    done: torch.Tensor               # (E,) bool
    contacts: ContactState
    skid: SkidState

    def replace(self, **updates) -> "EnvState":
        return dataclasses.replace(self, **updates)


def _check_supported(cfg: C.EnvConfig):
    if cfg.num_agents != 1:
        raise NotImplementedError(
            "num_agents > 1 needs car-car contacts, the next slice of the "
            "PyTorch port (collide.py, the full-contact island kernel and the "
            "broadphase partition)"
        )
    if cfg.track_skid:
        raise NotImplementedError("skid trails belong to the rendering slice of the port")
    if cfg.exact_hull_touch:
        raise NotImplementedError("exact_hull_touch belongs to the rendering slice of the port")


def _episode_start(cars: CarState, track: Track, direction_cw: torch.Tensor,
                   num_agents: int) -> EnvState:
    E, n, mt = direction_cw.shape[0], num_agents, track.max_tiles
    dev, f32 = track.xy.device, track.xy.dtype
    mm = max(n * (n - 1) // 2 * M_PER_PAIR, 1)

    def z(*shape, dtype=f32):
        return torch.zeros((E,) + shape, dtype=dtype, device=dev)

    return EnvState(
        cars=cars,
        track=track,
        wheel_on_road=z(n, 4, dtype=torch.bool),
        visited=z(n, mt, dtype=torch.bool),
        tile_touched=z(mt, dtype=torch.bool),
        reward=z(n),
        prev_reward=z(n),
        tile_visited_count=z(n, dtype=torch.int32),
        driving_backward=z(n, dtype=torch.bool),
        driving_on_grass=z(n, dtype=torch.bool),
        direction_cw=direction_cw.to(torch.bool),
        t=z(),
        steps=z(dtype=torch.int32),
        done=z(dtype=torch.bool),
        contacts=ContactState(
            normal_imp=z(mm, 2), tangent_imp=z(mm, 2),
            ids=torch.full((E, mm), -1, dtype=torch.int32, device=dev),
        ),
        skid=SkidState(
            seg=z(n, MAX_SEGMENTS, 4), grass=z(n, MAX_SEGMENTS, dtype=torch.bool),
            valid=z(n, MAX_SEGMENTS, dtype=torch.bool), head=z(n, dtype=torch.int32),
            prev=z(n, 4, 2), active=z(n, 4, dtype=torch.bool),
        ),
    )


def _contact_pass(cars: CarState, track: Track):
    """The Collide() equivalent on the given (pre-solve) pose: returns
    (wheel_on_road (E,N,4), car_tile (E,N,MT), touched (E,MT)).

    The render-only "touched" flag includes hull contact approximated by the
    hull *center* being inside a tile."""
    wheel_ov = overlap.wheel_tile_overlap(cars, track)        # (E, N, 4, MT)
    wheel_on_road = wheel_ov.any(-1)
    car_tile = wheel_ov.any(2)                                # (E, N, MT)
    hull_in = overlap.point_in_quads_T(cars.hull_origin, track.quad_T)
    touched = (car_tile | hull_in).any(1)
    return wheel_on_road, car_tile, touched


def _visit_rewards(track: Track, visited: torch.Tensor, car_tile: torch.Tensor,
                   num_agents: int):
    """FrictionDetector begin-contact bookkeeping (mcr:110-120):
    reward += (1 - past_visitors / num_agents) * 1000 / len(track) for each
    first visit, with car-id ordering for same-step ties (lowest id counts as
    the earlier visitor). Returns (bonus (E,N), new visited, count (E,N))."""
    f32 = track.xy.dtype
    new = car_tile & ~visited & track.valid[:, None, :]        # (E, N, MT)
    prev_count = visited.sum(dim=1, dtype=torch.int32)        # (E, MT)
    new_i = new.to(torch.int32)
    rank = torch.cumsum(new_i, dim=1, dtype=torch.int32) - new_i   # exclusive
    past = prev_count[:, None, :] + rank
    factor = 1.0 - past.to(f32) / num_agents
    tile_bonus = 1000.0 / track.n_tiles.to(f32)               # (E,)
    bonus = torch.sum(new.to(f32) * factor, dim=2) * tile_bonus[:, None]
    cnt = new.sum(dim=2, dtype=torch.int32)
    return bonus, visited | new, cnt


def _track_stage(track: Track, pre_cars: CarState, post_origin: torch.Tensor,
                 visited: torch.Tensor, tile_touched: torch.Tensor,
                 num_agents: int):
    """The per-step track stage: contact SAT + visit rewards + render
    flattening on the pre-solve pose, nearest-tile heading + on-grass on the
    post-solve ``post_origin`` (mcr:446-495). Plain PyTorch ops, as the JAX
    package leaves this stage to XLA by default."""
    wheel_on_road, car_tile, touched = _contact_pass(pre_cars, track)
    bonus, new_visited, cnt = _visit_rewards(track, visited, car_tile, num_agents)

    diff = post_origin[:, :, None, :] - track.xy[:, None, :, :]   # (E, N, MT, 2)
    d2 = torch.sum(torch.square(diff), dim=-1)
    d2 = torch.where(track.valid[:, None, :], d2, torch.full_like(d2, math.inf))
    nearest = torch.argmin(d2, dim=2)                         # (E, N)
    nearest_beta = torch.gather(track.beta, 1, nearest)
    in_road = overlap.point_in_quads_T(post_origin, track.quad_T)
    in_curb = overlap.point_in_quads_T(post_origin, track.curb_quad_T)
    on_grass = ~(in_road.any(-1) | in_curb.any(-1))
    return (wheel_on_road, new_visited, bonus, cnt, tile_touched | touched,
            nearest_beta, on_grass)


def _physics_and_contacts(state: EnvState, cfg: C.EnvConfig):
    """The reset tick's stages: contact pass + rewards on the pre-step pose,
    then the fused physics stage with the lagged contact mask."""
    _check_supported(cfg)
    lagged = state.wheel_on_road
    wheel_on_road, car_tile, touched = _contact_pass(state.cars, state.track)
    bonus, visited, cnt = _visit_rewards(state.track, state.visited, car_tile,
                                         cfg.num_agents)
    cars, _ = island_step(state.cars, lagged, cfg.velocity_iters, cfg.position_iters)
    return state.replace(
        cars=cars,
        reward=state.reward + bonus,
        visited=visited,
        tile_visited_count=state.tile_visited_count + cnt,
        wheel_on_road=wheel_on_road,
        tile_touched=state.tile_touched | touched,
        t=state.t + C.DT,
        steps=state.steps + 1,
    ), bonus


def _post_step(state: EnvState, cfg: C.EnvConfig, gain: torch.Tensor,
               nearest_beta: torch.Tensor, on_grass: torch.Tensor):
    """Stage 4 (mcr:433-508): step cost, backward/grass flags, termination.

    ``gain`` is this step's reward delta before the step cost (tile bonuses
    plus any bonus carried over from the reset spawn tick); computing the
    step reward from it, not as a difference of float32 cumulatives, keeps
    each step reward exact (the cumulative is the same either way)."""
    f32 = state.reward.dtype
    reward = state.reward - 0.1
    step_reward = gain - 0.1

    # --- per-car backward analysis (mcr:446-495).
    vel = state.cars.hull_v
    speed = torch.sqrt(torch.sum(vel * vel, dim=-1))
    car_angle = torch.where(
        speed > 0.5, -torch.atan2(vel[..., 0], vel[..., 1]), state.cars.hull_a
    )
    car_angle = torch.remainder(car_angle + 2 * math.pi, 2 * math.pi)

    origin = state.cars.hull_origin                           # (E, N, 2)
    flip = torch.where(state.direction_cw, math.pi, 0.0).to(f32)   # (E,)
    desired = nearest_beta + flip[:, None]
    desired = torch.remainder(desired + 2 * math.pi, 2 * math.pi)
    diff = torch.abs(desired - car_angle)
    diff = torch.where(diff > math.pi, torch.abs(diff - 2 * math.pi), diff)
    backward = diff > C.BACKWARD_THRESHOLD
    step_reward = step_reward - torch.where(
        backward, C.K_BACKWARD * diff, torch.zeros_like(diff)
    )

    # --- termination (mcr:498-507).
    finished = torch.any(state.tile_visited_count == state.track.n_tiles[:, None], dim=1)
    off = (torch.abs(origin[..., 0]) > C.PLAYFIELD) | (torch.abs(origin[..., 1]) > C.PLAYFIELD)
    step_reward = torch.where(off, torch.full_like(step_reward, -100.0), step_reward)
    # Sticky across steps: a car that drifts back on-field must not
    # resurrect a finished episode.
    done = state.done | finished | torch.any(off, dim=1)

    state = state.replace(
        reward=reward,
        prev_reward=reward,
        driving_backward=backward,
        driving_on_grass=on_grass,
        done=done,
    )
    return state, step_reward, done


def reset_from_parts(cfg: C.EnvConfig, track: Track, car_order: torch.Tensor,
                     direction_cw: torch.Tensor) -> EnvState:
    """Spawn cars on the grid of each of E tracks, then run the reference's
    ``step(None)`` — one physics tick with no controls, during which
    spawn-tile visits pay their bonuses (mcr:408).

    ``car_order`` (E, N) int; ``direction_cw`` (E,) bool; both on the
    track's device."""
    _check_supported(cfg)
    f32 = track.xy.dtype
    order = car_order.to(torch.int64)
    line = torch.div(order, 2, rounding_mode="floor")
    side = (2 * (order % 2) - 1).to(f32)
    idx = torch.remainder(-line * C.LINE_SPACING, track.n_tiles[:, None].to(torch.int64))
    flip = torch.where(direction_cw, -math.pi, 0.0).to(f32)
    angle = torch.gather(track.beta, 1, idx) + flip[:, None]
    norm_theta = angle - math.pi / 2
    xy = torch.gather(track.xy, 1, idx[..., None].expand(*idx.shape, 2))
    pos = xy + C.LATERAL_SPACING * torch.stack(
        [torch.sin(norm_theta) * side, torch.cos(norm_theta) * side], dim=-1
    )
    state = _episode_start(create_cars(pos, angle), track, direction_cw,
                           cfg.num_agents)
    # step(None): physics + contacts only — no action, no reward stage. The
    # spawn-tile bonuses land in reward but not prev_reward, so the first
    # real step's carry term surfaces them.
    state, _ = _physics_and_contacts(state, cfg)
    return state


def step(cfg: C.EnvConfig, state: EnvState, action: torch.Tensor):
    """One step of every env. ``action`` is (E, N, 3): (steer, gas, brake).

    Returns (state', step_reward (E, N), done (E,))."""
    _check_supported(cfg)
    # Reward accrued but not yet reported: nonzero only right after reset.
    carry = state.reward - state.prev_reward
    pre_cars = apply_controls(state.cars, action.to(state.reward.dtype))
    new_cars, _ = island_step(pre_cars, state.wheel_on_road,
                              cfg.velocity_iters, cfg.position_iters)
    (wheel_on_road, visited, bonus, cnt, tile_touched, nearest_beta,
     on_grass) = _track_stage(state.track, pre_cars, new_cars.hull_origin,
                              state.visited, state.tile_touched, cfg.num_agents)
    state = state.replace(
        cars=new_cars,
        wheel_on_road=wheel_on_road,
        visited=visited,
        tile_touched=tile_touched,
        reward=state.reward + bonus,
        tile_visited_count=state.tile_visited_count + cnt,
        t=state.t + C.DT,
        steps=state.steps + 1,
    )
    return _post_step(state, cfg, bonus + carry, nearest_beta, on_grass)


def _episode_from_seed(cfg: C.EnvConfig, np_rng, global_stream):
    direction = global_stream.direction() if cfg.use_random_direction else cfg.direction
    order = np.asarray(global_stream.car_order(cfg.num_agents))
    pts, border, retries = track_host.generate_track(np_rng)
    arrays = pack_track_arrays(pts, border, cfg.max_tiles)
    return arrays, order, direction, {"n_tiles": len(pts), "retries": retries,
                                      "direction": direction}


def host_reset(cfg: C.EnvConfig, seed=None, global_stream=None, np_rng=None,
               device=None):
    """Host-path reset of one env (E = 1): bit-parity MT19937 track
    generation + the reference's global-stream episode draws, then the
    spawn tick on ``device`` (default CUDA).

    Returns (EnvState, info dict)."""
    dev = resolve_device(device)
    if np_rng is None:
        np_rng, _ = seeding.np_random(seed)
    if global_stream is None:
        global_stream = seeding.GlobalStream()
    arrays, order, direction, info = _episode_from_seed(cfg, np_rng, global_stream)
    state = reset_from_parts(
        cfg, track_from_arrays([arrays], dev),
        torch.as_tensor(order[None], dtype=torch.int32, device=dev),
        torch.tensor([direction == "CW"], device=dev),
    )
    return state, info


def reset_batch(cfg: C.EnvConfig, seeds: Sequence[int], num_envs: int,
                device=None) -> EnvState:
    """Reset ``num_envs`` envs from ``len(seeds)`` host-generated tracks,
    env e taking seed ``seeds[e % len(seeds)]``.

    Each seed drives both the track stream and the episode stream
    (``GlobalStream(seed)``), as the JAX package's ``bench.py`` does. The
    spawn tick runs once on the distinct tracks; the result is then tiled,
    so host generation stays at ``len(seeds)`` tracks at any ``num_envs``."""
    dev = resolve_device(device)
    seeds = list(seeds)
    if not seeds or num_envs < 1:
        raise ValueError("reset_batch needs at least one seed and one env")
    arrays, orders, dirs = [], [], []
    for seed in seeds:
        a, order, direction, _ = _episode_from_seed(
            cfg, seeding.np_random(seed)[0], seeding.GlobalStream(seed)
        )
        arrays.append(a)
        orders.append(order)
        dirs.append(direction == "CW")
    state = reset_from_parts(
        cfg, track_from_arrays(arrays, dev),
        torch.as_tensor(np.stack(orders), dtype=torch.int32, device=dev),
        torch.tensor(dirs, device=dev),
    )
    idx = torch.arange(num_envs, device=dev) % len(seeds)
    return tree_map(lambda x: x.index_select(0, idx), state)
