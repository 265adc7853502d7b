"""Environment step, reset tick and autoreset draws in plain PyTorch.

Frozen copy of the parts of ``multi_car_racing_tpu_torch/env.py`` (commit
3d8d1d4) that a batched rollout runs, with the two kernel calls replaced by
the plain functions they stand for (``island_step`` by
``physics/island.island_step_plain``, ``track_pass`` by
``physics/track_stage.track_pass_plain``): ``step`` (controls, the fused
physics stage, the track stage, ``_post_step``), ``reset_from_parts`` (the
spawn tick), ``draw_episodes`` (the autoreset draws) and the leaf-by-leaf
selection of ``reset_envs_from_pool``. The render-only switches
(``track_skid``, ``exact_hull_touch``) are not part of the reference and
raise.

Step order preserves the reference's (mcr:410-509 + Box2D internals):
  1. apply controls (steer/gas/brake setters)
  2. the fused physics stage: tire forces from the *lagged* tile contacts,
     car-car manifolds with their warm-start carry, joint limit init,
     constraint solve + integration
  3. the track stage on the pre-solve pose; nearest-tile heading and the
     on-grass flag on the post-solve pose
  4. post-step analysis: -0.1 step cost, backward/on-grass flags,
     all-tiles-visited / off-playfield termination (mcr:433-508)
"""

from __future__ import annotations

import dataclasses
import math

import torch

from . import config as C
from .physics.collide import ContactState, init_contact_state
from .physics.island import island_step_plain
from .physics.state import CarState, apply_controls, create_cars
from .physics.track_stage import track_pass_plain
from .render import particles
from .render.particles import SkidState
from .track.common import Track
from .util import tree_map


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


def _episode_start(cars: CarState, track: Track, direction_cw: torch.Tensor,
                   num_agents: int) -> EnvState:
    E, n, mt = direction_cw.shape[0], num_agents, track.max_tiles
    dev, f32 = track.xy.device, track.xy.dtype

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
        contacts=init_contact_state(E, n, device=dev, dtype=f32),
        skid=particles.init(E, n, device=dev, dtype=f32),
    )


def _physics_and_contacts(state: EnvState, cfg: C.EnvConfig):
    """The reset tick's stages: contact pass + rewards on the pre-step pose
    (the track pass, its post-pose outputs unused), then the fused physics
    stage with the lagged contact mask."""
    lagged = state.wheel_on_road
    wheel_on_road, visited, bonus, cnt, tile_touched, _, _ = track_pass_plain(
        state.track, state.cars, state.cars.hull_origin, state.visited,
        state.tile_touched, cfg.num_agents)
    cars, skid_flag, contacts = island_step_plain(state.cars, lagged, state.contacts,
                                            cfg.velocity_iters, cfg.position_iters)
    return state.replace(
        cars=cars,
        contacts=contacts,
        reward=state.reward + bonus,
        visited=visited,
        tile_visited_count=state.tile_visited_count + cnt,
        wheel_on_road=wheel_on_road,
        tile_touched=tile_touched,
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


def spawn_state(cfg: C.EnvConfig, track: Track, car_order: torch.Tensor,
                direction_cw: torch.Tensor) -> EnvState:
    """The episode-start state before the spawn tick: cars on the grid of
    each of E tracks (mcr:366-401), every mask and score zero.

    ``car_order`` (E, N) int; ``direction_cw`` (E,) bool; both on the
    track's device."""
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
    return _episode_start(create_cars(pos, angle), track, direction_cw, cfg.num_agents)


def reset_from_parts(cfg: C.EnvConfig, track: Track, car_order: torch.Tensor,
                     direction_cw: torch.Tensor) -> EnvState:
    """Spawn cars on the grid of each of E tracks (``spawn_state``), then
    run the reference's ``step(None)`` — one physics tick with no controls,
    during which spawn-tile visits pay their bonuses (mcr:408)."""
    # step(None): physics + contacts only — no action, no reward stage. The
    # spawn-tile bonuses land in reward but not prev_reward, so the first
    # real step's carry term surfaces them.
    state, _ = _physics_and_contacts(spawn_state(cfg, track, car_order, direction_cw), cfg)
    return state


def step(cfg: C.EnvConfig, state: EnvState, action: torch.Tensor):
    """One step of every env. ``action`` is (E, N, 3): (steer, gas, brake).

    Returns (state', step_reward (E, N), done (E,))."""
    E, n = state.reward.shape
    if n != cfg.num_agents or tuple(action.shape) != (E, n, 3):
        raise ValueError(f"step: a state of {n} cars per env under num_agents="
                         f"{cfg.num_agents} with actions {tuple(action.shape)}; "
                         f"expected actions ({E}, {cfg.num_agents}, 3)")
    # Reward accrued but not yet reported: nonzero only right after reset.
    carry = state.reward - state.prev_reward
    pre_cars = apply_controls(state.cars, action.to(state.reward.dtype))
    new_cars, skid_flag, contacts = island_step_plain(pre_cars, state.wheel_on_road, state.contacts,
                                                cfg.velocity_iters, cfg.position_iters)
    (wheel_on_road, visited, bonus, cnt, tile_touched, nearest_beta,
     on_grass) = track_pass_plain(state.track, pre_cars, new_cars.hull_origin,
                            state.visited, state.tile_touched, cfg.num_agents)
    state = state.replace(
        cars=new_cars,
        contacts=contacts,
        wheel_on_road=wheel_on_road,
        visited=visited,
        tile_touched=tile_touched,
        reward=state.reward + bonus,
        tile_visited_count=state.tile_visited_count + cnt,
        t=state.t + C.DT,
        steps=state.steps + 1,
    )
    return _post_step(state, cfg, bonus + carry, nearest_beta, on_grass)


def spawn_state(cfg: C.EnvConfig, track: Track, car_order: torch.Tensor,
                direction_cw: torch.Tensor) -> EnvState:
    """The episode-start state before the spawn tick: cars on the grid of
    each of E tracks (mcr:366-401), every mask and score zero.

    ``car_order`` (E, N) int; ``direction_cw`` (E,) bool; both on the
    track's device."""
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
    return _episode_start(create_cars(pos, angle), track, direction_cw, cfg.num_agents)


def reset_from_parts(cfg: C.EnvConfig, track: Track, car_order: torch.Tensor,
                     direction_cw: torch.Tensor) -> EnvState:
    """Spawn cars on the grid of each of E tracks (``spawn_state``), then
    run the reference's ``step(None)`` — one physics tick with no controls,
    during which spawn-tile visits pay their bonuses (mcr:408)."""
    # step(None): physics + contacts only — no action, no reward stage. The
    # spawn-tile bonuses land in reward but not prev_reward, so the first
    # real step's carry term surfaces them.
    state, _ = _physics_and_contacts(spawn_state(cfg, track, car_order, direction_cw), cfg)
    return state


def draw_episode_params(cfg: C.EnvConfig, num_envs: int, generator: torch.Generator):
    """Each env's episode draws, from ``generator`` and on its device: car
    order (E, N) int32, a permutation, and direction_cw (E,) bool, a fair
    coin when ``cfg.use_random_direction``, else ``cfg.direction``. The same
    distributions as the JAX package's ``track/device.py::episode_params``,
    not the same numbers: JAX draws with threefry."""
    dev = generator.device
    keys = torch.rand((num_envs, cfg.num_agents), generator=generator, device=dev)
    orders = torch.argsort(keys, dim=1).to(torch.int32)
    if cfg.use_random_direction:
        dirs = torch.rand((num_envs,), generator=generator, device=dev) < 0.5
    else:
        dirs = torch.full((num_envs,), cfg.direction == "CW", device=dev)
    return orders, dirs


def draw_episodes(cfg: C.EnvConfig, num_envs: int, pool_size: int,
                  generator: torch.Generator):
    """Draws, from ``generator`` and on its device, each env's next episode:
    (pool index (E,) int64, uniform over the pool; then car order and
    direction, as ``draw_episode_params``): the draws of the JAX package's
    ``reset_done_envs``."""
    dev = generator.device
    idx = torch.randint(0, pool_size, (num_envs,), generator=generator, device=dev)
    return (idx, *draw_episode_params(cfg, num_envs, generator))


def episode_over(cfg: C.EnvConfig, state: EnvState) -> torch.Tensor:
    """(E,) bool: the env is done or at the time limit
    (``cfg.max_episode_steps``), so the next autoreset replaces it."""
    return state.done | (state.steps >= cfg.max_episode_steps)


def finite_cars(state: EnvState) -> torch.Tensor:
    """(E,) bool: every car's hull position and velocity is finite. The
    learner quarantines an env whose solver state went nonfinite."""
    cars = state.cars
    return (torch.isfinite(cars.hull_c).all(dim=2).all(dim=1)
            & torch.isfinite(cars.hull_v).all(dim=2).all(dim=1))


def check_config(cfg: C.EnvConfig) -> None:
    """The reference covers the observation path of a rollout: the
    render-only switches are not part of it."""
    if cfg.track_skid or cfg.exact_hull_touch:
        raise ValueError("the reference does not model track_skid or exact_hull_touch")


def select_fresh(cfg: C.EnvConfig, state: EnvState, fresh: EnvState) -> EnvState:
    """``reset_envs_from_pool``'s selection: ``fresh`` in the envs where
    ``done`` or ``steps >= cfg.max_episode_steps``, ``state`` elsewhere,
    leaf by leaf."""
    needs = episode_over(cfg, state)

    def pick(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(needs.view((-1,) + (1,) * (new.dim() - 1)), new, old)

    return tree_map(pick, fresh, state)
