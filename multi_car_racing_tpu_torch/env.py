"""Environment core: batched EnvState + reset/step over E lockstep envs.

Port of the JAX package's ``env.py``: CarRacing-v0 (one car per env) and
MultiCarRacing-v0 (``num_agents`` >= 2 cars per env, with car-car
contacts). Every tensor carries the env axis first; the JAX package's
single-env shapes follow it.

Step order preserves the reference's (mcr:410-509 + Box2D internals):
  1. apply controls (steer/gas/brake setters)
  2. the fused physics stage (``physics/fused_world.island_step``): tire
     forces from the *lagged* tile contacts (Box2D collides at the start of
     world.Step), car-car manifolds with their warm-start carry, joint limit
     init, constraint solve + integration
  3. the track stage (``physics/track_engine.track_pass``) on the pre-solve
     pose: wheel-tile SAT (friction mask for the next step), tile-visit
     rewards (FrictionDetector, mcr:80-123), render color flattening; then
     nearest-tile heading and the on-grass flag on the post-solve pose
  4. post-step analysis: -0.1 step cost, backward/on-grass flags,
     all-tiles-visited / off-playfield termination (mcr:433-508)

Episodes on the device (JAX ``env.py:575-645``): ``device_reset`` generates
each env's track on the tracks' device (``track/device.py``) and draws its
episode; ``make_track_pool`` / ``make_track_pool_checked`` stack such tracks
for autoreset, and ``reset_done_envs`` puts fresh episodes drawn from a pool
into the envs that are done or past ``cfg.max_episode_steps``. The host path
(``host_reset``, ``reset_batch``, ``make_host_track_pool``) keeps the
reference's bit-exact MT19937 tracks for parity work.

Two render-only switches (off by default, on in the Gym facade for the
first): ``cfg.track_skid`` advances the skid-trail ring
(``render/particles.update``) on every step and spawn tick from the
pre-solve wheel positions, the island's skid flags and the lagged on-road
mask, as the JAX package does; ``cfg.exact_hull_touch`` ORs the hull
fixtures' SAT against the tiles (``physics/overlap.hull_tile_overlap``, on
the pre-solve pose) into the touched flag that K4/K5 computes from the hull
centre. The centre lies inside hull fixture 3, so the centre test is a
subset of the fixture test and the OR equals the JAX flag
(``tests/test_torch_raster.py`` holds both).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from . import config as C
from . import seeding
from .physics.collide import ContactState, init_contact_state
from .physics.fused_world import island_step
from .physics.overlap import hull_tile_overlap
from .physics.track_engine import track_pass
from .physics.state import CarState, apply_controls, create_cars
from .render import particles
from .render.particles import SkidState
from .track import device as track_device
from .track import host as track_host
from .track.common import Track, pack_track_arrays, track_from_arrays
from .util import resolve_device, tree_map

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


def _render_flags(cfg: C.EnvConfig, state: EnvState, pre_cars: CarState, lagged: torch.Tensor,
                  skid_flag: torch.Tensor, tile_touched: torch.Tensor):
    """The render-only switches: (skid trails, touched flag) after a step or
    spawn tick whose pre-solve cars are ``pre_cars``."""
    skid = state.skid
    if cfg.track_skid:
        # Trails record the tire model's positions and flags (cd:232-249):
        # pre-solve wheel positions, post-tire skid flags.
        skid = particles.update(skid, pre_cars.wheel_c, skid_flag, lagged)
    if cfg.exact_hull_touch:
        tile_touched = tile_touched | hull_tile_overlap(pre_cars, state.track)
    return skid, tile_touched


def _physics_and_contacts(state: EnvState, cfg: C.EnvConfig):
    """The reset tick's stages: contact pass + rewards on the pre-step pose
    (the track pass, its post-pose outputs unused), then the fused physics
    stage with the lagged contact mask."""
    lagged = state.wheel_on_road
    wheel_on_road, visited, bonus, cnt, tile_touched, _, _ = track_pass(
        state.track, state.cars, state.cars.hull_origin, state.visited,
        state.tile_touched, cfg.num_agents)
    cars, skid_flag, contacts = island_step(state.cars, lagged, state.contacts,
                                            cfg.velocity_iters, cfg.position_iters)
    skid, tile_touched = _render_flags(cfg, state, state.cars, lagged, skid_flag, tile_touched)
    return state.replace(
        cars=cars,
        contacts=contacts,
        skid=skid,
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
    new_cars, skid_flag, contacts = island_step(pre_cars, state.wheel_on_road, state.contacts,
                                                cfg.velocity_iters, cfg.position_iters)
    (wheel_on_road, visited, bonus, cnt, tile_touched, nearest_beta,
     on_grass) = track_pass(state.track, pre_cars, new_cars.hull_origin,
                            state.visited, state.tile_touched, cfg.num_agents)
    skid, tile_touched = _render_flags(cfg, state, pre_cars, state.wheel_on_road, skid_flag,
                                       tile_touched)
    state = state.replace(
        cars=new_cars,
        contacts=contacts,
        skid=skid,
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
    pts, border, retries = track_host.generate_track_fast(np_rng)
    arrays = pack_track_arrays(pts, border, cfg.max_tiles)
    return arrays, order, direction, {"n_tiles": len(pts), "retries": retries,
                                      "direction": direction}


def host_reset(cfg: C.EnvConfig, seed=None, global_stream=None, np_rng=None,
               device=None):
    """Host-path reset of one env (E = 1): bit-parity MT19937 track
    generation (the native walk, ``track_host.generate_track_fast``) + the
    reference's global-stream episode draws, then the spawn tick on
    ``device`` (default CUDA).

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


def make_host_track_pool(cfg: C.EnvConfig, seeds: Sequence[int], device=None) -> Track:
    """A pool of ``len(seeds)`` host tracks stacked on ``device`` (default
    CUDA), one per seed, from the bit-exact host generator
    (``track/host.generate_track_fast`` -> ``pack_track_arrays`` ->
    ``track_from_arrays``): for autoreset (``reset_done_envs``) where
    parity work wants the reference's tracks. ``make_track_pool`` draws a
    pool on the device instead."""
    dev = resolve_device(device)
    seeds = list(seeds)
    if not seeds:
        raise ValueError("make_host_track_pool needs at least one seed")
    arrays = []
    for seed in seeds:
        pts, border, _ = track_host.generate_track_fast(seeding.np_random(seed)[0])
        arrays.append(pack_track_arrays(pts, border, cfg.max_tiles))
    return track_from_arrays(arrays, dev)


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


def device_reset(cfg: C.EnvConfig, generator: torch.Generator, num_envs: int) -> EnvState:
    """Reset ``num_envs`` envs on the generator's device: each env's track
    generated there (``track_device.generate_tracks``, bounded by
    ``cfg.max_track_points`` and ``cfg.max_track_retries``), its episode
    drawn (``draw_episode_params``), then the spawn tick.

    An env whose every bounded retry failed (~0.06 per attempt; the
    reference retries forever, mcr:359-364) is marked done with ``steps =
    cfg.max_episode_steps``, as in the JAX package: it never contributes
    transitions, and the next ``reset_done_envs`` replaces it from a pool."""
    track, ok = track_device.generate_tracks(generator, num_envs, cfg.max_tiles,
                                             cfg.max_track_points, cfg.max_track_retries)
    orders, dirs = draw_episode_params(cfg, num_envs, generator)
    state = reset_from_parts(cfg, track, orders, dirs)
    return state.replace(done=state.done | ~ok,
                         steps=torch.where(ok, state.steps,
                                           torch.full_like(state.steps, cfg.max_episode_steps)))


def make_track_pool(cfg: C.EnvConfig, generator: torch.Generator, pool_size: int):
    """A pool of ``pool_size`` tracks generated on the generator's device,
    for autoreset (``reset_done_envs`` draws each fresh episode's track from
    it instead of generating one). Returns (Track, ok (pool_size,) bool);
    an entry whose bounded retries all failed has ``ok`` False."""
    return track_device.generate_tracks(generator, pool_size, cfg.max_tiles,
                                        cfg.max_track_points, cfg.max_track_retries)


def make_track_pool_checked(cfg: C.EnvConfig, generator: torch.Generator, pool_size: int,
                            max_rounds: int = 8) -> Track:
    """``make_track_pool`` that re-draws every entry whose bounded generation
    failed, and raises after ``max_rounds`` re-draws instead of ever
    returning a degenerate track. Reads the ok flags on the host once per
    round: for init paths."""
    tracks, ok = make_track_pool(cfg, generator, pool_size)
    for _ in range(max_rounds):
        failed = (~ok).nonzero().flatten()
        if failed.numel() == 0:
            return tracks
        fresh, fresh_ok = make_track_pool(cfg, generator, failed.numel())
        tracks = tree_map(lambda old, new: old.index_copy(0, failed, new), tracks, fresh)
        ok = ok.index_copy(0, failed, fresh_ok)
    if not bool(ok.all()):
        raise RuntimeError(
            f"track pool: {int((~ok).sum())}/{pool_size} entries still failed generation "
            f"after {max_rounds} re-draw rounds (cfg.max_track_retries={cfg.max_track_retries})"
        )
    return tracks


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


def episodes_from_pool(cfg: C.EnvConfig, pool: Track, idx: torch.Tensor,
                       orders: torch.Tensor, dirs: torch.Tensor) -> EnvState:
    """Fresh episodes in all E envs: ``reset_from_parts`` on pool tracks
    ``idx`` with car ``orders`` and directions ``dirs`` (``draw_episodes``)."""
    return reset_from_parts(cfg, tree_map(lambda x: x.index_select(0, idx), pool),
                            orders, dirs)


def reset_envs_from_pool(cfg: C.EnvConfig, state: EnvState, pool: Track,
                         idx: torch.Tensor, orders: torch.Tensor,
                         dirs: torch.Tensor) -> EnvState:
    """Fresh episodes (``episodes_from_pool``) in the envs where ``done`` or
    ``steps >= cfg.max_episode_steps``; the other envs keep their state bit
    for bit.

    As in the JAX package's ``reset_done_envs``, the fresh episode is
    computed for all E envs (one spawn tick) and selected leaf by leaf."""
    fresh = episodes_from_pool(cfg, pool, idx, orders, dirs)
    needs = episode_over(cfg, state)

    def pick(new: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
        return torch.where(needs.view((-1,) + (1,) * (new.dim() - 1)), new, old)

    return tree_map(pick, fresh, state)


def reset_done_envs(cfg: C.EnvConfig, state: EnvState, pool: Track,
                    generator: torch.Generator) -> EnvState:
    """Replace done (or time-limited) envs with fresh episodes drawn from
    the track pool (``draw_episodes`` then ``reset_envs_from_pool``). Call
    between rollout chunks: done envs keep stepping harmlessly inside a
    chunk, as the reference env does after completion. ``generator`` lives
    on the state's device."""
    g, dev = generator.device, state.steps.device
    if g.type != dev.type or (g.index is not None and g.index != dev.index):
        raise ValueError(f"reset_done_envs: a generator on {g} for a state on {dev}")
    idx, orders, dirs = draw_episodes(cfg, state.steps.shape[0], pool.n_tiles.shape[0],
                                      generator)
    return reset_envs_from_pool(cfg, state, pool, idx, orders, dirs)
