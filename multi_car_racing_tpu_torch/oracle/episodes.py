"""Whole episodes of the port under the deterministic track follower.

The engine half of the JAX package's ``oracle/episodes.py``: the lane
follower (``lane_offsets``, ``follower_action``, copied exactly as the plain
per-car version, and ``follower_actions``, the same policy on tensors over
(E, N)), the 0.1 mm hull nudge that measures an engine's own chaos floor
(``nudge``), and two runners batched over E episodes: ``run_episodes_open``
replays recorded actions, ``run_episodes_closed`` recomputes the follower's
actions from the port's own states every step. Neither reads the card
during the episode.

Each episode is ``(seed, gseed, direction)``: the track comes from the
hash-seeded MT19937 stream of ``seed`` (the native walk), the car order
(and the direction when it is None) from ``GlobalStream(gseed)``, as the
JAX package's ``host_reset`` draws them. The runners return, on the host:

- ``rewards`` (T, E, N) float64, zero past each episode's end;
- ``done_step`` (E,): the step at which ``done`` first fired, T if never
  (the JAX runners' ``done_step``); ``length`` (E,): steps in the episode;
- ``tiles`` (E, N): tile visits at the episode's end; ``n_tiles`` (E,);
- ``near`` (T,) int: envs whose broadphase flag was set, per step: K2's own
  count (``fused_world.launch_contacts.near_count``) on the card, the same
  test in plain torch (``fused_world.near_flags``) on the CPU; 0 at N = 1;
- ``contact_step`` (E,): the first step of the episode after which a car-car
  contact point carried a normal impulse, -1 if none;
- ``finite`` (E,) bool: every hull position and velocity finite at the end;
- ``actions`` (T, E, N, 3) float32 from the closed loop, zero past the end.

The reference half of the JAX module (``run_reference_*``,
``reference_self_divergence``, ``compare_episode``) drives the reference
env through ``oracle/shims.py`` and is not part of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch

from .. import config as C
from .. import env as penv
from .. import seeding
from ..physics import fused_world
from ..physics.state import apply_controls
from ..track.common import Track, track_from_arrays
from ..util import resolve_device

TWO_PI = 2 * math.pi


def lane_offsets(num_cars: int) -> np.ndarray:
    """Per-car lateral lane (m from centerline). Cars following one shared
    racing line rear-end each other within ~60 steps (measured) and the
    episode enters contact chaos; distinct lanes inside the ±6.67 m track
    width keep multi-agent parity episodes contact-free (hull-hull impact
    parity has its own dedicated first-impact test, tests/test_collide.py)."""
    if num_cars == 1:
        return np.zeros(1)
    return np.linspace(-3.2, 3.2, num_cars)


def follower_action(track_xy, track_beta, cw, hulls, max_speed=40.0,
                    lanes=None):
    """Deterministic per-car track follower.

    track_xy: (T, 2) centerline, track_beta: (T,) tile headings, cw: bool;
    hulls: list of (pos(2,), vel(2,), angle) float64 tuples; lanes: (N,)
    per-car lateral offset (default lane_offsets).
    Returns (N, 3) [steer, gas, brake] in the env's action convention
    (steer +1 = right, mcr:422).
    """
    n = len(track_beta)
    sgn = -1 if cw else 1
    if lanes is None:
        lanes = lane_offsets(len(hulls))
    acts = np.zeros((len(hulls), 3), dtype=np.float64)
    for k, (pos, vel, ang) in enumerate(hulls):
        d2 = (track_xy[:, 0] - pos[0]) ** 2 + (track_xy[:, 1] - pos[1]) ** 2
        i = int(np.argmin(d2))
        j = (i + sgn * 4) % n
        desired = float(track_beta[j]) + (math.pi if cw else 0.0)
        err = (desired - ang + math.pi) % (2 * math.pi) - math.pi
        # Signed lateral offset from the centerline: (cos b, sin b) is the
        # tile's lateral axis (mcr:311-318), 90 deg clockwise of the CCW
        # driving direction (-sin b, cos b) — so positive lat = car right of
        # center when driving CCW, left when CW; steer back with -lat*sgn
        # (steer +1 = right, mcr:422).
        b = float(track_beta[i])
        lat = ((pos[0] - track_xy[i, 0]) * math.cos(b)
               + (pos[1] - track_xy[i, 1]) * math.sin(b)) - lanes[k]
        steer = -2.0 * math.sin(err) - 0.12 * max(-4.0, min(4.0, lat)) * sgn
        speed = math.hypot(vel[0], vel[1])
        # Slow for upcoming curvature.
        kk = (i + sgn * 10) % n
        curv = abs((track_beta[kk] - track_beta[j] + math.pi) % (2 * math.pi)
                   - math.pi)
        target = max_speed * (1.0 - min(curv, 1.0) * 0.65)
        gas = 0.25 if speed < target else 0.0
        brake = 0.4 if speed > target + 6.0 else 0.0
        acts[k] = (max(-1.0, min(1.0, steer)), gas, brake)
    return acts


def _py_mod(a: torch.Tensor, b: float) -> torch.Tensor:
    """Python's float ``a % b`` for ``b > 0``: fmod, then moved into [0, b)."""
    m = torch.fmod(a, b)
    return torch.where(m < 0, m + b, m)


def follower_actions(track: Track, state: penv.EnvState, lanes=None,
                     max_speed: float = 40.0) -> torch.Tensor:
    """:func:`follower_action` for every (env, car) at once, in float64 on
    the state's device, from the hull's centre of mass, velocity and angle
    (as the JAX package's closed-loop runner reads them). ``lanes`` (N,)
    defaults to :func:`lane_offsets`. Returns (E, N, 3) float64."""
    cars = state.cars
    dev, f64 = cars.hull_c.device, torch.float64
    E, N = cars.hull_a.shape
    if lanes is None:
        lanes = lane_offsets(N)
    lanes = torch.as_tensor(np.asarray(lanes, np.float64), device=dev)
    xy, beta = track.xy.to(f64), track.beta.to(f64)                  # (E, MT, 2), (E, MT)
    nt = track.n_tiles.to(torch.int64)[:, None]                       # (E, 1)
    cw = state.direction_cw[:, None]                                  # (E, 1)
    sgn = torch.where(cw, -1, 1).to(torch.int64)
    pos, vel, ang = cars.hull_c.to(f64), cars.hull_v.to(f64), cars.hull_a.to(f64)

    dx = xy[:, None, :, 0] - pos[..., 0, None]                        # (E, N, MT)
    dy = xy[:, None, :, 1] - pos[..., 1, None]
    d2 = dx * dx + dy * dy
    valid = torch.arange(xy.shape[1], device=dev)[None, None] < nt[:, :, None]
    i = torch.argmin(torch.where(valid, d2, torch.inf), dim=-1)      # (E, N), first minimum
    j = torch.remainder(i + sgn * 4, nt)
    kk = torch.remainder(i + sgn * 10, nt)
    beta_i, beta_j, beta_k = (torch.gather(beta, 1, idx) for idx in (i, j, kk))
    desired = beta_j + cw.to(f64) * math.pi                          # + pi (exact) when CW
    err = _py_mod(desired - ang + math.pi, TWO_PI) - math.pi
    xi = torch.gather(xy, 1, i[..., None].expand(E, N, 2))
    lat = ((pos[..., 0] - xi[..., 0]) * torch.cos(beta_i)
           + (pos[..., 1] - xi[..., 1]) * torch.sin(beta_i)) - lanes
    steer = -2.0 * torch.sin(err) - 0.12 * torch.clamp(lat, -4.0, 4.0) * sgn
    speed = torch.hypot(vel[..., 0], vel[..., 1])
    curv = torch.abs(_py_mod(beta_k - beta_j + math.pi, TWO_PI) - math.pi)
    target = max_speed * (1.0 - torch.clamp(curv, max=1.0) * 0.65)
    zero = torch.zeros_like(speed)
    gas = torch.where(speed < target, zero + 0.25, zero)
    brake = torch.where(speed > target + 6.0, zero + 0.4, zero)
    return torch.stack([torch.clamp(steer, -1.0, 1.0), gas, brake], dim=-1)


def nudge(state: penv.EnvState, car: int = 0, dx: float = 1e-4) -> penv.EnvState:
    """Move car ``car``'s hull by ``dx`` m along x in every env, and nothing
    else (its wheels stay where they are), as setting the reference's
    ``hull.position`` right after reset does (the JAX package's
    ``run_reference_replay``): the perturbation whose growth is an engine's
    own chaos floor."""
    hull_c = state.cars.hull_c.clone()
    hull_c[:, car, 0] += dx
    return state.replace(cars=state.cars.replace(hull_c=hull_c))


def reset_episodes(cfg: C.EnvConfig, resets: Sequence[tuple], device=None) -> penv.EnvState:
    """One env per ``(seed, gseed, direction)`` of ``resets``, reset as the
    JAX package's ``host_reset`` does for that episode: the direction
    (when None) and the car order from ``GlobalStream(gseed)``, the track
    from ``np_random(seed)`` by the native walk, then the spawn tick."""
    dev = resolve_device(device)
    arrays, orders, dirs = [], [], []
    for seed, gseed, direction in resets:
        ep_cfg = cfg if direction is None else dataclasses.replace(
            cfg, direction=direction, use_random_direction=False)
        a, order, d, _ = penv._episode_from_seed(ep_cfg, seeding.np_random(seed)[0],
                                                 seeding.GlobalStream(gseed))
        arrays.append(a)
        orders.append(order)
        dirs.append(d == "CW")
    return penv.reset_from_parts(
        cfg, track_from_arrays(arrays, dev),
        torch.as_tensor(np.stack(orders), dtype=torch.int32, device=dev),
        torch.tensor(dirs, device=dev))


def _run(cfg: C.EnvConfig, state: penv.EnvState, policy, steps: int, record: bool) -> dict:
    """Step every env ``steps`` times under ``policy(t, state)`` -> (E, N, 3)
    actions; the buffers stay on the state's device until the end."""
    dev = state.reward.device
    E, N = state.reward.shape
    rewards = torch.zeros((steps, E, N), dtype=torch.float32, device=dev)
    dones = torch.zeros((steps, E), dtype=torch.bool, device=dev)
    contact = torch.zeros((steps, E), dtype=torch.bool, device=dev)
    near = torch.zeros(steps, dtype=torch.int32, device=dev)
    acts = torch.zeros((steps, E, N, 3), dtype=torch.float32, device=dev) if record else None
    tiles = torch.zeros((E, N), dtype=torch.int32, device=dev)
    ended = torch.zeros(E, dtype=torch.bool, device=dev)
    for t in range(steps):
        a = policy(t, state).to(torch.float32)
        if N >= 2 and dev.type == "cpu":
            near[t] = fused_world.near_flags(apply_controls(state.cars, a)).sum()
        state, r, d = penv.step(cfg, state, a)
        if N >= 2 and dev.type == "cuda":
            near[t] = fused_world.launch_contacts.near_count[0]
        rewards[t], dones[t] = r, d
        contact[t] = (state.contacts.normal_imp > 0).flatten(1).any(1)
        if record:
            acts[t] = torch.where(ended[:, None, None], 0.0, a)
        tiles = torch.where((d & ~ended)[:, None], state.tile_visited_count, tiles)
        ended = ended | d
    tiles = torch.where(ended[:, None], tiles, state.tile_visited_count)

    dones, contact = dones.cpu().numpy(), contact.cpu().numpy()
    done_step = np.where(dones.any(0), dones.argmax(0), steps)
    length = np.minimum(done_step + 1, steps)
    inside = np.arange(steps)[:, None] < length[None]                 # (T, E)
    rewards = rewards.cpu().numpy().astype(np.float64) * inside[..., None]
    hit = contact & inside
    out = dict(rewards=rewards, done_step=done_step, length=length,
               tiles=tiles.cpu().numpy(), n_tiles=state.track.n_tiles.cpu().numpy(),
               near=near.cpu().numpy(), finite=penv.finite_cars(state).cpu().numpy(),
               contact_step=np.where(hit.any(0), hit.argmax(0), -1))
    if record:
        out["actions"] = acts.cpu().numpy()
    return out


def run_episodes_open(cfg: C.EnvConfig, resets: Sequence[tuple], actions,
                      perturb: float = 0.0, device=None) -> dict:
    """Replay recorded ``actions`` (T, E, N, 3) through the port, one env per
    episode of ``resets``, for T steps; with ``perturb`` the hull of car 0 is
    nudged by that many metres right after reset (:func:`nudge`)."""
    state = reset_episodes(cfg, resets, device)
    if perturb:
        state = nudge(state, 0, perturb)
    acts = torch.as_tensor(np.asarray(actions, np.float32), device=state.reward.device)
    return _run(cfg, state, lambda t, _: acts[t], acts.shape[0], record=False)


def run_episodes_closed(cfg: C.EnvConfig, resets: Sequence[tuple], lanes=None,
                        max_steps: int = C.MAX_EPISODE_STEPS, device=None) -> dict:
    """Drive the port closed-loop with :func:`follower_actions`, recomputed
    from its own states every step, one env per episode of ``resets``, for
    ``max_steps`` steps; the actions come back in ``actions``."""
    state = reset_episodes(cfg, resets, device)
    track = state.track
    return _run(cfg, state, lambda t, s: follower_actions(track, s, lanes), max_steps,
                record=True)
