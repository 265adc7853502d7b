"""Gym-compatible facade: numpy in/out, the reference's API surface.

Port of the JAX package's ``gym_api.py``: the equivalent of the reference's
``MultiCarRacing`` class (mcr:125-674) and its registration entry
(reference __init__.py:5-10):

    env = multi_car_racing_tpu_torch.make("MultiCarRacing-v0", num_agents=2)
    obs = env.reset()                       # (N, 96, 96, 3) uint8
    obs, reward, done, info = env.step(a)   # reward (N,), done bool

A single-env wrapper over the batched core: it holds an E = 1 ``EnvState``
on ``device`` (default CUDA; ``device="cpu"`` runs the plain PyTorch
versions of the kernels) and squeezes the env axis at the numpy boundary.
Each ``step`` runs the physics island (K1 at one car, K2 at two or more),
the track pass (K4/K5) and, for the observation, the 96x96 painter (K6) on
the card; it is eager and host-bound by design. For throughput use the
batched core (``env.step``, ``obs.pixel_observation_batched``) directly.

API-parity notes (the JAX package's, kept):
- the reference declares per-car spaces that do not match its own step
  contract; these are honest batched spaces instead,
- ``step`` re-flattens any action shape through reshape(num_agents, -1),
  like mcr:420,
- ``render('human')`` opens the per-agent windows of ``window.py`` when a
  display exists and returns their ``isopen`` flags; on a headless host it
  returns the rgb_array frames. 'state_pixels' is the observation;
  'rgb_array' is the 600x400 viewport with skid trails
  (``render.raster.render_observation``). For video capture, wrap the env
  in ``monitor.Monitor`` (the gym Monitor equivalent, mcr:714-717).

``VectorMultiCarRacing`` is the batched facade, the throughput entry point:
E lockstep envs with autoreset, their tracks generated on the card
(``env.device_reset``, ``env.make_track_pool_checked``):

    venv = multi_car_racing_tpu_torch.VectorMultiCarRacing(4096, num_agents=2, obs="pixels")
    obs = venv.reset()                                # (E, N, 96, 96, 3) uint8
    obs, rewards, dones, info = venv.step(actions)    # (E, N, 3) -> (E, N), (E,)
"""

from __future__ import annotations

import numpy as np
import torch

from . import config as C
from . import env as penv
from . import obs as pobs
from . import seeding
from .render import raster
from .util import resolve_device

metadata = {
    "render.modes": ["human", "rgb_array", "state_pixels"],
    "video.frames_per_second": C.FPS,
}


class Box:
    """Minimal Box space (gymnasium-compatible attributes)."""

    def __init__(self, low, high, shape, dtype):
        self.low = np.broadcast_to(np.asarray(low, dtype), shape)
        self.high = np.broadcast_to(np.asarray(high, dtype), shape)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)

    def sample(self, rng=None):
        rng = rng or np.random
        # gymnasium semantics: uniform on bounded dims, standard normal on
        # unbounded ones (np.random.uniform raises on infinite bounds).
        bounded = np.isfinite(self.low) & np.isfinite(self.high)
        out = rng.standard_normal(self.shape)
        out = np.where(
            bounded,
            rng.uniform(np.where(bounded, self.low, 0.0), np.where(bounded, self.high, 1.0)),
            out,
        )
        return out.astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (
            x.shape == self.shape
            and bool((x >= self.low - 1e-6).all())
            and bool((x <= self.high + 1e-6).all())
        )

    def __repr__(self):
        return f"Box{self.shape}"


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


class MultiCarRacing:
    metadata = metadata

    def __init__(
        self,
        num_agents: int = 2,
        verbose: int = 1,
        direction: str = "CCW",
        use_random_direction: bool = True,
        backwards_flag: bool = True,
        h_ratio: float = 0.25,
        use_ego_color: bool = False,
        global_seed: int | None = None,
        device: str | None = None,
    ):
        # EzPickle-equivalent (mcr:10,134): pickling captures the constructor
        # args and unpickling re-runs __init__ -- no mid-episode state
        # capture, exactly like the reference. ``device`` is kept as given.
        self._ezpickle_kwargs = dict(
            num_agents=num_agents, verbose=verbose, direction=direction,
            use_random_direction=use_random_direction,
            backwards_flag=backwards_flag, h_ratio=h_ratio,
            use_ego_color=use_ego_color, global_seed=global_seed, device=device,
        )
        self.device = resolve_device(device)
        self.cfg = C.EnvConfig(
            num_agents=num_agents,
            direction=direction,
            use_random_direction=use_random_direction,
            backwards_flag=backwards_flag,
            h_ratio=h_ratio,
            use_ego_color=use_ego_color,
            verbose=verbose,
            track_skid=True,   # rgb_array / human render skid trails
        )
        self.num_agents = num_agents
        # The reference draws direction and spawn order from the
        # module-global np.random (mcr:352-357); here that stream is
        # explicit and seedable.
        self._global = seeding.GlobalStream(global_seed)
        self.np_random, _ = seeding.np_random(None)
        self._state = None
        self._viewer = None
        self.reward = np.zeros(num_agents)

        n = num_agents
        self.action_space = Box(
            np.tile([-1.0, 0.0, 0.0], (n, 1)), np.tile([1.0, 1.0, 1.0], (n, 1)),
            (n, 3), np.float32,
        )
        self.observation_space = Box(0, 255, (n, C.STATE_H, C.STATE_W, 3), np.uint8)

    # -- pickling (EzPickle semantics, mcr:10,134) --------------------------
    def __getstate__(self):
        return dict(self._ezpickle_kwargs)

    def __setstate__(self, kwargs):
        self.__init__(**kwargs)

    # -- gym API ------------------------------------------------------------
    def seed(self, seed=None):
        self.np_random, seed = seeding.np_random(seed)
        return [seed]

    def _observe(self) -> np.ndarray:
        return _host(pobs.pixel_observation_batched(self.cfg, self._state)[0])

    def reset(self):
        state, info = penv.host_reset(self.cfg, np_rng=self.np_random,
                                      global_stream=self._global, device=self.device)
        if self.cfg.verbose == 1:
            print(f"Track generation: {info['n_tiles']}-tiles track "
                  f"({info['retries']} retries)")
        self._state = state
        self.reward = _host(state.reward[0])
        return self._observe()

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() first")
        if action is None:
            # The reference's step(None) is internal only (the spawn tick);
            # reset() already ran it.
            raise ValueError("action must not be None; reset() handles the spawn tick")
        action = np.reshape(np.asarray(action, np.float32), (self.num_agents, -1))
        a = torch.as_tensor(action, device=self.device)[None]
        state, r, done = penv.step(self.cfg, self._state, a)
        self._state = state
        self.reward = _host(state.reward[0])
        return self._observe(), _host(r[0]), bool(done[0]), {}

    def render(self, mode: str = "human"):
        assert mode in ("human", "state_pixels", "rgb_array")
        if self._state is None:
            return None  # the reference guards on reset-not-called (mcr:538)
        if mode == "state_pixels":
            return self._observe()
        frames = _host(raster.render_observation(self.cfg, self._state, vp_w=C.VIDEO_W,
                                                 vp_h=C.VIDEO_H, draw_particles=True)[0])
        if mode == "human":
            from . import window

            if self._viewer is None and window.display_available():
                self._viewer = window.HumanViewer()
            if self._viewer is not None:
                # Reference contract: per-window isopen bools (mcr:595-597).
                return self._viewer.show(frames)
        return frames

    def close(self):
        self._state = None
        if self._viewer is not None:
            self._viewer.close()
            self._viewer = None

    # -- convenience --------------------------------------------------------
    @property
    def state(self):
        """The functional ``EnvState`` (for tooling and checkpointing): the
        batched core's state of one env, every tensor with a leading env
        axis of 1, on ``device``."""
        return self._state

    @property
    def track_length(self):
        return int(self._state.track.n_tiles[0]) if self._state is not None else None

    @property
    def tile_visited_count(self):
        return list(_host(self._state.tile_visited_count[0]))

    @property
    def driving_backward(self):
        return _host(self._state.driving_backward[0])

    @property
    def driving_on_grass(self):
        return _host(self._state.driving_on_grass[0])


class TimeLimit:
    """The registration wrapper (reference __init__.py:8): truncates at
    max_episode_steps (reported through ``done``, like gym 0.17)."""

    def __init__(self, env: MultiCarRacing, max_episode_steps: int = C.MAX_EPISODE_STEPS):
        self.env = env
        self.max_episode_steps = max_episode_steps
        self._elapsed = 0

    def __getattr__(self, name):
        # 'env' and dunders must fail fast: during unpickling this runs
        # before __dict__ is restored, and a delegating lookup would recurse.
        if name == "env" or name.startswith("__"):
            raise AttributeError(name)
        return getattr(self.env, name)

    def reset(self):
        self._elapsed = 0
        return self.env.reset()

    def step(self, action):
        obs, r, done, info = self.env.step(action)
        self._elapsed += 1
        if self._elapsed >= self.max_episode_steps:
            info["TimeLimit.truncated"] = not done
            done = True
        return obs, r, done, info


class VectorMultiCarRacing:
    """Batched numpy facade: E lockstep envs on ``device`` (default CUDA;
    ``device="cpu"`` runs the plain PyTorch versions of the kernels). The
    reference is strictly single-env; this is the throughput entry point.

    - ``reset()`` -> obs; ``step(actions (E, N, 3))`` -> (obs, rewards
      (E, N), dones (E,), info). Done or time-limited envs autoreset at the
      START of the next step (the returned obs and reward of a finishing
      step are the terminal ones), from a pool of ``pool_size`` tracks.
    - Tracks and episode draws come from the on-device generator
      (``env.make_track_pool_checked`` once, then ``env.device_reset`` at
      each ``reset()``), seeded by ``seed``: the reference's distributions,
      not its MT19937 streams (the single-env ``MultiCarRacing`` facade
      keeps those).
    - obs="pixels" paints (E, N, 96, 96, 3) uint8 through
      ``obs.pixel_observation_batched`` (K6 on the card); obs="state"
      returns ``obs.state_observation`` (E, N, 38); obs="none" returns None
      (physics only).
    """

    metadata = metadata

    def __init__(
        self,
        num_envs: int,
        num_agents: int = 2,
        obs: str = "pixels",
        seed: int = 0,
        pool_size: int = 32,
        max_episode_steps: int = C.MAX_EPISODE_STEPS,
        device: str | None = None,
        **env_kwargs,
    ):
        if obs not in ("pixels", "state", "none"):
            raise ValueError(f"obs must be 'pixels', 'state' or 'none', got {obs!r}")
        self.num_envs = num_envs
        self.num_agents = num_agents
        self.obs_type = obs
        self.device = resolve_device(device)
        self.cfg = C.EnvConfig(num_agents=num_agents, max_episode_steps=max_episode_steps,
                               **env_kwargs)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._pool = None
        self._state = None
        self._pool_size = pool_size

        n, E = num_agents, num_envs
        self.action_space = Box(
            np.tile([-1.0, 0.0, 0.0], (E, n, 1)),
            np.tile([1.0, 1.0, 1.0], (E, n, 1)), (E, n, 3), np.float32,
        )
        if obs == "pixels":
            self.observation_space = Box(0, 255, (E, n, C.STATE_H, C.STATE_W, 3), np.uint8)
        elif obs == "state":
            self.observation_space = Box(-np.inf, np.inf, (E, n, pobs.STATE_OBS_DIM),
                                         np.float32)
        else:
            self.observation_space = None

    def _observe(self):
        if self.obs_type == "pixels":
            return _host(pobs.pixel_observation_batched(self.cfg, self._state))
        if self.obs_type == "state":
            return _host(pobs.state_observation(self._state))
        return None

    def reset(self):
        if self._pool is None:
            self._pool = penv.make_track_pool_checked(self.cfg, self._generator,
                                                      self._pool_size)
        self._state = penv.device_reset(self.cfg, self._generator, self.num_envs)
        return self._observe()

    def step(self, actions):
        if self._state is None:
            raise RuntimeError("call reset() first")
        a = torch.as_tensor(np.reshape(np.asarray(actions, np.float32),
                                       (self.num_envs, self.num_agents, -1)), device=self.device)
        state = self._state
        # Autoreset only when some env needs it (one read on the host, where
        # JAX takes a lax.cond): reset_done_envs runs a spawn tick for the
        # whole batch, which would double the physics of every step.
        if bool(penv.episode_over(self.cfg, state).any()):
            state = penv.reset_done_envs(self.cfg, state, self._pool, self._generator)
        state, r, d = penv.step(self.cfg, state, a)
        self._state = state
        done = d | (state.steps >= self.cfg.max_episode_steps)
        return self._observe(), _host(r), _host(done), {}

    @property
    def state(self):
        """The batched ``EnvState`` (E, ...) on ``device``."""
        return self._state

    def close(self):
        self._state = None


REGISTRY = {
    "MultiCarRacing-v0": dict(
        max_episode_steps=C.MAX_EPISODE_STEPS, reward_threshold=C.REWARD_THRESHOLD
    ),
    # The exact CarRacing-v0 special case (reference README.md:66-71).
    "CarRacing-v0": dict(
        max_episode_steps=C.MAX_EPISODE_STEPS,
        reward_threshold=C.REWARD_THRESHOLD,
        kwargs=dict(num_agents=1, use_random_direction=False, backwards_flag=False),
    ),
}


def make(env_id: str = "MultiCarRacing-v0", **kwargs) -> TimeLimit:
    """A registered env (``REGISTRY``) in its ``TimeLimit``; ``kwargs`` go to
    ``MultiCarRacing`` (``device`` among them, default CUDA)."""
    if env_id not in REGISTRY:
        raise KeyError(f"unknown env id {env_id!r}; have {sorted(REGISTRY)}")
    spec = REGISTRY[env_id]
    merged = dict(spec.get("kwargs", {}))
    merged.update(kwargs)
    env = MultiCarRacing(**merged)
    wrapped = TimeLimit(env, spec["max_episode_steps"])
    wrapped.reward_threshold = spec["reward_threshold"]
    return wrapped


__all__ = ["Box", "MultiCarRacing", "REGISTRY", "TimeLimit", "VectorMultiCarRacing", "make",
           "metadata"]
