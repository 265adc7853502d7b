"""The port's Gym facade (``gym_api``: ``make``, ``MultiCarRacing``,
``TimeLimit``, ``Box``, the registry), its ``render`` modes with the
per-agent windows (``window``), and ``monitor.Monitor``, on the CPU,
mirroring the JAX package's tests/test_api_polish.py.

Facade envs run with ``device="cpu"``; those that step set their config to
8/3 solver iterations first (the facade reads ``env.cfg`` at every call),
which the tests below do not depend on. Tracks are compared with JAX's
host generator (numpy, no JAX compile).
"""

import dataclasses
import json
import os
import pickle

import numpy as np
import pytest
import torch

from multi_car_racing_tpu import gym_api as jgym, seeding as jseeding
from multi_car_racing_tpu.track import host as jhost

from multi_car_racing_tpu_torch import EnvConfig, env as penv, gym_api, monitor, obs, seeding
import multi_car_racing_tpu_torch as mcr
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def fast(env):
    """``env`` (a facade or its TimeLimit) at 8/3 solver iterations."""
    inner = env.env if isinstance(env, gym_api.TimeLimit) else env
    inner.cfg = dataclasses.replace(inner.cfg, velocity_iters=8, position_iters=3)
    return env


def test_facade_pickle_roundtrip():
    """The reference env is EzPickle (mcr:10,134): pickling captures the
    constructor args, ``device`` among them; unpickling re-runs __init__."""
    env = gym_api.MultiCarRacing(num_agents=2, verbose=0, direction="CW",
                                 use_random_direction=False, use_ego_color=True,
                                 global_seed=9, device="cpu")
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.num_agents == 2 and env2.device == torch.device("cpu")
    assert env2.cfg.direction == "CW" and env2.cfg.track_skid
    assert env2.cfg.use_ego_color and not env2.cfg.use_random_direction
    fast(env2).seed(3)
    o = env2.reset()
    assert o.shape == (2, 96, 96, 3) and o.dtype == np.uint8
    o, r, d, info = env2.step(np.zeros((2, 3)))
    assert r.shape == (2,) and isinstance(d, bool) and info == {}


def test_registered_env_pickle_roundtrip():
    env = gym_api.make("CarRacing-v0", verbose=0, device="cpu")
    env2 = pickle.loads(pickle.dumps(env))
    assert env2.max_episode_steps == 1000 and env2.reward_threshold == 900.0
    assert env2.num_agents == 1 and env2.env.device == torch.device("cpu")
    fast(env2).seed(1)
    env2.reset()
    env2.step(np.zeros((1, 3)))


def test_registry_and_carracing_v0_kwargs_match_jax():
    assert gym_api.REGISTRY == jgym.REGISTRY
    assert gym_api.metadata == jgym.metadata
    env = gym_api.make("CarRacing-v0", device="cpu")
    cfg = env.env.cfg
    assert (cfg.num_agents, cfg.use_random_direction, cfg.backwards_flag) == (1, False, False)
    assert env.action_space.shape == (1, 3) and env.observation_space.shape == (1, 96, 96, 3)
    with pytest.raises(KeyError, match="unknown env id"):
        gym_api.make("CarRacing-v9", device="cpu")
    assert mcr.make is gym_api.make and mcr.MultiCarRacing is gym_api.MultiCarRacing


def test_time_limit_truncates():
    env = fast(gym_api.make("CarRacing-v0", verbose=0, device="cpu"))
    env.max_episode_steps = 2
    env.seed(4)
    env.reset()
    _, _, d1, info1 = env.step([0.0, 0.5, 0.0])
    _, _, d2, info2 = env.step([0.0, 0.5, 0.0])
    assert not d1 and "TimeLimit.truncated" not in info1
    assert d2 and info2["TimeLimit.truncated"] is True
    env.reset()
    assert env._elapsed == 0


def test_step_refusals_and_render_before_reset():
    env = gym_api.MultiCarRacing(num_agents=1, verbose=0, device="cpu")
    assert env.render("rgb_array") is None
    with pytest.raises(RuntimeError, match="reset"):
        env.step(np.zeros((1, 3)))
    fast(env).seed(0)
    env.reset()
    with pytest.raises(ValueError, match="None"):
        env.step(None)
    with pytest.raises(AssertionError):
        env.render("ansi")


def test_box_matches_jax():
    shape = (2, 3)
    low, high = np.tile([-1.0, 0.0, 0.0], (2, 1)), np.ones(shape)
    box = gym_api.Box(low, high, shape, np.float32)
    jbox = jgym.Box(low, high, shape, np.float32)
    a = box.sample(np.random.RandomState(5))
    assert np.array_equal(a, jbox.sample(np.random.RandomState(5))) and a.dtype == np.float32
    assert box.contains(a) and not box.contains(a + 2.0) and not box.contains(a[0])
    free = gym_api.Box(-np.inf, np.inf, (4,), np.float32)
    jfree = jgym.Box(-np.inf, np.inf, (4,), np.float32)
    assert np.array_equal(free.sample(np.random.RandomState(1)),
                          jfree.sample(np.random.RandomState(1)))
    assert repr(box) == "Box(2, 3)"


def test_seed_fixes_track_and_direction_as_jax_host_generation():
    states = []
    for _ in range(2):
        env = fast(gym_api.MultiCarRacing(num_agents=2, verbose=0, global_seed=4,
                                          device="cpu"))
        assert env.seed(5) == [5]
        env.reset()
        states.append(env.state)
    a, b = states
    assert torch.equal(a.track.xy, b.track.xy) and torch.equal(a.direction_cw, b.direction_cw)
    assert a.reward.shape == (1, 2)                # the batched core's state, E = 1
    pts, _, _ = jhost.generate_track(jseeding.np_random(5)[0])
    n = len(pts)
    assert int(a.track.n_tiles[0]) == n
    assert np.array_equal(a.track.xy[0, :n].numpy(), np.asarray(pts[:, 2:4], np.float32))
    assert bool(a.direction_cw[0]) == (jseeding.GlobalStream(4).direction() == "CW")


def test_reset_observation_is_the_batched_core_s(capsys):
    env = fast(gym_api.MultiCarRacing(num_agents=2, verbose=1, global_seed=2, device="cpu"))
    env.seed(6)
    o = env.reset()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    st, info = penv.host_reset(env.cfg, seed=6, global_stream=seeding.GlobalStream(2),
                               device="cpu")
    assert line == f"Track generation: {info['n_tiles']}-tiles track ({info['retries']} retries)"
    assert np.array_equal(o, obs.pixel_observation_batched(env.cfg, st)[0].numpy())
    assert np.array_equal(env.render("state_pixels"), o)
    assert env.track_length == info["n_tiles"]
    assert env.reward.shape == (2,) and len(env.tile_visited_count) == 2
    assert env.driving_backward.shape == env.driving_on_grass.shape == (2,)


def test_render_human_headless_returns_frames(monkeypatch):
    """Without a display, render('human') returns the rgb_array frames."""
    for var in ("DISPLAY", "WAYLAND_DISPLAY", "MCR_FORCE_WINDOW"):
        monkeypatch.delenv(var, raising=False)
    env = fast(gym_api.MultiCarRacing(num_agents=1, verbose=0, device="cpu"))
    env.seed(2)
    env.reset()
    out = env.render("human")
    assert out.shape == (1, 400, 600, 3) and out.dtype == np.uint8
    assert np.array_equal(out, env.render("rgb_array"))
    env.close()
    assert env.state is None


def test_human_render_per_agent_windows(monkeypatch):
    """render('human') opens one window per agent with the reference's
    captions (mcr:529-536) and returns per-agent isopen bools
    (mcr:595-597); SDL's dummy video back end runs the real window path headless."""
    monkeypatch.setenv("SDL_VIDEODRIVER", "dummy")
    monkeypatch.setenv("MCR_FORCE_WINDOW", "1")
    pytest.importorskip("pygame")
    pytest.importorskip("pygame._sdl2.video")
    env = fast(gym_api.make("MultiCarRacing-v0", num_agents=2, verbose=0, device="cpu"))
    env.seed(3)
    env.reset()
    out = env.render("human")
    assert out.shape == (2,) and out.dtype == bool and out.all()
    viewer = env._viewer
    assert viewer is not None and len(viewer._windows) == 2
    assert [w.window.title for w in viewer._windows] == ["Car 0", "Car 1"]
    env.close()
    assert not viewer.isopen


def test_braking_grows_skid_segments():
    """The facade keeps skid trails: after a launch (the rear wheels spin),
    hard braking adds a segment per locked wheel per step; rgb_array draws
    them (the frame differs from the same state painted without them)."""
    env = fast(gym_api.MultiCarRacing(num_agents=1, verbose=0, use_random_direction=False,
                                      device="cpu"))
    env.seed(0)
    env.reset()
    for _ in range(30):            # the launch, through the core (no frames)
        env._state, _, _ = penv.step(env.cfg, env._state, torch.tensor([[[0.0, 1.0, 0.0]]]))
    before = int(env.state.skid.valid.sum())
    counts = []
    for _ in range(3):
        env.step([0.0, 0.0, 1.0])
        counts.append(int(env.state.skid.valid.sum()))
    assert before > 0 and counts[0] > before and counts[2] - counts[1] == 4, (before, counts)
    from multi_car_racing_tpu_torch.render import raster
    plain = raster.render_observation(env.cfg, env.state, 600, 400)[0].numpy()
    assert (env.render("rgb_array") != plain).any()


def test_monitor_records_video_and_stats(tmp_path):
    """The reference demo's gym.wrappers.Monitor (mcr:714-717): one video
    per episode and stats.json."""
    env = monitor.Monitor(fast(gym_api.make("CarRacing-v0", verbose=0, device="cpu")),
                          str(tmp_path), force=True)
    env.seed(5)
    env.reset()
    for _ in range(4):
        env.step(np.asarray([[0.0, 0.2, 0.0]]))
    env.close()
    vids = [f for f in os.listdir(tmp_path) if f.startswith("episode000000")]
    assert vids and os.path.getsize(tmp_path / vids[0]) > 0
    stats = json.load(open(tmp_path / "stats.json"))
    assert stats["episode_lengths"] == [4] and stats["episode_files"] == vids
    assert len(stats["episode_returns"]) == 1 and len(stats["episode_returns"][0]) == 1
    with pytest.raises(RuntimeError, match="force=True"):
        monitor.Monitor(gym_api.make("CarRacing-v0", device="cpu"), str(tmp_path))


def test_monitor_without_an_encoder(tmp_path, monkeypatch):
    """With no encoder, recording a video raises a clear error; stats-only
    recording still works."""
    monkeypatch.setattr(monitor, "encoders", lambda: [])
    env = monitor.Monitor(fast(gym_api.make("CarRacing-v0", verbose=0, device="cpu")),
                          str(tmp_path / "a"))
    env.seed(5)
    env.reset()
    env.step([0.0, 0.2, 0.0])
    with pytest.raises(RuntimeError, match="no video encoder"):
        env.close()
    env = monitor.Monitor(fast(gym_api.make("CarRacing-v0", verbose=0, device="cpu")),
                          str(tmp_path / "b"), video_callable=lambda i: False)
    env.seed(5)
    env.reset()
    env.step([0.0, 0.2, 0.0])
    env.close()
    stats = json.load(open(tmp_path / "b" / "stats.json"))
    assert stats["episode_lengths"] == [1] and stats["episode_files"] == [None]


def test_env_config_fields_match_jax_defaults():
    """``verbose`` is a field now (the facade reads it), with JAX's default."""
    from multi_car_racing_tpu import config as JC

    for f in ("verbose", "track_skid", "exact_hull_touch"):
        assert getattr(EnvConfig(), f) == getattr(JC.EnvConfig(), f), f
