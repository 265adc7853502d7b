"""The port's policy evaluation (learner/evaluate.py and the policy-step
helpers of learner/ppo.py) against the JAX package's, on the CPU.

- The helpers on the same numpy inputs: ``squash_env_action``, the clip of
  the raw Gaussian into the action box (evaluate.py's inline clip),
  ``_stack_obs`` / ``_push_frames`` / ``init_frames`` (oldest frame first,
  zero-filled), ``_rms_normalize`` and ``summarize``.
- The whole evaluation: JAX's own ``make_eval_fn``, unchanged, and the
  port's, from the same reset state, with a committed policy: the state
  policy ``multi2p`` at N = 2 and the pixel policy ``pixels_solved`` (K = 2,
  tanh-squashed) at N = 1, 30/12 solver iterations, a 32-step time limit
  (8 policy steps of 4 env steps). The reset state is the port's
  ``episode_state``; JAX reads it through a stand-in for its
  ``env.device_reset`` that returns the row whose key the eval drew
  (``split(split(PRNGKey(seed))[1], E)``, evaluate.py:49-52).

Bars: tiles and episode lengths equal; returns within 1e-3 for the state
policy (float32 nets on both sides) and within 0.05 for the pixel policy
(bfloat16 convolutions on both sides steer the cars a few 1e-3 apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multi_car_racing_tpu import config as JC, env as jenv
from multi_car_racing_tpu.learner import evaluate as jeval, ppo as jppo

from multi_car_racing_tpu_torch import EnvConfig, convert
from multi_car_racing_tpu_torch.learner import evaluate, ppo

from test_torch_obs import jax_state
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

SEED = 7
EVAL_STEPS = 32


def test_squash_and_clip_match_jax():
    u = (3 * np.random.RandomState(0).randn(64, 3)).astype(np.float32)
    got = ppo.squash_env_action(torch.from_numpy(u)).numpy()
    want = np.asarray(jppo.squash_env_action(jnp.asarray(u)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert got[:, 0].min() >= -1 and got[:, 1:].min() >= 0 and got.max() <= 1
    clipped = ppo.clip_env_action(torch.from_numpy(u)).numpy()
    m = jnp.asarray(u)
    want_clip = np.asarray(jnp.stack([jnp.clip(m[..., 0], -1, 1), jnp.clip(m[..., 1], 0, 1),
                                      jnp.clip(m[..., 2], 0, 1)], axis=-1))
    assert np.array_equal(clipped, want_clip)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_frame_stacking_matches_jax(k):
    rng = np.random.RandomState(k)
    frames = [rng.randint(0, 256, (2, 1, 4, 4, 3)).astype(np.uint8) for _ in range(4)]
    pcfg = ppo.PPOConfig(obs_type="pixels", frame_stack=k)
    jcfg = jppo.PPOConfig(obs_type="pixels", frame_stack=k)
    pbuf = ppo.init_frames(pcfg, torch.from_numpy(frames[0]))
    jbuf = jppo.init_frames(jcfg, jnp.asarray(frames[0]))
    assert (pbuf is None) == (jbuf is None) == (k == 1)
    if k > 1:
        assert pbuf.dtype == torch.uint8 and not pbuf.any()
        assert tuple(pbuf.shape) == (2, 1, 4, 4, 3 * (k - 1))
    for f in frames:
        pobs = ppo._stack_obs(pbuf, torch.from_numpy(f))
        jobs = jppo._stack_obs(jbuf, jnp.asarray(f))
        assert np.array_equal(pobs.numpy(), np.asarray(jobs))
        assert np.array_equal(pobs[..., -3:].numpy(), f)          # the newest frame last
        pbuf = ppo._push_frames(pbuf, torch.from_numpy(f))
        jbuf = jppo._push_frames(jbuf, jnp.asarray(f))
        if k > 1:
            assert np.array_equal(pbuf.numpy(), np.asarray(jbuf))
    assert ppo.init_frames(ppo.PPOConfig(obs_type="state", frame_stack=2),
                           torch.zeros(2, 1, 38)) is None


def test_rms_normalize_matches_jax():
    rng = np.random.RandomState(1)
    obs = (50 * rng.randn(3, 2, 38)).astype(np.float32)
    rms = {"mean": rng.randn(38).astype(np.float32),
           "var": rng.uniform(1e-3, 4, 38).astype(np.float32), "count": np.float32(9)}
    got = ppo._rms_normalize({k: torch.as_tensor(v) for k, v in rms.items()},
                             torch.from_numpy(obs)).numpy()
    want = np.asarray(jppo._rms_normalize({k: jnp.asarray(v) for k, v in rms.items()},
                                          jnp.asarray(obs)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    assert np.abs(got).max() == 10.0


def test_summarize_matches_jax():
    rng = np.random.RandomState(2)
    out = {"returns": rng.uniform(-100, 900, (5, 2)).astype(np.float32),
           "tiles": rng.randint(0, 300, (5, 2)).astype(np.int32),
           "n_tiles": rng.randint(280, 340, 5).astype(np.int32),
           "length": rng.randint(1, 1000, 5).astype(np.int32)}
    got = evaluate.summarize({k: torch.from_numpy(v) for k, v in out.items()})
    want = jeval.summarize({k: jnp.asarray(v) for k, v in out.items()})
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == pytest.approx(want[k], rel=1e-6), k


def _jax_device_reset(host, num_episodes):
    """A stand-in for JAX's ``env.device_reset`` inside ``make_eval_fn``: the
    row of the batched host state whose key the eval drew for it."""
    keys = jax.random.split(jax.random.split(jax.random.PRNGKey(SEED))[1], num_episodes)

    def device_reset(cfg, k):
        row = jnp.argmax(jnp.all(keys == k, axis=-1))
        return jax.tree_util.tree_map(lambda x: x[row], host)

    return device_reset


@pytest.mark.parametrize("name,episodes,ret_tol", [("multi2p", 3, 1e-3),
                                                   ("pixels_solved", 2, 0.05)])
def test_eval_matches_jax_make_eval_fn(monkeypatch, name, episodes, ret_tol):
    net, rms, env_cfg, flags, _ = evaluate.load_policy(name, device="cpu")
    env_cfg = dataclasses.replace(env_cfg, velocity_iters=30, position_iters=12,
                                  max_episode_steps=EVAL_STEPS)
    pcfg = ppo.PPOConfig(num_envs=episodes, **flags)
    state = evaluate.episode_state(env_cfg, episodes, SEED, device="cpu")
    host = jax_state(convert.env_state_to_numpy(state))

    jcfg = JC.EnvConfig(**{f.name: getattr(env_cfg, f.name)
                           for f in dataclasses.fields(env_cfg)}, solver="xla")
    jpcfg = jppo.PPOConfig(num_envs=episodes, **flags)
    monkeypatch.setattr(jenv, "device_reset", _jax_device_reset(host, episodes))
    params, obs_rms = evaluate.read_policy_file(
        f"{evaluate.POLICY_DIR}/{name}.npz")
    jrms = None if obs_rms is None else {k: jnp.asarray(v) for k, v in obs_rms.items()}
    want = jax.device_get(jeval.make_eval_fn(jcfg, jpcfg, episodes)(
        params, jrms, jax.random.PRNGKey(SEED)))

    got = evaluate.make_eval_fn(env_cfg, pcfg, episodes)(net, rms, state)
    got = {k: v.numpy() for k, v in got.items()}
    assert np.array_equal(got["length"], want["length"])
    assert np.array_equal(got["tiles"], want["tiles"])
    assert np.array_equal(got["n_tiles"], want["n_tiles"])
    assert got["tiles"].min() > 0                      # the cars drove onto new tiles
    np.testing.assert_allclose(got["returns"], want["returns"], rtol=0, atol=ret_tol)
    s, js = evaluate.summarize(got), jeval.summarize(want)
    assert s["eval_len"] == js["eval_len"] and s["eval_tiles_frac"] == js["eval_tiles_frac"]


def test_episode_state_draws_one_track_per_episode():
    env_cfg = EnvConfig(num_agents=1, use_random_direction=False, backwards_flag=False)
    a = evaluate.episode_state(env_cfg, 3, SEED, device="cpu")
    b = evaluate.episode_state(env_cfg, 3, SEED, device="cpu")
    c = evaluate.episode_state(env_cfg, 3, SEED + 1, device="cpu")
    assert torch.equal(a.track.xy, b.track.xy)                  # the seed fixes the tracks
    assert len({tuple(x.flatten()[:8].tolist()) for x in a.track.xy}) == 3
    assert not torch.equal(a.track.xy, c.track.xy)
    assert ppo.derived_seeds(SEED, 3, 1) != ppo.derived_seeds(SEED, 3, 0)


def _short_episodes(monkeypatch):
    """main's env configs at 4/2 solver iterations and a 8-step time limit."""
    from types import SimpleNamespace

    def short(**kw):
        return EnvConfig(**kw, velocity_iters=4, position_iters=2, max_episode_steps=8)

    monkeypatch.setattr(evaluate, "C", SimpleNamespace(EnvConfig=short))


@pytest.mark.parametrize("argv", [
    ["--policy", "multi2p"],
    ["--checkpoint", f"{evaluate.POLICY_DIR}/pixels_solved.npz", "--carracing-v0", "--obs",
     "pixels", "--action-repeat", "4", "--squash-actions", "--frame-stack", "2"]])
def test_main_prints_the_summary(monkeypatch, capsys, argv):
    import json

    _short_episodes(monkeypatch)
    evaluate.main(argv + ["--episodes", "2", "--seed", "3", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["eval_episodes"] == 2 and out["eval_len"] == 7.0
    assert set(out) == set(jeval.summarize({"returns": np.zeros((1, 1)), "tiles": np.zeros(
        (1, 1)), "n_tiles": np.ones(1), "length": np.zeros(1)}))


def test_main_reads_a_port_checkpoint(monkeypatch, capsys, tmp_path):
    import json

    from multi_car_racing_tpu_torch import checkpoint

    _short_episodes(monkeypatch)
    cfg = EnvConfig(num_agents=2, velocity_iters=4, position_iters=2)
    ts = ppo.init_train_state(cfg, ppo.PPOConfig(num_envs=2, pool_size=2, normalize_obs=True,
                                                 width=32, action_repeat=2), 0, device="cpu")
    checkpoint.save(str(tmp_path / "ck"), ts)
    evaluate.main(["--checkpoint", str(tmp_path / "ck"), "--episodes", "2", "--device", "cpu"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["eval_episodes"] == 2 and np.isfinite(out["eval_return"])
