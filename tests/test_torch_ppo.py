"""The port's PPO learner (learner/ppo.py) against the JAX package's, on the
CPU, and its own behaviours (mirroring tests/test_learner.py).

Against JAX:
- ``_rms_update`` with and without a mask (an all-masked batch is a
  no-op), ``_skipped_tiles`` on tests/test_learner.py's cases,
  ``_logp_gauss`` / ``_logp_squashed`` on the same numpy inputs, and
  ``ClippedAdam`` against optax's ``chain(clip_by_global_norm, adam)`` with
  the linear schedule over steps that clip, steps that do not, and skipped
  steps selected away as the train step selects them.
- One whole train step: tests/test_learner.py's tiny configuration (8/3
  solver iterations, 4 envs, T = 4, 2 minibatches, 1 epoch) at N = 1 and
  R = 1, with the state recipe's normalisation, grass and skip costs and
  annealed learning rate. Both packages start from the same reset state
  (the port's, read by JAX through the same field names) and the same flax
  parameters, and the port takes JAX's own draws: the rollout's action
  noise from the key splits of ppo.py:343 and :363, each epoch's
  ``permutation(k_ep, B)`` (:563, :605). No env finishes in 4 steps, so the
  autoreset draws play no part. Bars: every metric within
  1e-4 * max(1, |x|); obs_rms within 1e-5 * max(1, |x|); parameters within
  2 * lr per applied update (Adam's first step is lr * sign(g), and a
  gradient near 0 flips sign on float noise), and fewer than 1% of each
  leaf's elements more than 1e-5 apart. JAX's side is a module fixture,
  computed once for the tests that hold the port to it.
- The same step on two gloo ranks (``parallel.mesh``; 4 envs as rows
  2 + 2, child processes through tests/torch_dist.py) against the same
  JAX step, to the same bars: GSPMD's sharded step computes the one-device
  function (tests/test_mesh_kernels.py), so that is the reference. The
  ranks' learner is gathered by ``checkpoint.save``.
- A ragged layout (5 envs as rows 3 + 2) against one process, port only,
  with a first permutation that leaves rank 1 no member of the first
  minibatch (it must still join every collective).
- The pixel learner (frame_stack = 2, 4 envs as rows 2 + 2) against one
  process, port only, with every episode ending inside the rollout: each
  rank slices its frame stacks, resets the frames of its finished rows,
  and the checkpoint gathers the frames. Both sides run the torso in
  float32 (``networks.PIXEL_COMPUTE_DTYPE``): in bfloat16 each rank's
  gradient is rounded before the sum, where one process rounds the sum,
  and the gradient norm parts past the 1e-4 bar.
- ``MCR_PPO_DEBUG_STATS``: JAX's six unreduced (epochs, minibatches)
  statistics under JAX's keys; their loss mean is the step's ``loss``.
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from multi_car_racing_tpu import config as JC
from multi_car_racing_tpu.learner import ppo as jppo
from multi_car_racing_tpu.learner.networks import ActorCritic as JaxActorCritic

from multi_car_racing_tpu_torch import EnvConfig, checkpoint, convert, env as penv
from multi_car_racing_tpu_torch.learner import evaluate, networks, ppo
from multi_car_racing_tpu_torch.learner.networks import ActorCritic

from test_torch_obs import jax_state
from torch_dist import step_ranks
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

METRIC_TOL = 1e-4
RMS_TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.asarray(x))


# ---------------------------------------------------------------- helpers vs JAX


def test_rms_update_matches_jax():
    rng = np.random.RandomState(0)
    batch = np.concatenate([rng.randn(40, 3), np.full((8, 3), 1e30)]).astype(np.float32)
    mask = np.concatenate([np.ones(40), np.zeros(8)]).astype(np.float32)
    rms = dict(mean=rng.randn(3).astype(np.float32), var=rng.uniform(0.5, 2, 3).astype(
        np.float32), count=np.float32(12.0))
    trms = {k: _t(v) for k, v in rms.items()}
    jrms = {k: jnp.asarray(v) for k, v in rms.items()}
    for m in (mask, None):
        got = ppo._rms_update(trms, _t(batch[:40] if m is None else batch),
                              None if m is None else _t(m))
        want = jppo._rms_update(jrms, jnp.asarray(batch[:40] if m is None else batch),
                                None if m is None else jnp.asarray(m))
        for k in rms:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # An all-masked batch (NaN rows included) leaves the statistics as they were.
    nan_batch = np.full((5, 3), np.nan, np.float32)
    same = ppo._rms_update(trms, _t(nan_batch), torch.zeros(5))
    for k in rms:
        assert torch.equal(same[k], trms[k]), k


def _tiles_state(visited_idx, n=10, mt=12):
    v = np.zeros((1, 1, mt), bool)
    v[0, 0, visited_idx] = True
    valid = np.zeros((1, mt), bool)
    valid[0, :n] = True
    return v, valid, np.asarray([n], np.int32)


@pytest.mark.parametrize("visited,skipped", [
    ([0, 1, 2, 3], 0), ([8, 9, 0, 1], 0), ([0, 1, 2, 4, 5], 1), ([0, 1, 3, 5], 2),
    (list(range(10)), 0), ([], 0), ([9, 1, 2, 3], 1)])
def test_skipped_tiles_matches_jax(visited, skipped):
    v, valid, n = _tiles_state(visited)
    got = ppo._skipped_tiles(SimpleNamespace(
        visited=_t(v), track=SimpleNamespace(valid=_t(valid), n_tiles=_t(n))))
    want = jppo._skipped_tiles(SimpleNamespace(
        visited=jnp.asarray(v), track=SimpleNamespace(valid=jnp.asarray(valid),
                                                      n_tiles=jnp.asarray(n))))
    assert got.dtype == torch.float32
    assert float(got[0, 0]) == float(want[0, 0]) == skipped


def test_logp_matches_jax():
    rng = np.random.RandomState(3)
    mean, u = (rng.randn(2, 64, 3) * 2).astype(np.float32)
    log_std = rng.uniform(-2, 0.5, (64, 3)).astype(np.float32)
    for tf, jf in ((ppo._logp_gauss, jppo._logp_gauss),
                   (ppo._logp_squashed, jppo._logp_squashed)):
        got = tf(_t(mean), _t(log_std), _t(u)).numpy()
        want = np.asarray(jf(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(u)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_clipped_adam_matches_optax():
    """Eight updates of a 2-leaf tree: large gradients (clipped), small ones
    (not), a NaN gradient and a forced skip, both selected away."""
    cfg = ppo.PPOConfig(lr=1e-2, max_grad_norm=0.5, anneal_lr=True, total_updates=2,
                        epochs=2, minibatches=2)
    rng = np.random.RandomState(4)
    p0 = [rng.randn(3, 4).astype(np.float32), rng.randn(5).astype(np.float32)]
    tparams = [torch.nn.Parameter(_t(p.copy())) for p in p0]
    opt = ppo.ClippedAdam(tparams, cfg)
    tx = optax.chain(optax.clip_by_global_norm(cfg.max_grad_norm),
                     optax.adam(optax.linear_schedule(cfg.lr, 0.0, 8)))
    jparams = [jnp.asarray(p) for p in p0]
    jstate = tx.init(jparams)
    for i in range(8):
        scale = 5.0 if i % 2 else 0.05
        grads = [(scale * rng.randn(*p.shape)).astype(np.float32) for p in p0]
        if i == 3:
            grads[1][2] = np.nan
        ok = np.isfinite(optax.global_norm([jnp.asarray(g) for g in grads])) and i != 5
        opt.step([_t(g) for g in grads], torch.tensor(bool(ok)))
        safe = [jnp.where(ok, jnp.asarray(g), 0.0) for g in grads]
        updates, new_state = tx.update(safe, jstate, jparams)
        new_params = optax.apply_updates(jparams, updates)
        jparams = [jnp.where(ok, n, o) for n, o in zip(new_params, jparams)]
        jstate = jax.tree_util.tree_map(lambda n, o: jnp.where(ok, n, o), new_state, jstate)
        for tp, jp in zip(tparams, jparams):
            np.testing.assert_allclose(tp.detach().numpy(), np.asarray(jp), rtol=1e-6,
                                       atol=1e-7)
    assert int(opt.count) == int(jstate[1][0].count) == 6


# ------------------------------------------------------------ the env helpers


def test_env_helpers_for_the_learner():
    cfg = EnvConfig(num_agents=2, velocity_iters=8, position_iters=3, max_episode_steps=5)
    pool = penv.make_host_track_pool(cfg, (0, 1, 2), device="cpu")
    g = torch.Generator().manual_seed(3)
    draws = penv.draw_episodes(cfg, 4, 3, g)
    fresh = penv.episodes_from_pool(cfg, pool, *draws)
    assert torch.equal(fresh.track.xy, pool.xy[draws[0]])
    assert penv.finite_cars(fresh).all() and not penv.episode_over(cfg, fresh).any()
    # reset_envs_from_pool with every env over is episodes_from_pool.
    over = fresh.replace(done=torch.ones(4, dtype=torch.bool))
    again = penv.reset_envs_from_pool(cfg, over, pool, *draws)
    assert torch.equal(again.cars.hull_c, fresh.cars.hull_c)
    hull_v = fresh.cars.hull_v.clone()
    hull_v[2, 1, 0] = float("inf")
    bad = fresh.replace(cars=fresh.cars.replace(hull_v=hull_v),
                        steps=torch.tensor([0, 5, 1, 9], dtype=torch.int32))
    assert penv.finite_cars(bad).tolist() == [True, True, False, True]
    assert penv.episode_over(cfg, bad).tolist() == [False, True, False, True]


# ------------------------------------------------- one train step against JAX's

T_PAR, E_PAR = 4, 4


def _parity_cfgs():
    kw = dict(rollout_len=T_PAR, num_envs=E_PAR, pool_size=2, minibatches=2, epochs=1,
              normalize_obs=True, train_grass_cost=0.5, train_skip_cost=2.0, anneal_lr=True)
    return (EnvConfig(num_agents=1, velocity_iters=8, position_iters=3),
            ppo.PPOConfig(**kw),
            JC.EnvConfig(num_agents=1, velocity_iters=8, position_iters=3, solver="xla"),
            jppo.PPOConfig(**kw))


def _jax_draws(key, jpcfg, n_agents):
    """The normals and permutations JAX's train_step draws from ``key``."""
    _, k_roll, _, k_perm = jax.random.split(key, 4)
    noise, k = [], k_roll
    for _ in range(jpcfg.rollout_len):
        k, k_act = jax.random.split(k)
        noise.append(np.asarray(jax.random.normal(k_act, (jpcfg.num_envs, n_agents, 3))))
    B = jpcfg.rollout_len * jpcfg.num_envs * n_agents
    perm = [np.asarray(jax.random.permutation(k_ep, B))
            for k_ep in jax.random.split(k_perm, jpcfg.epochs)]
    return {"noise": torch.from_numpy(np.stack(noise)),
            "perm": torch.from_numpy(np.stack(perm)).long()}


@pytest.fixture(scope="module")
def jax_step():
    """The parity inputs (the port's reset state, flax parameters, JAX's
    draws) and JAX's train step on them, computed once."""
    cfg, pcfg, jcfg, jpcfg = _parity_cfgs()
    state = penv.reset_batch(cfg, range(E_PAR), E_PAR, device="cpu")
    tree = convert.env_state_to_numpy(state)
    host = jax_state(tree)
    pool_tree = {k: v[:2] for k, v in tree["track"].items()}

    jnet = JaxActorCritic(obs_type="state", width=jpcfg.width)
    params = jnet.init(jax.random.PRNGKey(1), jnp.zeros((E_PAR, 1, 38)))
    key = jax.random.PRNGKey(0)
    jts = jppo.TrainState(
        params=params, opt_state=jppo.optimizer(jpcfg).init(params), env_state=host,
        pool=jax.tree_util.tree_map(lambda x: x[:2], host.track), key=key,
        update_i=jnp.asarray(0, jnp.int32), obs_rms=jppo._rms_init(38), frames=None)
    jts2, jm = jax.jit(jppo.make_train_step(jcfg, jpcfg))(jts)
    return SimpleNamespace(cfg=cfg, pcfg=pcfg, state=state, pool_tree=pool_tree,
                           params=jax.device_get(params), draws=_jax_draws(key, jpcfg, 1),
                           jts2=jts2, jm={k: float(v) for k, v in jm.items()})


def _port_state(j):
    """The port's learner on the parity inputs, fresh."""
    net, _ = convert.policy_from_numpy(j.params, obs_type="state", width=j.pcfg.width,
                                       frame_stack=1, device="cpu")
    return ppo.TrainState(
        net=net, opt=ppo.ClippedAdam(net.parameters(), j.pcfg), env_state=j.state,
        pool=convert.track_from_numpy(j.pool_tree, device="cpu"),
        generator=torch.Generator().manual_seed(0), update_i=0, env_cfg=j.cfg,
        ppo_cfg=j.pcfg, obs_rms=ppo._rms_init(38, "cpu"))


def _assert_step_matches(m, ts2, want_m, want_params, want_rms, want_tiles, want_hull, pcfg):
    """The parity bars of the module docstring."""
    assert m.keys() == want_m.keys()
    for k, want in want_m.items():
        assert abs(m[k] - want) <= METRIC_TOL * max(1.0, abs(want)), (k, m[k], want)
    applied = pcfg.epochs * pcfg.minibatches - m["skipped_updates"]
    assert applied == pcfg.epochs * pcfg.minibatches
    back, rms = convert.policy_to_numpy(ts2.net, ts2.obs_rms)
    flat_w = jax.tree_util.tree_leaves_with_path(want_params)
    flat_t = jax.tree_util.tree_leaves_with_path(back)
    assert len(flat_w) == len(flat_t)
    for (path, a), (_, b) in zip(flat_w, flat_t):
        assert np.abs(a - b).max() <= 2 * pcfg.lr * applied, path
        assert np.mean(np.abs(a - b) > 1e-5) < 0.01, path     # sign flips stay rare
    assert (rms is None) == (want_rms is None)
    for k in ("mean", "var", "count") if rms is not None else ():
        want = np.asarray(want_rms[k])
        assert np.abs(rms[k] - want).max() <= RMS_TOL * max(1.0, float(np.abs(want).max())), k
    assert ts2.update_i == 1 and int(ts2.opt.count) == applied
    # The env went on from where the reference's went: the same tiles, the cars together.
    assert np.array_equal(ts2.env_state.tile_visited_count.numpy(), np.asarray(want_tiles))
    np.testing.assert_allclose(ts2.env_state.cars.hull_c.numpy(), np.asarray(want_hull),
                               rtol=0, atol=1e-3)


def _assert_matches_jax(m, ts2, j):
    assert m["episodes_finished"] == j.jm["episodes_finished"] == 0.0     # no autoreset
    assert not bool(np.asarray(j.jts2.env_state.done).any())
    _assert_step_matches(m, ts2, j.jm, jax.device_get(j.jts2.params), j.jts2.obs_rms,
                         j.jts2.env_state.tile_visited_count, j.jts2.env_state.cars.hull_c,
                         j.pcfg)


def test_one_train_step_matches_jax(jax_step):
    ts2, m = ppo.make_train_step(jax_step.cfg, jax_step.pcfg)(_port_state(jax_step),
                                                             draws=jax_step.draws)
    _assert_matches_jax({k: float(v) for k, v in m.items()}, ts2, jax_step)


def _ragged_case():
    """5 envs as rows 3 + 2, two epochs; the first epoch's permutation puts
    rank 0's 12 samples first, so rank 1 owns none of minibatch 0."""
    cfg = EnvConfig(num_agents=1, velocity_iters=8, position_iters=3)
    pcfg = ppo.PPOConfig(rollout_len=T_PAR, num_envs=5, pool_size=2, minibatches=2,
                         epochs=2, normalize_obs=True, train_grass_cost=0.5,
                         train_skip_cost=2.0, anneal_lr=True)
    net = ActorCritic(obs_type="state", width=pcfg.width, frame_stack=1,
                      generator=torch.Generator().manual_seed(3))
    ts = ppo.TrainState(
        net=net, opt=ppo.ClippedAdam(net.parameters(), pcfg),
        env_state=penv.reset_batch(cfg, range(5), 5, device="cpu"),
        pool=penv.make_host_track_pool(cfg, (5, 6), device="cpu"),
        generator=torch.Generator().manual_seed(0), update_i=0, env_cfg=cfg, ppo_cfg=pcfg,
        obs_rms=ppo._rms_init(38, "cpu"))
    g = torch.Generator().manual_seed(4)
    B = T_PAR * 5
    rank0 = (torch.arange(B) % 5) < 3                     # N = 1: sample b is env b % 5
    own0, own1 = torch.nonzero(rank0).flatten(), torch.nonzero(~rank0).flatten()
    first = torch.cat([own0[torch.randperm(12, generator=g)],
                       own1[torch.randperm(8, generator=g)]])
    return ts, {"noise": torch.randn((T_PAR, 5, 1, 3), generator=g),
                "perm": torch.stack([first, torch.randperm(B, generator=g)])}


def _pixel_case():
    """4 pixel envs as rows 2 + 2, frame_stack = 2; envs 1 and 2 (one on
    each rank) start 3 steps into a 6-step episode, so they end inside the
    4-step rollout and are reset, frames and all, while envs 0 and 3 go on."""
    cfg = EnvConfig(num_agents=1, velocity_iters=8, position_iters=3, max_episode_steps=6)
    pcfg = ppo.PPOConfig(rollout_len=T_PAR, num_envs=4, pool_size=2, minibatches=2, epochs=1,
                         obs_type="pixels", frame_stack=2)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    ts.env_state.steps[1:3] = 3
    g = torch.Generator().manual_seed(5)
    # Earlier frames in the stack (zeros at a fresh start), so that each
    # rank must restore its own rows' frames.
    ts.frames = torch.randint(0, 256, ts.frames.shape, generator=g, dtype=torch.uint8)
    return ts, {
        "noise": torch.randn((T_PAR, 4, 1, 3), generator=g),
        "perm": torch.randperm(T_PAR * 4, generator=g)[None]}


@pytest.fixture(scope="module")
def two_rank_steps(jax_step, tmp_path_factory):
    """The parity, ragged and pixel steps, each on two gloo ranks (child
    processes, one launch): {case: (rank 0's metrics, the gathered learner
    restored on the CPU, the saved input's path, the draws)}."""
    d = tmp_path_factory.mktemp("two_rank")
    cases = {"jax": (_port_state(jax_step), jax_step.draws), "ragged": _ragged_case(),
             "pixels": _pixel_case()}
    jobs = []
    for name, (ts, draws) in cases.items():
        job = tuple(str(d / f"{name}_{n}") for n in ("state", "draws.pt", "out"))
        checkpoint.save(job[0], ts)
        torch.save(draws, job[1])
        jobs.append(job + (("fp32",) if name == "pixels" else ()))
    codes, outs = step_ranks(jobs)
    assert codes == [0, 0], outs
    out = {}
    for name, (state, draws, path, *_) in zip(cases, jobs):
        metrics = [torch.load(f"{path}.rank{r}.metrics", weights_only=True) for r in (0, 1)]
        assert metrics[0] == metrics[1], metrics                 # every rank the same
        out[name] = (metrics[0], checkpoint.restore(path, device="cpu"), state,
                     cases[name][1])
    return out


def test_two_rank_train_step_matches_jax(jax_step, two_rank_steps):
    m, ts2, _, _ = two_rank_steps["jax"]
    _assert_matches_jax(m, ts2, jax_step)


def _assert_matches_one_process(case):
    """The two-rank step of ``case`` against the same step in one process;
    returns both learners after it."""
    m2, ts2, state, draws = case
    one = checkpoint.restore(state, device="cpu")
    one, m1 = ppo.make_train_step(one.env_cfg, one.ppo_cfg)(one, draws=draws)
    params, rms = convert.policy_to_numpy(one.net, one.obs_rms)
    _assert_step_matches(m2, ts2, {k: float(v) for k, v in m1.items()}, params, rms,
                         one.env_state.tile_visited_count, one.env_state.cars.hull_c,
                         one.ppo_cfg)
    return ts2, one


def test_ragged_two_rank_step_matches_one_process(two_rank_steps):
    _assert_matches_one_process(two_rank_steps["ragged"])


def test_pixel_two_rank_step_matches_one_process(two_rank_steps, monkeypatch):
    monkeypatch.setattr(networks, "PIXEL_COMPUTE_DTYPE", torch.float32)    # as the ranks ran
    ts2, one = _assert_matches_one_process(two_rank_steps["pixels"])
    assert two_rank_steps["pixels"][0]["episodes_finished"] == 2.0     # envs 1 and 2
    live = ts2.frames.flatten(1).sum(1) > 0
    assert live.tolist() == [True, False, False, True]      # the reset rows' frames zeroed
    assert torch.equal(ts2.frames, one.frames)


def test_debug_stats_match_jax_keys(monkeypatch, jax_step):
    monkeypatch.setenv("MCR_PPO_DEBUG_STATS", "1")
    _, st = ppo.make_train_step(jax_step.cfg, jax_step.pcfg)(_port_state(jax_step),
                                                            draws=jax_step.draws)
    assert set(st) == {"stats_loss", "stats_pg", "stats_v", "stats_dlogp", "stats_kl",
                       "stats_gn"}
    shape = (jax_step.pcfg.epochs, jax_step.pcfg.minibatches)
    assert all(tuple(v.shape) == shape for v in st.values())
    want = jax_step.jm["loss"]
    assert abs(float(st["stats_loss"].mean()) - want) <= METRIC_TOL * max(1.0, abs(want))
    assert float(st["stats_dlogp"].max()) == pytest.approx(jax_step.jm["dlogp_max"],
                                                           rel=METRIC_TOL, abs=METRIC_TOL)


# -------------------------------------------- the port's own learner behaviours


def _tiny(n_agents=2, n_envs=4, **kw):
    env_kw = {k: kw.pop(k) for k in ("max_episode_steps",) if k in kw}
    cfg = EnvConfig(num_agents=n_agents, velocity_iters=8, position_iters=3, **env_kw)
    pcfg = ppo.PPOConfig(**{**dict(rollout_len=4, num_envs=n_envs, pool_size=2,
                                   minibatches=2, epochs=1), **kw})
    return cfg, pcfg


def _params(ts):
    return [p.detach().clone() for p in ts.net.parameters()]


def _moved(before, ts):
    return max(float((a - b.detach()).abs().max()) for a, b in zip(before, ts.net.parameters()))


def _finite(ts):
    return all(bool(torch.isfinite(p).all()) for p in ts.net.parameters())


def test_train_step_updates_params():
    cfg, pcfg = _tiny()
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    p0 = _params(ts)
    ts2, metrics = ppo.make_train_step(cfg, pcfg)(ts)
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert _moved(p0, ts2) > 0 and ts2.update_i == 1


def test_value_loss_falls_over_six_updates():
    cfg, pcfg = _tiny(n_envs=8)
    ts = ppo.init_train_state(cfg, pcfg, 1, device="cpu")
    step = ppo.make_train_step(cfg, pcfg)
    losses = []
    for _ in range(6):
        ts, metrics = step(ts)
        losses.append(float(metrics["v_loss"]))
    assert losses[-1] < losses[0], losses


def test_frame_stacking_pixels():
    cfg, pcfg = _tiny(n_agents=1, n_envs=2, rollout_len=2, minibatches=1, obs_type="pixels",
                      frame_stack=2, action_repeat=2, train_step_cost=0.05,
                      train_step_cost_start=1, train_step_cost_ramp=2)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    assert tuple(ts.frames.shape) == (2, 1, 96, 96, 3) and ts.frames.dtype == torch.uint8
    assert ts.net.torso.convs[0].weight.shape[1] == 6
    p0 = _params(ts)
    ts2, metrics = ppo.make_train_step(cfg, pcfg)(ts)
    assert np.isfinite(float(metrics["loss"])) and _moved(p0, ts2) > 0
    assert int(ts2.frames.sum()) > 0                   # the buffer advanced
    eval_cfg = dataclasses.replace(cfg, max_episode_steps=6)
    state = evaluate.episode_state(eval_cfg, 2, 5, device="cpu")
    out = evaluate.make_eval_fn(eval_cfg, pcfg, 2)(ts2.net, ts2.obs_rms, state)
    assert np.isfinite(evaluate.summarize(out)["eval_return"])


def test_all_envs_finished_no_nan():
    """Every env past the time limit inside one rollout must not NaN the update."""
    cfg, pcfg = _tiny(max_episode_steps=3, rollout_len=6, normalize_obs=True,
                      train_grass_cost=0.5, train_skip_cost=2.0)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    step = ppo.make_train_step(cfg, pcfg)
    for _ in range(3):
        ts, metrics = step(ts)
        for k in ("loss", "pg_loss", "v_loss"):
            assert np.isfinite(float(metrics[k])), k
        assert float(metrics["episodes_finished"]) == 4
        assert _finite(ts)
        assert torch.isfinite(ts.obs_rms["mean"]).all() and torch.isfinite(ts.obs_rms["var"]).all()


def test_nan_env_quarantined():
    """A nonfinite env is marked done and reset, counted in nan_envs, and
    every loss, parameter and statistic stays finite."""
    cfg, pcfg = _tiny(normalize_obs=True, action_repeat=2, train_grass_cost=0.5,
                      train_skip_cost=2.0)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    cars = ts.env_state.cars
    hull_c, hull_v = cars.hull_c.clone(), cars.hull_v.clone()
    hull_c[1], hull_v[1] = float("nan"), float("nan")
    ts = dataclasses.replace(ts, env_state=ts.env_state.replace(
        cars=cars.replace(hull_c=hull_c, hull_v=hull_v)))
    step = ppo.make_train_step(cfg, pcfg)
    ts, metrics = step(ts)
    assert float(metrics["nan_envs"]) >= 1.0
    for k in ("loss", "pg_loss", "v_loss", "mean_step_reward", "mean_value", "ep_return"):
        assert np.isfinite(float(metrics[k])), k
    assert _finite(ts)
    assert torch.isfinite(ts.obs_rms["mean"]).all() and torch.isfinite(ts.obs_rms["var"]).all()
    assert torch.isfinite(ts.env_state.cars.hull_c).all()     # the autoreset replaced it
    ts, metrics = step(ts)
    assert np.isfinite(float(metrics["loss"]))


def test_kl_early_stop_masks_updates():
    cfg, pcfg = _tiny(n_agents=1, minibatches=4, epochs=2, kl_target=1e-9)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    p0 = _params(ts)
    ts, metrics = ppo.make_train_step(cfg, pcfg)(ts)
    skipped = float(metrics["skipped_updates"])
    assert 1.0 <= skipped < 8.0                          # the first minibatch applies
    assert int(ts.opt.count) == 8 - skipped             # skipped updates leave Adam's count
    assert _moved(p0, ts) > 0 and np.isfinite(float(metrics["loss"]))


def test_squashed_action_head():
    u = torch.tensor([[0.3, -1.2, 2.0], [0.0, 0.5, -0.7]])
    mean, log_std = torch.zeros(2, 3), torch.full((2, 3), -0.5)
    expect = ppo._logp_gauss(mean, log_std, u) - torch.log(1.0 - torch.tanh(u) ** 2).sum(-1)
    np.testing.assert_allclose(ppo._logp_squashed(mean, log_std, u).numpy(), expect.numpy(),
                               rtol=1e-5)
    cfg, pcfg = _tiny(n_agents=1, squash_actions=True)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    ts, metrics = ppo.make_train_step(cfg, pcfg)(ts)
    assert np.isfinite(float(metrics["loss"])) and _finite(ts)
    a = ppo.squash_env_action(torch.tensor([[5.0, -5.0, 0.1]]))[0]
    assert -1 <= a[0] <= 1 and 0 <= a[1] <= 1 and 0 <= a[2] <= 1


def test_init_train_state_draws_from_its_pool():
    """As JAX's (ppo.py:227-232): a checked pool of tracks generated on the
    device for the autoresets, and first episodes on tracks of their own
    (device_reset), both reproducible from the seed."""
    cfg, pcfg = _tiny(n_envs=6, pool_size=3)
    ts = ppo.init_train_state(cfg, pcfg, 2, device="cpu")
    assert tuple(ts.pool.xy.shape) == (3, cfg.max_tiles, 2)
    assert bool((ts.pool.n_tiles >= 200).all()) and not bool(ts.env_state.done.any())
    assert len({tuple(x.flatten()[:8].tolist()) for x in ts.env_state.track.xy}) == 6
    again = ppo.init_train_state(cfg, pcfg, 2, device="cpu")
    assert torch.equal(ts.pool.xy, again.pool.xy)
    assert torch.equal(ts.env_state.cars.hull_c, again.env_state.cars.hull_c)
    assert all(torch.equal(a, b) for a, b in zip(ts.net.parameters(), again.net.parameters()))
    assert ts.obs_rms is None and ts.frames is None and ts.update_i == 0
