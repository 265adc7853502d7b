"""The port's learner checkpoint (checkpoint.py) on the CPU, no JAX.

- save then restore gives back every tensor of the TrainState equal: the
  network's and the optimizer's state, the env state and the pool, the
  generator's state, update_i, obs_rms, the frame buffer and both configs;
- saves alternate between the two slots, the pointer naming the newest;
- a newest slot truncated mid-write, with the pointer still on the older
  one (a crash before the pointer moved), restores the older;
- a restored learner trains to the same parameters, metrics and env state
  as the one that was never saved;
- without a card the learner's entry points (``init_train_state``,
  ``episode_state``, ``load_policy``, ``restore``) raise unless told
  ``device="cpu"``.
"""

import dataclasses
import os

import pytest
import torch

from multi_car_racing_tpu_torch import EnvConfig, checkpoint, convert
from multi_car_racing_tpu_torch.learner import ppo
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)


def _tiny(**kw):
    cfg = EnvConfig(num_agents=2, velocity_iters=8, position_iters=3)
    pcfg = ppo.PPOConfig(rollout_len=3, num_envs=3, pool_size=2, minibatches=2, epochs=1,
                         **kw)
    return cfg, pcfg


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    return [tree]


def assert_same(a: ppo.TrainState, b: ppo.TrainState):
    for (ka, va), (kb, vb) in zip(a.net.state_dict().items(), b.net.state_dict().items()):
        assert ka == kb and torch.equal(va, vb), ka
    sa, sb = a.opt.state_dict(), b.opt.state_dict()
    assert torch.equal(sa["count"], sb["count"])
    for key in ("mu", "nu"):
        assert all(torch.equal(x, y) for x, y in zip(sa[key], sb[key])), key
    for tree_a, tree_b in ((convert.env_state_to_numpy(a.env_state),
                            convert.env_state_to_numpy(b.env_state)),
                           (convert.track_to_numpy(a.pool), convert.track_to_numpy(b.pool))):
        la, lb = _leaves(tree_a), _leaves(tree_b)
        assert len(la) == len(lb)
        assert all(x.dtype == y.dtype and (x == y).all() for x, y in zip(la, lb))
    assert torch.equal(a.generator.get_state(), b.generator.get_state())
    assert a.update_i == b.update_i
    assert a.env_cfg == b.env_cfg and a.ppo_cfg == b.ppo_cfg
    assert (a.obs_rms is None) == (b.obs_rms is None)
    for k in (a.obs_rms or {}):
        assert torch.equal(a.obs_rms[k], b.obs_rms[k]), k
    assert (a.frames is None) == (b.frames is None)
    if a.frames is not None:
        assert torch.equal(a.frames, b.frames)


def test_round_trip_is_tensor_equal(tmp_path):
    cfg, pcfg = _tiny(normalize_obs=True, anneal_lr=True)
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    ts, _ = ppo.make_train_step(cfg, pcfg)(ts)       # moments, count and rms not at init
    checkpoint.save(str(tmp_path / "ck"), ts)
    assert_same(ts, checkpoint.restore(str(tmp_path / "ck"), device="cpu"))


def test_round_trip_with_frames(tmp_path):
    cfg = EnvConfig(num_agents=1, velocity_iters=4, position_iters=2)
    pcfg = ppo.PPOConfig(rollout_len=1, num_envs=2, pool_size=2, minibatches=1, epochs=1,
                         obs_type="pixels", frame_stack=2, squash_actions=True)
    ts = ppo.init_train_state(cfg, pcfg, 1, device="cpu")
    ts = dataclasses.replace(ts, frames=torch.randint(0, 256, ts.frames.shape,
                                                      dtype=torch.uint8))
    checkpoint.save(str(tmp_path / "px"), ts)
    assert_same(ts, checkpoint.restore(str(tmp_path / "px"), device="cpu"))


def test_saves_alternate_slots(tmp_path):
    cfg, pcfg = _tiny()
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    path = str(tmp_path / "ck")
    first = checkpoint.save(path, ts)
    second = checkpoint.save(path, dataclasses.replace(ts, update_i=5))
    third = checkpoint.save(path, dataclasses.replace(ts, update_i=9))
    assert os.path.basename(first) == "ck.slot0" and os.path.basename(second) == "ck.slot1"
    assert third == first
    with open(path + ".latest") as f:
        assert f.read() == "ck.slot0"                 # the basename, not the full path
    assert checkpoint.restore(path, device="cpu").update_i == 9


def test_truncated_newest_slot_restores_the_older(tmp_path):
    cfg, pcfg = _tiny()
    ts = ppo.init_train_state(cfg, pcfg, 0, device="cpu")
    path = str(tmp_path / "ck")
    checkpoint.save(path, dataclasses.replace(ts, update_i=3))     # slot0
    checkpoint.save(path, dataclasses.replace(ts, update_i=4))     # slot1, the pointer
    # A crash while the next save writes slot0: the slot is half written and
    # the pointer has not moved.
    with open(path + ".slot0", "r+b") as f:
        f.truncate(os.path.getsize(path + ".slot0") // 2)
    restored = checkpoint.restore(path, device="cpu")
    assert restored.update_i == 4
    assert_same(dataclasses.replace(ts, update_i=4), restored)
    # The moved checkpoint still resolves: the pointer holds a basename.
    moved = tmp_path / "elsewhere"
    moved.mkdir()
    for suffix in (".slot1", ".latest"):
        os.replace(path + suffix, str(moved / ("ck" + suffix)))
    assert checkpoint.restore(str(moved / "ck"), device="cpu").update_i == 4


def test_restored_state_trains_like_the_unsaved_one(tmp_path):
    cfg, pcfg = _tiny(normalize_obs=True, train_skip_cost=2.0)
    step = ppo.make_train_step(cfg, pcfg)
    ts = ppo.init_train_state(cfg, pcfg, 3, device="cpu")
    ts, _ = step(ts)
    checkpoint.save(str(tmp_path / "ck"), ts)
    other = checkpoint.restore(str(tmp_path / "ck"), device="cpu")
    ts, m = step(ts)
    other, m2 = step(other)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in m2.items()}
    assert_same(ts, other)


def test_learner_entry_points_default_to_cuda(tmp_path):
    """Without a card the learner's entry points raise unless the caller
    passes device="cpu"; nothing falls back to the CPU quietly."""
    from multi_car_racing_tpu_torch.learner import evaluate

    if torch.cuda.is_available():
        pytest.skip("a card is present: the defaults run there")
    cfg, pcfg = _tiny()
    for call in (lambda: ppo.init_train_state(cfg, pcfg, 0),
                 lambda: evaluate.episode_state(cfg, 2, 7),
                 lambda: evaluate.load_policy("multi2p")):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    checkpoint.save(str(tmp_path / "ck"), ppo.init_train_state(cfg, pcfg, 0, device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        checkpoint.restore(str(tmp_path / "ck"))
    assert checkpoint.restore(str(tmp_path / "ck"), device="cpu").update_i == 0
