"""The committed policy files of the port (learner/policies/*.npz, written by
scripts/export_torch_policies.py) against the orbax checkpoints they were
exported from (docs/runs/*_ckpt), on the CPU.

- Each file's leaves are byte-equal to the slot's ``params`` and
  ``obs_rms`` leaves, leaf for leaf, with no leaf missing or extra.
- policies.json's flags agree with the tree's shapes: the state torso's
  width is its Dense_0 kernel's column count, K is Conv_0's input channels
  over 3, ``obs_rms`` is present exactly when ``normalize_obs`` is set.
- The port's network on each file matches JAX's on the orbax params, on
  observations of envs the port reset and stepped (state features
  normalised by the policy's own statistics; pixel frames stacked oldest
  first), under tests/test_torch_networks.py's bars: 1e-5 * max(1, |x|) for
  the state nets, 1e-2 * max(1, max|JAX|) on mean and value for the pixel
  nets.
"""

import os

import jax
import numpy as np
import orbax.checkpoint as ocp
import pytest
import torch

from multi_car_racing_tpu.learner.networks import ActorCritic as JaxActorCritic

from multi_car_racing_tpu_torch import EnvConfig, env as penv
from multi_car_racing_tpu_torch.learner import evaluate, ppo
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPECS = evaluate.policy_specs()
NAMES = sorted(SPECS)
STATE_TOL = 1e-5
PIXEL_TOL = 1e-2


@pytest.fixture(scope="module")
def slots():
    return {name: ocp.PyTreeCheckpointer().restore(os.path.join(ROOT, SPECS[name]["slot"]))
            for name in NAMES}


def _leaves(tree, prefix):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
        return out
    return {prefix: np.asarray(tree)}


def test_the_four_committed_policies_are_listed():
    assert NAMES == ["carracing_v0_solved", "multi2p", "multi2px", "pixels_solved"]


@pytest.mark.parametrize("name", NAMES)
def test_policy_file_is_byte_equal_to_the_slot(slots, name):
    tree = slots[name]
    want = _leaves(tree["params"], "params")
    if tree.get("obs_rms") is not None:
        want.update(_leaves(tree["obs_rms"], "obs_rms"))
    with np.load(os.path.join(evaluate.POLICY_DIR, f"{name}.npz")) as data:
        got = {k: data[k] for k in data.files}
    assert sorted(got) == sorted(want)
    for k, a in want.items():
        assert got[k].dtype == a.dtype == np.float32, k
        assert got[k].shape == a.shape and got[k].tobytes() == a.tobytes(), k


@pytest.mark.parametrize("name", NAMES)
def test_flags_agree_with_the_tree(slots, name):
    flags, tree = SPECS[name]["ppo"], slots[name]
    params = tree["params"]["params"]
    if flags["obs_type"] == "state":
        assert params["StateTorso_0"]["Dense_0"]["kernel"].shape[1] == flags["width"]
        assert flags["frame_stack"] == 1
    else:
        assert "StateTorso_0" not in params
        assert params["PixelTorso_0"]["Conv_0"]["kernel"].shape[2] == 3 * flags["frame_stack"]
    assert (tree.get("obs_rms") is not None) == flags["normalize_obs"]
    record = SPECS[name]["record"]
    assert record["episodes"] == 100 and record["std"] > 0 and record["source"]


def _observations(name):
    """Observations (E * N, ...) the policy would see, from envs the port
    reset (seeds 0-1) and stepped twice with fixed actions."""
    spec, flags = SPECS[name], SPECS[name]["ppo"]
    cfg = EnvConfig(**spec["env"], velocity_iters=30, position_iters=12)
    pcfg = ppo.PPOConfig(**flags)
    st = penv.reset_batch(cfg, (0, 1), 2, device="cpu")
    obs0 = ppo._observe(cfg, pcfg, st)
    frames = ppo.init_frames(pcfg, obs0)
    seen = []
    action = torch.tensor([0.1, 0.6, 0.0]).expand(2, cfg.num_agents, 3)
    for t in range(2):
        obs_now = obs0 if t == 0 else ppo._observe(cfg, pcfg, st)
        seen.append(ppo._stack_obs(frames, obs_now))
        frames = ppo._push_frames(frames, obs_now)
        st, _, _ = penv.step(cfg, st, action)
    obs = torch.cat(seen)
    return obs.reshape((-1,) + tuple(obs.shape[2:])).numpy()


@pytest.mark.parametrize("name", NAMES)
def test_port_net_on_the_file_matches_jax_on_the_slot(slots, name):
    flags = SPECS[name]["ppo"]
    net, rms, _, _, _ = evaluate.load_policy(name, device="cpu")
    x = _observations(name)
    tree = slots[name]
    if flags["normalize_obs"]:
        r = {k: np.asarray(v) for k, v in tree["obs_rms"].items()}
        x = np.clip((x - r["mean"]) / np.sqrt(r["var"] + 1e-8), -10, 10).astype(np.float32)
        assert torch.equal(ppo._rms_normalize(rms, torch.from_numpy(
            _observations(name))), torch.from_numpy(x))
    jnet = JaxActorCritic(obs_type=flags["obs_type"], width=flags["width"])
    want = [np.asarray(t) for t in jax.jit(jnet.apply)(tree["params"], x)]
    with torch.no_grad():
        got = [t.numpy() for t in net(torch.from_numpy(x))]
    tol = STATE_TOL if flags["obs_type"] == "state" else PIXEL_TOL
    for label, w, g in zip(("mean", "log_std", "value"), want, got):
        assert g.shape == w.shape, label
        err = float(np.abs(g - w).max())
        assert err <= tol * max(1.0, float(np.abs(w).max())), (label, err)
