"""Policy evaluation, port of the JAX package's ``learner/evaluate.py``.

The reference's quality bar is its Gym registration's
``reward_threshold=900``: an agent solves the env when its mean episode
return reaches 900. This module measures that number as the JAX package
does: fresh tracks, one per episode, the deterministic policy (the Gaussian
mean) unless asked to sample, returns summed from the env's own step
rewards and frozen at the step each episode finishes.

The episodes' tracks are generated on the device, as the JAX package's are
(``episode_state``: ``env.device_reset`` from a generator seeded from the
evaluation seed). The generator is a ``torch.Generator``, not JAX's
threefry, so the tracks are the same distribution as JAX's, not the same
stream.

The committed policies (``policies/*.npz``, the four solved checkpoints of
``docs/runs`` exported by ``scripts/export_torch_policies.py``) load by
name through ``load_policy``; ``policies/policies.json`` holds their env
presets, flags and recorded evaluations.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from .. import config as C
from .. import env as penv
from .. import convert
from ..util import resolve_device
from .ppo import (PPOConfig, _observe, _push_frames, _rms_normalize, _stack_obs,
                  clip_env_action, derived_seeds, init_frames, squash_env_action)

POLICY_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "policies")


def episode_state(env_cfg: C.EnvConfig, num_episodes: int, seed: int, device=None):
    """The reset state of ``num_episodes`` evaluation episodes on ``device``
    (default CUDA): ``env.device_reset`` of one fresh track per episode, from
    a generator seeded from ``seed`` (``derived_seeds`` stream 1, apart from
    the training tracks'), as JAX's ``make_eval_fn`` draws them
    (``evaluate.py:49-53``)."""
    dev = resolve_device(device)
    generator = torch.Generator(device=dev).manual_seed(derived_seeds(seed, 1, 1)[0])
    return penv.device_reset(env_cfg, generator, num_episodes)


def make_eval_fn(env_cfg: C.EnvConfig, ppo_cfg: PPOConfig, num_episodes: int,
                 stochastic: bool = False):
    """Returns ``eval(policy, obs_rms, state, generator=None)`` -> dict of
    (E, ...) tensors on the state's device.

    One batched rollout of ``num_episodes`` episodes from the reset
    ``state`` (``episode_state``), ceil(max_episode_steps / R) policy steps
    of R env steps each; finished envs keep stepping but are frozen out of
    the accumulators. Deterministic actions (the policy mean) by default;
    ``stochastic=True`` samples from the policy's Gaussian with
    ``generator``, the policy as it acts in training. Nothing is read back
    to the host inside the rollout."""
    E, N, R = num_episodes, env_cfg.num_agents, ppo_cfg.action_repeat
    max_steps = env_cfg.max_episode_steps
    n_policy_steps = -(-max_steps // R)
    use_rms = ppo_cfg.normalize_obs and ppo_cfg.obs_type == "state"

    @torch.no_grad()
    def eval_fn(policy, obs_rms, state, generator: torch.Generator | None = None):
        if tuple(state.reward.shape) != (E, N):
            raise ValueError(f"eval: a state of shape {tuple(state.reward.shape)} for "
                             f"{E} episodes of {N} cars")
        if stochastic and generator is None:
            raise ValueError("eval: stochastic actions need a generator")
        dev = state.steps.device
        obs_now = _observe(env_cfg, ppo_cfg, state)
        frames = init_frames(ppo_cfg, obs_now)
        ret = torch.zeros((E, N), device=dev)
        fin = torch.zeros((E,), dtype=torch.bool, device=dev)
        tiles = state.tile_visited_count
        length = torch.zeros((E,), dtype=torch.int32, device=dev)
        for i in range(n_policy_steps):
            if i:
                obs_now = _observe(env_cfg, ppo_cfg, state)
            obs = _stack_obs(frames, obs_now)
            frames = _push_frames(frames, obs_now)
            if use_rms:
                obs = _rms_normalize(obs_rms, obs)
            mean, log_std, _ = policy(obs)
            if stochastic:
                mean = mean + torch.exp(log_std) * torch.randn(
                    mean.shape, generator=generator, device=dev)
            a_env = squash_env_action(mean) if ppo_cfg.squash_actions else clip_env_action(mean)
            for _ in range(R):
                live = ~fin
                state, r, done = penv.step(env_cfg, state, a_env)
                ret = ret + r * live.to(r.dtype)[:, None]
                tiles = torch.where(fin[:, None], tiles, state.tile_visited_count)
                length = length + live.int()
                fin = fin | done | (state.steps >= max_steps)
        return dict(returns=ret, tiles=tiles, n_tiles=state.track.n_tiles, length=length)

    return eval_fn


def summarize(out: dict) -> dict:
    """Host-side summary of an eval result (tensors or arrays; scalars out,
    json-friendly)."""
    def host(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

    ret = host(out["returns"]).astype(np.float32)                       # (E, N)
    tiles = host(out["tiles"]).astype(np.float64)
    ntile = host(out["n_tiles"]).astype(np.float64)[:, None]
    per_ep = ret.mean(-1)
    return dict(
        eval_return=float(per_ep.mean()),
        eval_return_std=float(per_ep.std()),
        eval_return_min=float(per_ep.min()),
        eval_return_max=float(per_ep.max()),
        eval_best_agent_return=float(ret.max(-1).mean()),
        eval_tiles_frac=float((tiles / ntile).mean()),
        eval_len=float(host(out["length"]).mean()),
        eval_episodes=int(ret.shape[0]),
    )


def policy_specs() -> dict:
    """``policies/policies.json``: per committed policy its slot, env preset
    (``env``), learner flags (``ppo``) and recorded evaluation (``record``)."""
    with open(os.path.join(POLICY_DIR, "policies.json")) as f:
        return json.load(f)


def read_policy_file(path: str):
    """(flax variables dict, obs_rms dict or None) as numpy arrays from a
    policy ``.npz`` whose keys are the checkpoint tree's paths: the
    TrainState's ``params`` (flax's variables dict,
    "params/params/Dense_0/kernel", ...) and ``obs_rms`` ("obs_rms/mean")."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree["params"], tree.get("obs_rms")


def load_policy(name: str, device=None):
    """A committed policy by name: (ActorCritic on ``device``, obs_rms or
    None, EnvConfig, the ``ppo`` flags dict, its spec from policies.json)."""
    spec = policy_specs()[name]
    flags = spec["ppo"]
    params, obs_rms = read_policy_file(os.path.join(POLICY_DIR, f"{name}.npz"))
    net, rms = convert.policy_from_numpy(
        params, obs_rms if flags["normalize_obs"] else None, obs_type=flags["obs_type"],
        width=flags["width"], frame_stack=flags["frame_stack"], device=device)
    return net, rms, C.EnvConfig(**spec["env"]), flags, spec


def main(argv=None):
    """Standalone: evaluate a policy file, a port checkpoint or a committed policy.

        python -m multi_car_racing_tpu_torch.learner.evaluate \\
            --policy pixels_solved --episodes 100 --seed 7
        python -m multi_car_racing_tpu_torch.learner.evaluate \\
            --checkpoint policy.npz --episodes 20 --carracing-v0 --normalize-obs --width 512
    """
    import argparse

    ap = argparse.ArgumentParser()
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--checkpoint",
                     help="a policy file (.npz, flax paths; the flags below describe it) "
                          "or a port checkpoint (checkpoint.save's path; its learner "
                          "flags are the checkpoint's own)")
    src.add_argument("--policy", help="a committed policy by name (policies/policies.json "
                                      "supplies its env preset and flags)")
    ap.add_argument("--episodes", type=int, default=20)
    ap.add_argument("--num-agents", type=int, default=2)
    ap.add_argument("--obs", choices=["state", "pixels"], default="state")
    ap.add_argument("--action-repeat", type=int, default=1)
    ap.add_argument("--width", type=int, default=256,
                    help="state-torso width (must match the policy)")
    ap.add_argument("--normalize-obs", action="store_true")
    ap.add_argument("--carracing-v0", action="store_true",
                    help="1 agent, fixed CCW direction, no backwards flag")
    ap.add_argument("--stochastic", action="store_true",
                    help="sample actions from the policy's Gaussian instead of the mean")
    ap.add_argument("--squash-actions", action="store_true",
                    help="the policy was trained with the tanh-squashed action head")
    ap.add_argument("--frame-stack", type=int, default=1,
                    help="pixel frame stacking K (must match the policy)")
    ap.add_argument("--seed", type=int, default=1234)
    ap.add_argument("--device", default=None, help="default: CUDA")
    args = ap.parse_args(argv)

    from .. import checkpoint

    if args.policy:
        net, obs_rms, env_cfg, flags, _ = load_policy(args.policy, args.device)
        ppo_cfg = PPOConfig(num_envs=args.episodes, **flags)
    else:
        if args.carracing_v0:
            env_cfg = C.EnvConfig(num_agents=1, use_random_direction=False,
                                  backwards_flag=False)
        else:
            env_cfg = C.EnvConfig(num_agents=args.num_agents)
        ppo_cfg = PPOConfig(
            num_envs=args.episodes, obs_type=args.obs, action_repeat=args.action_repeat,
            normalize_obs=args.normalize_obs, width=args.width,
            squash_actions=args.squash_actions, frame_stack=args.frame_stack)
        if args.checkpoint.endswith(".npz"):
            params, rms = read_policy_file(args.checkpoint)
            net, obs_rms = convert.policy_from_numpy(
                params, rms if args.normalize_obs else None, obs_type=args.obs,
                width=args.width, frame_stack=args.frame_stack, device=args.device)
        else:
            ts = checkpoint.restore(args.checkpoint, device=args.device)
            net, obs_rms = ts.net, ts.obs_rms
            ppo_cfg = dataclasses.replace(ts.ppo_cfg, num_envs=args.episodes)
    state = episode_state(env_cfg, args.episodes, args.seed, device=args.device)
    generator = None
    if args.stochastic:
        generator = torch.Generator(device=state.steps.device).manual_seed(args.seed)
    out = make_eval_fn(env_cfg, ppo_cfg, args.episodes, stochastic=args.stochastic)(
        net, obs_rms, state, generator)
    print(json.dumps(summarize(out)))


if __name__ == "__main__":
    main()
