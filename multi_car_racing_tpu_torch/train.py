"""The PPO training command line, port of the JAX package's ``train.py``.

    python -m multi_car_racing_tpu_torch.train --updates 50 --num-envs 256
    python -m multi_car_racing_tpu_torch.train --obs state --log /tmp/ppo.jsonl
    python -m multi_car_racing_tpu_torch.train --carracing-v0 --device cpu --updates 2 \\
        --num-envs 4 --rollout 8

The JAX flags with the JAX defaults, plus ``--device`` (default CUDA;
``cpu`` runs the plain PyTorch versions of the kernels). Training goes
through ``learner.ppo`` (``init_train_state``, ``make_train_step``);
``--checkpoint`` / ``--ckpt-every`` / ``--resume`` through ``checkpoint``
(``<checkpoint>_best`` after an evaluation that beats ``--best-so-far``);
``--eval-every`` through ``learner.evaluate`` (``episode_state`` +
``make_eval_fn``). Each evaluation generates fresh tracks on the device
from its own seed, ``eval_seed(seed, update)``, so a resumed run evaluates
on the tracks the uninterrupted run would have (JAX splits an eval key on
the device: the same distribution of tracks, not the same stream). The console
lines and the JSONL rows (``metrics.JsonlLogger``) carry the JAX keys, so
``scripts/curve.py`` reads the log unchanged.

``--distributed`` trains on several processes (``parallel.mesh``), one
per card or several sharing one, computing what one process computes on
the same global batch, as JAX's mesh does. With ``--coordinator host:port``
(which needs ``--num-processes`` and ``--process-id``, as in JAX) the
ranks meet at ``tcp://host:port``; without it the process group reads
torchrun's variables (the ``--`` keeps torchrun from reading ``--log`` as
an abbreviation of its own ``--log-dir``)::

    torchrun --nproc-per-node 4 -m multi_car_racing_tpu_torch.train -- --distributed
    python -m multi_car_racing_tpu_torch.train --distributed --device cpu \\
        --coordinator 127.0.0.1:29500 --num-processes 2 --process-id 0   # and 1

Without ``--distributed`` those three flags are ignored, as in JAX. Each
rank prints its console lines (the device line names the rank and its env
rows); rank 0 alone writes ``--log`` and ``--profile``; every rank runs the
evaluation whole, from the same seed; ``save`` is collective.
``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the training
loop to DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from . import checkpoint, metrics
from . import config as C
from .learner import evaluate as ev
from .learner import ppo
from .parallel import mesh
from .util import resolve_device

EVAL_SEED_OFFSET = 1_000_003      # the JAX eval key's seed offset


def eval_seed(seed: int, update: int) -> int:
    """The evaluation seed after ``update`` updates of a run of ``seed``."""
    return seed + EVAL_SEED_OFFSET + update


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m multi_car_racing_tpu_torch.train")
    ap.add_argument("--updates", type=int, default=20)
    ap.add_argument("--num-envs", type=int, default=256)
    ap.add_argument("--rollout", type=int, default=64)
    ap.add_argument("--pool-size", type=int, default=32,
                    help="autoreset track-pool size")
    ap.add_argument("--num-agents", type=int, default=2)
    ap.add_argument("--carracing-v0", action="store_true",
                    help="reference CarRacing-v0 preset: 1 agent, fixed CCW "
                         "direction, no backwards flag (README.md:66-71)")
    ap.add_argument("--eval-every", type=int, default=0,
                    help="run a deterministic fresh-track eval every N updates")
    ap.add_argument("--eval-episodes", type=int, default=20)
    ap.add_argument("--obs", choices=["state", "pixels"], default="state")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--gamma", type=float, default=0.99)
    ap.add_argument("--ent-coef", type=float, default=0.0)
    ap.add_argument("--action-repeat", type=int, default=1,
                    help="hold each policy action this many env steps")
    ap.add_argument("--normalize-obs", action="store_true",
                    help="running mean/var normalization of state obs")
    ap.add_argument("--width", type=int, default=256,
                    help="state-torso MLP width")
    ap.add_argument("--train-step-cost", type=float, default=0.0,
                    help="extra per-step time cost added ONLY to the "
                         "learner's reward signal (pace shaping; eval uses "
                         "the real env return)")
    ap.add_argument("--train-grass-cost", type=float, default=0.0,
                    help="training-only per-step cost while on grass "
                         "(anti-corner-cutting; eval uses the real return)")
    ap.add_argument("--train-skip-cost", type=float, default=0.0,
                    help="training-only potential-based penalty per skipped "
                         "tile (passed without visiting; eval uses the real "
                         "return)")
    ap.add_argument("--anneal-lr", action="store_true",
                    help="linear lr decay to 0 over --updates")
    ap.add_argument("--kl-target", type=float, default=0.0,
                    help="approx-KL early stop for the minibatch loop "
                         "(0 disables)")
    ap.add_argument("--squash-actions", action="store_true",
                    help="tanh-squashed action head (exact log-det) "
                         "instead of clipping the raw Gaussian")
    ap.add_argument("--frame-stack", type=int, default=1,
                    help="stack the last K pixel frames channel-wise "
                         "(velocity in the observation; pixels only)")
    ap.add_argument("--step-cost-start", type=int, default=0,
                    help="update at which --train-step-cost starts ramping "
                         "in (pace curriculum; 0 = active from scratch)")
    ap.add_argument("--step-cost-ramp", type=int, default=1,
                    help="updates over which the step cost ramps to full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log", default=None, help="JSONL metrics path")
    ap.add_argument("--checkpoint", default=None, help="save path (every --ckpt-every)")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--resume", default=None)
    ap.add_argument("--best-so-far", type=float, default=None,
                    help="floor for the best-eval checkpoint: on --resume, "
                         "<checkpoint>_best is only overwritten once an eval "
                         "beats this (otherwise a resumed run's first eval "
                         "clobbers a better earlier snapshot)")
    ap.add_argument("--profile", default=None, help="torch.profiler trace dir")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process data parallelism (torch.distributed)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator host:port (else torchrun's variables)")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--fast-solver", action="store_true",
                    help="velocity/position iterations 30/12 instead of 180/60")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    return ap


# The fields of PPOConfig that shape the TrainState a --resume restores.
_SHAPE_FIELDS = ("rollout_len", "num_envs", "pool_size", "obs_type", "normalize_obs",
                 "width", "frame_stack")


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.distributed and args.coordinator is not None and (
            args.num_processes is None or args.process_id is None):
        ap.error("--coordinator requires --num-processes and --process-id (they cannot be "
                 "auto-detected from an address alone)")
    if args.action_repeat < 1:
        ap.error("--action-repeat must be >= 1")
    if args.normalize_obs and args.obs == "pixels":
        ap.error("--normalize-obs only applies to --obs state "
                 "(pixel frames are uint8-scaled inside the network)")

    if args.distributed:
        try:
            world, dev = mesh.init(args.coordinator, args.num_processes, args.process_id,
                                   args.device)
        except ValueError as e:
            ap.error(f"--distributed: {e}")
    else:
        world, dev = mesh.World(), resolve_device(args.device)
    try:
        return _train(args, ap, world, dev)
    finally:
        if args.distributed:
            mesh.shutdown()


def _train(args, ap, world: mesh.World, dev: torch.device):
    env_kw = {}
    if args.fast_solver:
        env_kw = dict(velocity_iters=30, position_iters=12)
    if args.carracing_v0:
        args.num_agents = 1
        env_kw.update(use_random_direction=False, backwards_flag=False)
    env_cfg = C.EnvConfig(num_agents=args.num_agents, **env_kw)
    ppo_cfg = ppo.PPOConfig(
        rollout_len=args.rollout, num_envs=args.num_envs, lr=args.lr,
        obs_type=args.obs, pool_size=args.pool_size,
        gamma=args.gamma, ent_coef=args.ent_coef,
        action_repeat=args.action_repeat, normalize_obs=args.normalize_obs,
        anneal_lr=args.anneal_lr, total_updates=args.updates,
        kl_target=args.kl_target,
        squash_actions=args.squash_actions,
        frame_stack=args.frame_stack,
        width=args.width, train_step_cost=args.train_step_cost,
        train_grass_cost=args.train_grass_cost,
        train_skip_cost=args.train_skip_cost,
        train_step_cost_start=args.step_cost_start,
        train_step_cost_ramp=args.step_cost_ramp,
    )

    name = f"{dev} ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else str(dev)
    if world.distributed:
        lo, hi = world.rows(args.num_envs)
        print(f"device: {name}, process {world.rank} of {world.size} ({world.backend}), "
              f"env rows {lo}:{hi} of {args.num_envs}")
    else:
        print(f"device: {name}, one process")
    if args.resume:
        # The JAX trainer restores the arrays into a template built from the
        # flags; here the archive holds its own configs, which must match the
        # flags that shape the state. The flags' configs then drive the run.
        ts = checkpoint.restore(args.resume, device=dev, world=world)
        bad = [f for f in _SHAPE_FIELDS if getattr(ts.ppo_cfg, f) != getattr(ppo_cfg, f)]
        if ts.env_cfg != env_cfg or bad:
            ap.error(f"--resume {args.resume}: the checkpoint's env config or learner "
                     f"fields {bad} differ from the flags' ({ts.env_cfg} vs {env_cfg})")
        opt = ppo.ClippedAdam(ts.net.parameters(), ppo_cfg)
        opt.load_state_dict(ts.opt.state_dict())
        ts = dataclasses.replace(ts, opt=opt, env_cfg=env_cfg, ppo_cfg=ppo_cfg)
        print(f"resumed from {args.resume} at update {int(ts.update_i)}")
    else:
        ts = ppo.init_train_state(env_cfg, ppo_cfg, args.seed, device=dev, world=world)
    train_step = ppo.make_train_step(env_cfg, ppo_cfg, world)
    eval_fn = None
    if args.eval_every:
        eval_fn = ev.make_eval_fn(env_cfg, ppo_cfg, args.eval_episodes)
        best_eval = -float("inf") if args.best_so_far is None else args.best_so_far

    lead = world.rank == 0
    logger = metrics.JsonlLogger(args.log if lead else None)
    steps_per_update = args.rollout * args.action_repeat * args.num_envs * args.num_agents
    with metrics.profile_trace(args.profile if lead else None):
        for i in range(args.updates):
            t0 = time.time()
            ts, m = train_step(ts)
            m = {k: float(v) for k, v in m.items()}
            env_m = {k: float(v) for k, v in metrics.env_metrics(
                ts.env_state, world, args.num_envs).items()}
            row = logger.log(
                int(ts.update_i) * steps_per_update, {**m, **env_m},
                update=int(ts.update_i), update_s=round(time.time() - t0, 3),
            )
            print(
                f"update {row['update']:4d} "
                f"loss {m['loss']:+.4f} v {m['v_loss']:.4f} "
                f"r/step {m['mean_step_reward']:+.3f} "
                f"ret {m['ep_return']:+.1f} (max {m['ep_return_max']:+.1f}, "
                f"n={m['episodes_finished']:.0f}) "
                f"tiles {env_m['mean_tiles_visited']:.1f} "
                f"{row.get('env_steps_per_sec', 0):,.0f} steps/s"
            )
            if args.checkpoint and (i + 1) % args.ckpt_every == 0:
                checkpoint.save(args.checkpoint, ts, world)
                print(f"checkpointed -> {args.checkpoint}")
            if eval_fn is not None and (i + 1) % args.eval_every == 0:
                state = ev.episode_state(env_cfg, args.eval_episodes,
                                         eval_seed(args.seed, int(ts.update_i)), device=dev)
                summary = ev.summarize(eval_fn(ts.net, ts.obs_rms, state))
                logger.log(int(ts.update_i) * steps_per_update, summary,
                           update=int(ts.update_i))
                print(
                    f"  eval: return {summary['eval_return']:+.1f} "
                    f"± {summary['eval_return_std']:.1f} "
                    f"(min {summary['eval_return_min']:+.1f}, "
                    f"max {summary['eval_return_max']:+.1f}) "
                    f"tiles {100 * summary['eval_tiles_frac']:.1f}% "
                    f"len {summary['eval_len']:.0f} "
                    f"over {summary['eval_episodes']} episodes"
                )
                # Every rank evaluated the same episodes; rank 0's return
                # decides, so every rank makes the same (collective) save.
                ret = float(world.broadcast(torch.tensor(summary["eval_return"], dtype=torch.float64,
                                                          device=dev)))
                if args.checkpoint and ret > best_eval:
                    best_eval = ret
                    checkpoint.save(args.checkpoint + "_best", ts, world)
                    print(f"  new best ({best_eval:+.1f}) -> {args.checkpoint}_best")

    if args.checkpoint:
        checkpoint.save(args.checkpoint, ts, world)
        print(f"final checkpoint -> {args.checkpoint}")
    return ts


if __name__ == "__main__":
    main()
