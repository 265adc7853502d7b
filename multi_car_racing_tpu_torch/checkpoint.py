"""Checkpoint / resume of the learner, port of the JAX package's ``checkpoint.py``.

A checkpoint holds the whole ``learner.ppo.TrainState``: the network's and
the optimizer's state, the mid-episode env batch and the track pool (as
trees of tensors), the generator's state, ``update_i``, ``obs_rms``, the
frame-stacking buffer and both configs, so a restored learner trains on as
the saved one would have.

Crash-safe two-slot scheme: ``save`` writes ``<path>.slot0`` or
``<path>.slot1`` (the one the pointer does not name), each a ``torch.save``
archive, then atomically replaces the pointer ``<path>.latest``, which holds
the slot's basename (so a checkpoint can be moved and still resolve). A
crash during a save can only corrupt the slot being written; the pointer
still names the previous complete one.

Multi-process runs (``world``, a ``parallel.mesh.World``), as JAX's: ``save``
all-gathers the env rows (and the frame buffer) of every rank, rank 0 alone
writes the archive the one-process ``save`` writes and moves the pointer,
and a barrier follows, so no rank runs ahead while the write is under way.
Everything else of the state is the same on every rank. ``restore`` reads
the global archive on every rank, and each keeps its rows. So a checkpoint
saved by W ranks resumes in one process, and the reverse.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from . import convert
from .config import EnvConfig
from .learner.networks import ActorCritic
from .learner.ppo import ClippedAdam, PPOConfig, TrainState
from .parallel.mesh import World
from .util import resolve_device, tree_map


def _slots(path: str):
    return path + ".slot0", path + ".slot1", path + ".latest"


def _tensors(tree):
    """A nested dict of numpy arrays as CPU tensors."""
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    return torch.from_numpy(np.ascontiguousarray(tree))


def _arrays(tree):
    if isinstance(tree, dict):
        return {k: _arrays(v) for k, v in tree.items()}
    return tree.numpy()


def _cpu(x):
    return None if x is None else x.detach().cpu()


def save(path: str, ts: TrainState, world: World = World()) -> str | None:
    """Save ``ts`` under ``path`` (crash-safe, two slots); returns the slot
    written (None on ranks other than 0). Collective over ``world``'s ranks."""
    path = os.path.abspath(path)
    env_state, frames = ts.env_state, ts.frames
    if world.distributed:
        E = ts.ppo_cfg.num_envs
        env_state = tree_map(lambda x: world.gather_rows(x, E), env_state)
        frames = None if frames is None else world.gather_rows(frames, E)
        if world.rank != 0:
            world.barrier()
            return None
    os.makedirs(os.path.dirname(path), exist_ok=True)
    s0, s1, ptr = _slots(path)
    cur = None
    if os.path.exists(ptr):
        with open(ptr) as f:
            cur = f.read().strip()
    nxt = s1 if cur == os.path.basename(s0) else s0
    net = ts.net
    payload = {
        "net_config": {"obs_type": net.obs_type, "width": net.width,
                       "frame_stack": net.frame_stack},
        "net": {k: _cpu(v) for k, v in net.state_dict().items()},
        "opt": {k: ([_cpu(t) for t in v] if isinstance(v, list) else _cpu(v))
                for k, v in ts.opt.state_dict().items()},
        "env_state": _tensors(convert.env_state_to_numpy(env_state)),
        "pool": _tensors(convert.track_to_numpy(ts.pool)),
        "generator": ts.generator.get_state(),
        "update_i": int(ts.update_i),
        "obs_rms": None if ts.obs_rms is None else {k: _cpu(v) for k, v in ts.obs_rms.items()},
        "frames": _cpu(frames),
        "env_cfg": dataclasses.asdict(ts.env_cfg),
        "ppo_cfg": dataclasses.asdict(ts.ppo_cfg),
    }
    torch.save(payload, nxt)
    tmp = ptr + ".tmp"
    with open(tmp, "w") as f:
        f.write(os.path.basename(nxt))
    os.replace(tmp, ptr)
    world.barrier()
    return nxt


def restore(path: str, device=None, world: World = World()) -> TrainState:
    """The ``TrainState`` saved under ``path`` (the slot its pointer names, or
    ``path`` itself when there is no pointer), on ``device`` (default CUDA);
    on a rank of ``world``, with its rows of the env batch. No template: the
    archive holds the configs that shape the network."""
    dev = resolve_device(device)
    path = os.path.abspath(path)
    ptr = _slots(path)[2]
    if os.path.exists(ptr):
        with open(ptr) as f:
            slot = f.read().strip()
        path = slot if os.path.isabs(slot) else os.path.join(os.path.dirname(path), slot)
    ck = torch.load(path, map_location="cpu", weights_only=True)
    env_cfg, ppo_cfg = EnvConfig(**ck["env_cfg"]), PPOConfig(**ck["ppo_cfg"])
    net = ActorCritic(**ck["net_config"])
    net.load_state_dict(ck["net"])
    net.to(dev)
    opt = ClippedAdam(net.parameters(), ppo_cfg)
    opt.load_state_dict(ck["opt"])
    generator = torch.Generator(device=dev)
    generator.set_state(ck["generator"])

    lo, hi = world.rows(ppo_cfg.num_envs)

    def to_dev(x):
        return None if x is None else x.to(dev)

    def rows(x):
        return x if not world.distributed or x is None else x[lo:hi].clone()

    return TrainState(
        net=net, opt=opt,
        env_state=tree_map(rows, convert.env_state_from_numpy(_arrays(ck["env_state"]),
                                                              device=dev)),
        pool=convert.track_from_numpy(_arrays(ck["pool"]), device=dev),
        generator=generator, update_i=ck["update_i"], env_cfg=env_cfg, ppo_cfg=ppo_cfg,
        obs_rms=None if ck["obs_rms"] is None else {k: to_dev(v) for k, v in
                                                     ck["obs_rms"].items()},
        frames=rows(to_dev(ck["frames"])),
    )
