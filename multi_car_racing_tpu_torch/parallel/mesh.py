"""Data parallelism over processes, port of the JAX package's ``parallel/mesh.py``.

The JAX package shards the env batch over a 1-D 'data' mesh and replicates
the learner's parameters; GSPMD then partitions the one-device train step,
so a run on W devices computes what one device computes on the same global
batch. The port gets the same result with ``torch.distributed``: each
process (a rank) holds a contiguous range of the env rows (``rows``; ragged
ranges allowed, as GSPMD takes ragged batches), every rank draws the same
global random numbers from the same generator state and keeps its rows, and
the learner joins the sums, maxima and gradients of the global minibatch
with a few collectives (``World.sum``, ``World.max``, ``World.mean``). The
kernels need nothing: each rank launches them on its own rows, as JAX
``shard_map``s its Pallas calls over each shard.

The collectives are ``all_reduce``, ``all_gather`` and ``broadcast``, which
both backends take on CUDA tensors. ``init`` derives the backend: NCCL when
every rank holds a card of its own, gloo on the CPU and when ranks share a
card (NCCL refuses two ranks on one device).

``World()`` is one process without a process group: every helper is then
the identity, and the one-process learner runs exactly the ops it runs
without this module.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
import socket
import subprocess
import tempfile
import time
import zlib
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from ..util import resolve_device

# torchrun's variables, read by ``init_method="env://"``.
ENV_VARS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def row_range(num_envs: int, size: int, rank: int) -> tuple[int, int]:
    """Rank ``rank``'s contiguous env rows [lo, hi) of ``num_envs`` over
    ``size`` ranks: the first ``num_envs % size`` ranks take one row more."""
    if num_envs < size:
        raise ValueError(f"{num_envs} envs cannot give each of {size} ranks a row")
    base, extra = divmod(num_envs, size)
    lo = rank * base + min(rank, extra)
    return lo, lo + base + (rank < extra)


@dataclasses.dataclass(frozen=True)
class World:
    """The ranks of one run and this process's place among them.

    ``group`` is the process group the collectives run on (None: one
    process, no collectives); ``device`` is where this rank's tensors live
    (the collectives' scratch tensors go there too)."""
    rank: int = 0
    size: int = 1
    group: Any = None
    backend: str | None = None
    device: torch.device | None = None

    @property
    def distributed(self) -> bool:
        return self.group is not None

    def rows(self, num_envs: int) -> tuple[int, int]:
        return row_range(num_envs, self.size, self.rank)

    def _reduce(self, x: torch.Tensor, op) -> torch.Tensor:
        if not self.distributed:
            return x
        y = x.detach().reshape(-1).clone()
        dist.all_reduce(y, op=op, group=self.group)
        return y.reshape(x.shape)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the ranks (elementwise; a new tensor)."""
        return self._reduce(x, dist.ReduceOp.SUM)

    def max(self, x: torch.Tensor) -> torch.Tensor:
        return self._reduce(x, dist.ReduceOp.MAX)

    def mean(self, x: torch.Tensor, num_envs: int, dim: int = 0) -> torch.Tensor:
        """The mean over all ranks of ``x``, whose axis ``dim`` is this rank's
        env rows of ``num_envs``: each rank's mean weighted by its share of
        the rows (a weight of exactly 1 in a world of one)."""
        if not self.distributed:
            return x.mean()
        return self.sum(x.mean() * (x.shape[dim] / num_envs))

    def broadcast(self, x: torch.Tensor) -> torch.Tensor:
        """Rank 0's ``x`` on every rank (a new tensor)."""
        if not self.distributed:
            return x
        y = x.detach().reshape(-1).clone()
        dist.broadcast(y, src=0, group=self.group)
        return y.reshape(x.shape)

    def gather_rows(self, x: torch.Tensor, num_envs: int) -> torch.Tensor:
        """Every rank's rows of ``x`` (leading axis: this rank's env rows of
        ``num_envs``) joined in rank order, on every rank. Ragged ranges are
        padded to the longest for the gather; any dtype travels as bytes."""
        if not self.distributed:
            return x
        counts = [row_range(num_envs, self.size, r) for r in range(self.size)]
        longest = max(hi - lo for lo, hi in counts)
        raw = x.contiguous().reshape(x.shape[0], -1).view(torch.uint8)
        pad = raw.new_zeros((longest, raw.shape[1]))
        pad[:raw.shape[0]] = raw
        parts = [torch.empty_like(pad) for _ in range(self.size)]
        dist.all_gather(parts, pad, group=self.group)
        joined = torch.cat([p[:hi - lo] for p, (lo, hi) in zip(parts, counts)])
        return joined.view(x.dtype).reshape((num_envs,) + tuple(x.shape[1:]))

    def barrier(self) -> None:
        """Wait until every rank arrives (an all-reduce of one number)."""
        if self.distributed:
            self.sum(torch.zeros(1, device=self.device))

    def check_replicated(self, tensors, what: str) -> str:
        """Raise unless ``tensors`` hold the same bytes on every rank; returns
        this rank's hash (hex) of them."""
        h = tensor_hash(tensors)
        if self.distributed:
            mine = torch.tensor([int(h[:15], 16)], dtype=torch.int64, device=self.device)
            if not (torch.equal(self.max(mine), mine) and torch.equal(-self.max(-mine), mine)):
                raise RuntimeError(f"{what} differs between the ranks (rank {self.rank}: "
                                   f"{h[:16]})")
        return h


def tensor_hash(tensors) -> str:
    """SHA-256 of the tensors' bytes, in order (read on the host)."""
    d = hashlib.sha256()
    for t in tensors:
        d.update(np.ascontiguousarray(t.detach().cpu().numpy()).tobytes())
    return d.hexdigest()


def rank_device(device, local_rank: int) -> torch.device:
    """The rank's device: ``device`` when it names one (default CUDA), else
    card ``local_rank`` modulo the cards present (so ranks beyond the card
    count share)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
    return dev


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, device=None) -> tuple[World, torch.device]:
    """Join the run's process group; returns (World, this rank's device).

    With ``coordinator`` ("host:port"), rank ``process_id`` of
    ``num_processes`` rendezvouses at ``tcp://host:port`` (rank 0 listens
    there). Without it, ``env://`` reads torchrun's variables (``ENV_VARS``,
    and ``LOCAL_RANK`` for the card). The rendezvous group is gloo; the
    ranks then exchange (host, card) and, when no two share a card, build
    an NCCL group for the collectives."""
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator address needs the process count and this "
                             "process's id")
        if not 0 <= process_id < num_processes:
            raise ValueError(f"process id {process_id} is not in [0, {num_processes})")
        init_method, size, rank = f"tcp://{coordinator}", num_processes, process_id
        local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    else:
        missing = [v for v in ENV_VARS if v not in os.environ]
        if missing:
            raise ValueError("without a coordinator address the process group reads "
                             f"torchrun's variables, and {', '.join(missing)} "
                             f"{'is' if len(missing) == 1 else 'are'} not set")
        init_method = "env://"
        size, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("gloo", init_method=init_method, world_size=size, rank=rank)
    place = torch.tensor([zlib.crc32(socket.gethostname().encode()),
                          dev.index if dev.type == "cuda" else -1], dtype=torch.int64)
    places = [torch.empty_like(place) for _ in range(size)]
    dist.all_gather(places, place)
    places = {tuple(p.tolist()) for p in places}
    own_cards = dev.type == "cuda" and len(places) == size and all(i >= 0 for _, i in places)
    if own_cards:
        return World(rank, size, dist.new_group(backend="nccl"), "nccl", dev), dev
    return World(rank, size, dist.group.WORLD, "gloo", dev), dev


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago (for a coordinator)."""
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    return port


def run_processes(cmds: list, envs: list | None = None, cwd: str | None = None,
                  timeout: float = 600.0, logs: list | None = None
                  ) -> tuple[list, list, float]:
    """Start the commands at once (the ranks of one run on this host) and
    wait for all of them; every one still running ``timeout`` seconds after
    the start is killed. Each command's stdout and stderr go to its path in
    ``logs``, or to a temporary file that is read back. Returns (return
    codes, outputs, wall seconds); a killed process's code is negative."""
    t0 = time.perf_counter()
    files = ([open(log, "w+") for log in logs] if logs is not None
             else [tempfile.TemporaryFile("w+") for _ in cmds])
    procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT, text=True,
                              env=None if envs is None else envs[i], cwd=cwd)
             for i, (cmd, f) in enumerate(zip(cmds, files))]
    try:
        for p in procs:
            p.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in files:
        f.seek(0)
        outs.append(f.read())
        f.close()
    return [p.returncode for p in procs], outs, time.perf_counter() - t0


def shutdown() -> None:
    """Leave the process group (if this process joined one)."""
    if dist.is_initialized():
        dist.destroy_process_group()
