"""Metrics, logging and profiling.

Port of the JAX package's ``metrics.py``. The reference's observability is
two print statements (track size at reset, mcr:276-277; demo returns every
200 steps, mcr:728-730) plus the on-screen HUD. Here: per-step metrics as
0-d tensors on the state's device (no host read inside the step), a JSONL
host logger with the JAX row layout (``scripts/curve.py`` reads either
package's logs), and a ``torch.profiler`` trace helper.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO

import torch

from .parallel.mesh import World


def env_metrics(state, world: World = World(), num_envs: int | None = None) -> dict:
    """Device-side metrics of a batched EnvState (E, ...): 0-d tensors on
    the state's device, the JAX keys. Under data parallelism the state is
    this rank's rows of ``num_envs`` envs (default: its own rows) and each
    metric is the mean over all of them."""
    f32 = torch.float32
    n = state.reward.shape[0] if num_envs is None else num_envs

    return dict(
        mean_cum_reward=world.mean(state.reward, n),
        mean_tiles_visited=world.mean(state.tile_visited_count.to(f32), n),
        frac_done=world.mean(state.done.to(f32), n),
        frac_on_grass=world.mean(state.driving_on_grass.to(f32), n),
        frac_backward=world.mean(state.driving_backward.to(f32), n),
        mean_speed=world.mean(torch.linalg.vector_norm(state.cars.hull_v, dim=-1), n),
        mean_episode_steps=world.mean(state.steps.to(f32), n),
    )


class JsonlLogger:
    """Append-only JSONL metric log with wall-clock + throughput bookkeeping."""

    def __init__(self, path: str | None = None, stream: IO | None = None):
        self._fh = open(path, "a") if path else stream
        self._t0 = time.time()
        self._last = self._t0
        self._last_steps = 0

    def log(self, step_count: int, metrics: dict, **extra) -> dict:
        now = time.time()
        host = {k: float(v) for k, v in metrics.items()}
        host.update(extra)
        host["env_steps"] = int(step_count)
        host["wall_s"] = round(now - self._t0, 3)
        dt = now - self._last
        if dt > 0:
            host["env_steps_per_sec"] = round((step_count - self._last_steps) / dt, 1)
        self._last, self._last_steps = now, step_count
        if self._fh:
            self._fh.write(json.dumps(host) + "\n")
            self._fh.flush()
        return host


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def profile_trace(logdir: str | None):
    """``torch.profiler`` trace of the block, CPU and (when present) CUDA
    activity, written to ``logdir/trace.json`` as a Chrome trace (open in
    Perfetto or chrome://tracing); a no-op if logdir is None."""
    if logdir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))
