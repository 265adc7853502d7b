"""Multi-process drills of the port on the CPU: ranks as child processes.

Each child runs with one intra-op thread (``OMP_NUM_THREADS=1``) and the
ranks meet over gloo at ``127.0.0.1`` on a free port. ``run_ranks`` gives
every launch its own timeout, kills every child on expiry, and relaunches
once on a fresh port when a rank fails (a handshake can time out while
other test workers load the machine), as tests/test_multiprocess.py's
``_run_pair`` does for the JAX package.

Run as a script, this file is one rank of train steps on saved learners:

    python tests/torch_dist.py STATE,DRAWS,OUT[,fp32] [...] --coordinator 127.0.0.1:PORT \\
        --num-processes 2 --process-id 0

For each job it restores the checkpoint STATE (its rows), takes one
``learner.ppo.make_train_step`` step with the draws saved in DRAWS
(``torch.save`` of {"noise", "perm"}), checks that the learner is the same
on every rank, saves it to OUT (``checkpoint.save``, which gathers the env
rows) and writes its metrics to ``OUT.rank<r>.metrics``. A job ending in
``,fp32`` runs the pixel torso in float32 (``networks.PIXEL_COMPUTE_DTYPE``).
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys

from multi_car_racing_tpu_torch.parallel.mesh import free_port, run_processes

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = [sys.executable, "-m", "multi_car_racing_tpu_torch.train"]
STEP = [sys.executable, os.path.abspath(__file__)]


def rank_args(port: int, rank: int, size: int) -> list:
    return ["--coordinator", f"127.0.0.1:{port}", "--num-processes", str(size),
            "--process-id", str(rank)]


def child_env() -> dict:
    return dict(os.environ, OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))


def launch(cmd: list) -> subprocess.Popen:
    """One rank whose output is read as it comes (the fault-injection drill)."""
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env=child_env(), cwd=REPO)


def kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            os.kill(p.pid, signal.SIGKILL)


def run_ranks(make_cmd, size: int = 2, timeout: float = 240, retries: int = 1):
    """Launch ``make_cmd(port, rank)`` for every rank and wait (``parallel.mesh.
    run_processes``); relaunch on a fresh port once if a rank fails or the
    launch times out. Returns (return codes, outputs)."""
    for _ in range(retries + 1):
        port = free_port()
        codes, outs, _ = run_processes([make_cmd(port, r) for r in range(size)],
                                       [child_env()] * size, cwd=REPO, timeout=timeout)
        if codes == [0] * size:
            break
    return codes, outs


def train_pair(args: list, timeout: float = 240):
    """``python -m multi_car_racing_tpu_torch.train --distributed`` on two ranks."""
    return run_ranks(lambda port, r: TRAIN + args + ["--distributed"] + rank_args(port, r, 2),
                     timeout=timeout)


def step_ranks(jobs, size: int = 2, timeout: float = 240):
    """One train step of each saved learner, ``jobs`` of (state, draws, out)
    paths, on ``size`` ranks (one launch for all jobs)."""
    jobs = [",".join(job) for job in jobs]
    return run_ranks(lambda port, r: STEP + jobs + rank_args(port, r, size),
                     size=size, timeout=timeout)


def _step_main(argv) -> None:
    import argparse

    import torch

    from multi_car_racing_tpu_torch import checkpoint
    from multi_car_racing_tpu_torch.learner import networks, ppo
    from multi_car_racing_tpu_torch.parallel import mesh

    ap = argparse.ArgumentParser()
    ap.add_argument("jobs", nargs="+")
    ap.add_argument("--coordinator")
    ap.add_argument("--num-processes", type=int)
    ap.add_argument("--process-id", type=int)
    args = ap.parse_args(argv)
    torch.set_num_threads(1)
    world, dev = mesh.init(args.coordinator, args.num_processes, args.process_id, "cpu")
    try:
        for job in args.jobs:
            state, draws, out, *flags = job.split(",")
            networks.PIXEL_COMPUTE_DTYPE = torch.float32 if "fp32" in flags else torch.bfloat16
            ts = checkpoint.restore(state, device=dev, world=world)
            draws = torch.load(draws, weights_only=True)
            ts, metrics = ppo.make_train_step(ts.env_cfg, ts.ppo_cfg, world)(ts, draws=draws)
            world.check_replicated([*ts.net.parameters(), *ts.opt.mu, *ts.opt.nu,
                                    ts.opt.count, ts.generator.get_state()],
                                   "the learner after the step")
            checkpoint.save(out, ts, world)
            torch.save({k: float(v) for k, v in metrics.items()},
                       f"{out}.rank{world.rank}.metrics")
    finally:
        mesh.shutdown()


if __name__ == "__main__":
    _step_main(sys.argv[1:])
