"""Multi-process drills of the port's trainer on the CPU, mirroring
tests/test_multiprocess.py: ``python -m multi_car_racing_tpu_torch.train
--distributed`` on two gloo ranks (child processes, tests/torch_dist.py)
with the JAX drill's flags and ``--device cpu``.

- Both ranks print the same losses (the gradient all-reduce ran), and rank
  0's JSONL rows match a one-process run of the same flags, every metric
  within 1e-4 * max(1, |x|): the ranks compute the one-process step on the
  global batch.
- Fault injection: SIGKILL rank 1 after its first checkpoint; the survivor
  cannot proceed (its next collective fails or blocks) and is torn down; a
  relaunched pair ``--resume``s from the checkpoint and continues at the
  update after the saved one.
- Checkpoints cross layouts: the two-rank checkpoint resumes in one process,
  and a one-process checkpoint resumes on two ranks, and the two resumed
  runs' next rows agree.
"""

from __future__ import annotations

import json
import os
import re
import select
import signal
import subprocess
import time

import pytest

from multi_car_racing_tpu_torch import train
from torch_dist import TRAIN, free_port, kill, launch, rank_args, train_pair
from torch_threads import one_torch_thread  # noqa: F401 (autouse fixture)

BASE_ARGS = [
    "--updates", "2", "--num-envs", "4", "--rollout", "4", "--pool-size", "2",
    "--num-agents", "2", "--obs", "state", "--fast-solver", "--device", "cpu",
]
METRIC_TOL = 1e-4
HOST_KEYS = ("wall_s", "env_steps_per_sec", "update_s")     # wall-clock, not the learner's


def _losses(out):
    return re.findall(r"update\s+\d+ loss ([+-][\d.]+)", out)


def _rows(path):
    return [json.loads(line) for line in open(path)]


def _assert_rows_match(got, want):
    assert [r["update"] for r in got] == [r["update"] for r in want]
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k, v in w.items():
            if k not in HOST_KEYS:
                assert abs(g[k] - v) <= METRIC_TOL * max(1.0, abs(v)), (g["update"], k, g[k], v)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two updates on two ranks and in one process, each with a JSONL log
    and a checkpoint after every update."""
    d = tmp_path_factory.mktemp("runs")
    paths = {k: str(d / k) for k in ("pair.jsonl", "pair_ck", "one.jsonl", "one_ck")}
    codes, outs = train_pair(BASE_ARGS + ["--log", paths["pair.jsonl"], "--checkpoint",
                                          paths["pair_ck"], "--ckpt-every", "1"])
    train.main(BASE_ARGS + ["--log", paths["one.jsonl"], "--checkpoint", paths["one_ck"],
                            "--ckpt-every", "1"])
    return codes, outs, paths


def test_two_process_training_losses_match(runs):
    codes, outs, _ = runs
    assert codes == [0, 0], outs
    assert "process 0 of 2 (gloo), env rows 0:2 of 4" in outs[0]
    assert "process 1 of 2 (gloo), env rows 2:4 of 4" in outs[1]
    l0, l1 = _losses(outs[0]), _losses(outs[1])
    assert len(l0) == 2 and l0 == l1, (l0, l1)


def test_rank0_log_matches_one_process(runs):
    codes, outs, paths = runs
    assert codes == [0, 0], outs
    _assert_rows_match(_rows(paths["pair.jsonl"]), _rows(paths["one.jsonl"]))


def test_fault_injection_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    extra = ["--checkpoint", ckpt, "--ckpt-every", "1", "--updates", "50"]
    # 50 updates: the run is meant to be cut long before it ends.
    port = free_port()
    procs = [launch(TRAIN + BASE_ARGS + extra + ["--distributed"] + rank_args(port, r, 2))
             for r in range(2)]
    survivor, victim = procs
    try:
        # Wait for rank 1's first checkpoint line (a select() deadline, so a
        # rank that hangs without printing trips it), then kill rank 1.
        deadline, seen, got_ckpt = time.time() + 240, [], False
        while time.time() < deadline and not got_ckpt:
            ready, _, _ = select.select([victim.stdout], [], [], 5.0)
            if not ready:
                assert victim.poll() is None, "rank 1 exited early:\n" + "".join(seen)
                continue
            line = victim.stdout.readline()
            if not line:
                break
            seen.append(line)
            got_ckpt = "checkpointed" in line
        assert got_ckpt, "no checkpoint before the deadline:\n" + "".join(seen)
        os.kill(victim.pid, signal.SIGKILL)
        victim.wait(timeout=60)
        # The survivor's next collective fails or blocks: tear it down.
        try:
            survivor.wait(timeout=15)
        except subprocess.TimeoutExpired:
            os.kill(survivor.pid, signal.SIGKILL)
            survivor.wait(timeout=60)
    finally:
        kill(procs)
        for p in procs:
            p.stdout.close()

    codes, outs = train_pair(BASE_ARGS + ["--checkpoint", ckpt, "--ckpt-every", "1",
                                          "--updates", "2", "--resume", ckpt])
    for code, out in zip(codes, outs):
        assert code == 0, out
        m = re.search(r"resumed from .* at update (\d+)", out)
        assert m and int(m.group(1)) >= 1, out
        upds = [int(u) for u in re.findall(r"update\s+(\d+) loss", out)]
        assert upds == [int(m.group(1)) + 1, int(m.group(1)) + 2], out
    assert _losses(outs[0]) == _losses(outs[1])


def test_checkpoints_resume_across_layouts(runs, tmp_path, capsys):
    """The two-rank checkpoint (update 2) in one process, and the
    one-process checkpoint on two ranks: both resume at update 2, and their
    update-3 rows agree (the two checkpoints hold the same learner)."""
    codes, outs, paths = runs
    assert codes == [0, 0], outs
    one_log, pair_log = str(tmp_path / "one.jsonl"), str(tmp_path / "pair.jsonl")
    ts = train.main(BASE_ARGS + ["--updates", "1", "--resume", paths["pair_ck"],
                                 "--log", one_log])
    assert f"resumed from {paths['pair_ck']} at update 2" in capsys.readouterr().out
    assert ts.update_i == 3 and tuple(ts.env_state.steps.shape) == (4,)
    codes, outs = train_pair(BASE_ARGS + ["--updates", "1", "--resume", paths["one_ck"],
                                          "--log", pair_log])
    for code, out in zip(codes, outs):
        assert code == 0, out
        assert f"resumed from {paths['one_ck']} at update 2" in out, out
        assert re.search(r"update\s+3 loss", out), out
    assert _losses(outs[0]) == _losses(outs[1])
    _assert_rows_match(_rows(pair_log), _rows(one_log))
