#!/usr/bin/env python3
"""Train on W ranks and in one process with the same flags, and compare.

    python3 scripts/compare_layouts.py --ranks 4 --out runs/layouts -- \\
        --carracing-v0 --num-envs 1024 --updates 2

Runs ``python -m multi_car_racing_tpu_torch.train --distributed`` on
``--ranks`` processes started as torchrun starts them (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``, ``LOCAL_RANK`` set; one rank per
card while there are cards, NCCL when no two ranks share one), then the
same flags in one process, each with a JSONL log under ``--out``. Prints
one JSON line: each run's wall seconds, its rows' ``update_s`` and
``env_steps_per_sec`` (the global batch's steps), the ranks' device lines,
the card's name and power limit, and per update the largest
|ranks - one| / max(1, |one|) over the learner's metrics. Exits 1 when a
run fails or a metric is past ``--tol`` (1e-4, tests/test_torch_multiprocess.py's
bar).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from multi_car_racing_tpu_torch.parallel.mesh import free_port, run_processes  # noqa: E402

HOST_KEYS = ("wall_s", "env_steps_per_sec", "update_s", "env_steps", "update")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--timeout", type=float, default=1200)
    ap.add_argument("flags", nargs=argparse.REMAINDER, help="train.py's flags, after --")
    args = ap.parse_args()
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    os.makedirs(args.out, exist_ok=True)
    logs = {k: os.path.join(args.out, f"{k}.jsonl") for k in ("ranks", "one")}
    for path in logs.values():
        if os.path.exists(path):
            os.remove(path)
    train = [sys.executable, "-m", "multi_car_racing_tpu_torch.train"]
    port, w = str(free_port()), str(args.ranks)
    rank_logs = [os.path.join(args.out, f"rank{r}.txt") for r in range(args.ranks)]
    codes, _, wall_w = run_processes(
        [train + ["--distributed", *flags, "--log", logs["ranks"]]] * args.ranks,
        [dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=port, WORLD_SIZE=w, RANK=str(r),
              LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=w) for r in range(args.ranks)],
        timeout=args.timeout, logs=rank_logs)
    rc_w = max(abs(c) for c in codes)
    codes, _, wall_1 = run_processes([train + [*flags, "--log", logs["one"]]],
                                     timeout=args.timeout,
                                     logs=[os.path.join(args.out, "one.txt")])
    rc_1 = abs(codes[0])
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True).stdout
    except FileNotFoundError:
        smi = "no nvidia-smi: not measured on a card"
    out = {"ranks": args.ranks, "flags": flags, "rc": [rc_w, rc_1], "wall_s": [wall_w, wall_1],
           "nvidia_smi": sorted(set(smi.strip().splitlines())),
           "device_lines": [line.strip() for log in rank_logs for line in open(log)
                            if "device:" in line]}
    ok = rc_w == 0 and rc_1 == 0
    if ok:
        rows = {k: [json.loads(line) for line in open(p)] for k, p in logs.items()}
        out["update_s"] = {k: [r["update_s"] for r in v] for k, v in rows.items()}
        out["env_steps_per_sec"] = {k: [r.get("env_steps_per_sec") for r in v]
                                    for k, v in rows.items()}
        worst = []
        for w, o in zip(rows["ranks"], rows["one"]):
            rel = {k: abs(w[k] - v) / max(1.0, abs(v)) for k, v in o.items()
                   if k not in HOST_KEYS}
            key = max(rel, key=rel.get)
            worst.append({"update": o["update"], "metric": key, "rel": rel[key]})
        out["worst_metric"] = worst
        ok = (len(rows["ranks"]) == len(rows["one"]) > 0
              and all(x["rel"] <= args.tol for x in worst))
    out["ok"] = ok
    print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
