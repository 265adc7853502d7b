"""Run cells of the benchmark several times in one process tree, one run
after another, as the checks do, and print one summary line per run.

    python3 benchmark/tools/series.py --out <dir> \\
        --runs <cell>:<seed>:<seconds>:<trace> [...]

Each run's standard output and error go to ``<out>/<cell>.<seed>.<trace>.
{out,err}``; the summary line gives its exit code, wall seconds, correct,
the metrics and the check's numbers.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--out", required=True)
    p.add_argument("--runs", nargs="+", required=True)
    p.add_argument("--timeout", type=float, default=1200)
    args = p.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    worst = 0
    for spec in args.runs:
        cell, seed, seconds, trace = spec.split(":")
        stem = out / f"{cell}.{seed}.{trace}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", cell, "--seed", seed,
             "--seconds", seconds, "--trace", trace],
            cwd=ROOT, capture_output=True, text=True, timeout=args.timeout)
        wall = time.perf_counter() - t0
        Path(f"{stem}.out").write_text(proc.stdout)
        Path(f"{stem}.err").write_text(proc.stderr)
        line = proc.stdout.strip().splitlines()[-1] if proc.stdout.strip() else ""
        try:
            res = json.loads(line)
            summary = {"correct": res["correct"], "attempted": res["attempted"],
                       "failed": res["failed"],
                       "metrics": {k: v["value"] for k, v in res["metrics"].items()},
                       "peak_gib": res["device"]["memory_peak_bytes"] / 2 ** 30,
                       "check": {k: v["value"] for k, v in res["check"].items()}}
            if "busy_s" in res["device"]:
                summary["busy_s"] = res["device"]["busy_s"]
                summary["window_s"] = res["device"]["window_s"]
        except (ValueError, KeyError):
            summary = {"stderr_tail": proc.stderr[-3000:]}
        worst = max(worst, proc.returncode)
        print(json.dumps({"run": spec, "rc": proc.returncode, "wall_s": round(wall, 2),
                          **summary}), flush=True)
    return worst


if __name__ == "__main__":
    sys.exit(main())
