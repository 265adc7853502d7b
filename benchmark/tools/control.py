"""The check's control on the card at a cell's own size: the plain reference
rounded to bfloat16 put in the program's place (``check.Check(control=
True)``), on several seeds in one process, each after a short window of the
cell's own load that reaches every checked decision and reset. Prints one
JSON line per seed with the compared numbers; a limit must lie below each
cell's smallest control reading of at least one number.

    python3 benchmark/tools/control.py --workload <cell> --seeds 1 2 3 [--seconds 5]
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark.harness import cell as hc
    from benchmark.harness import loader

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = loader.cell(args.workload)
    reach = max(b for _, b in cell.traffic["check"]["decisions"])
    reach = max(reach, (max(cell.traffic["check"]["resets"]) + 1) * cell.traffic["rollout_len"])
    for seed in args.seeds:
        res = hc.run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                     time.perf_counter(), control=True, min_decisions=reach + 1)
        lines = res.pop("_lines")
        print(json.dumps({"workload": cell.name, "seed": seed, "control": "bfloat16",
                          "correct": res["correct"],
                          "numbers": {k: v["value"] for k, v in res["check"].items()},
                          "lines": lines}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
