"""One run of one cell of the benchmark of multi_car_racing_tpu_torch.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout, on a machine with an NVIDIA card. The last
line of standard output is one JSON object: ``correct``, ``attempted`` and
``failed`` (decisions made, and those after which some env's cars were not
finite), ``metrics`` (the cell's end-to-end metrics, or with ``--trace 1``
its per-layer metrics), ``device``, with ``--trace 1`` a ``breakdown``, and
last ``check``: each number the correctness check compared, with its limit.
The same numbers close standard error. Without a card, or with fewer cards
than the cell asks for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True, help="the cell's name (benchmark/workloads/)")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    # The checkout's root, not this directory, is where packages are found.
    sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve()
                                 != Path(__file__).resolve().parent]
    # Caches a library could write go inside the checkout, at fixed paths.
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
    from benchmark.harness import cell as run_cell
    from benchmark.harness import loader

    cell = loader.cell(args.workload)
    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device is available; the benchmark measures the card "
              "and does not run on the CPU", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: cell {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    result = run_cell.run(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T_START)
    lines = result.pop("_lines")
    found = run_cell.forbidden_modules()
    if found:
        print(f"benchmark: the run loaded {', '.join(found)}; the port's benchmark may load "
              "neither JAX nor the JAX package", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
