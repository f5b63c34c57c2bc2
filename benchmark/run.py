"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device` and, traced, `breakdown`;
its last key, `checks`, holds each number the correctness check compared
with its limit, and the same numbers end standard error. Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with 3. It exits with 4, and prints no result, when JAX or the JAX
package was loaded in the process.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    harness.setup_env()
    import torch

    spec = harness.bench_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        harness.log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark runs on the card only")
        return 3
    if torch.cuda.device_count() < cells[args.workload]["chips"]:
        harness.log(f"the cell needs {cells[args.workload]['chips']} "
                    f"cards, {torch.cuda.device_count()} present")
        return 3
    result, checks = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace), "cuda",
        T_START)
    found = harness.forbidden_modules()
    if found:
        harness.log(f"the run loaded {found}: it may not")
        return 4
    for name, value, limit in checks:
        harness.log(f"check {name} {value!r} limit {limit!r} "
                    f"{'ok' if value <= limit else 'FAIL'}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
