"""Readings from which a cell's correctness limits are set.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up and a window of `s`
seconds, the check's readings of the program, and the readings of the
control (the traffic driver's `control`: the plain reference in the
program's place, computed in the precision below the configuration's)
and, where the traffic driver plants faults (`faults`), theirs. One
JSON line per seed; the benchmark's own runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    harness.setup_env()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    wl = harness.load_json("workloads", args.workload)
    cfg = harness.load_json("configs", wl["config"])
    driver = harness.load_module("drivers", wl["driver"])
    for seed in args.seeds:
        ctx = harness.Run(args.workload, seed, args.seconds, False,
                          "cuda", cfg, wl.get("params", {}),
                          wl.get("limits", {}), time.perf_counter())
        out = driver.run(ctx)
        state = out.pop("state")
        gc.collect()
        program = {k: v for k, v, _ in driver.check(ctx, state)}
        control = driver.control(ctx, state)
        line = {"workload": args.workload, "seed": seed,
                "setup_s": ctx.t_begin - ctx.t_start,
                "metrics": out["metrics"], "program": program,
                "control": control}
        if hasattr(driver, "faults"):
            line["faults"] = driver.faults(ctx, state)
        print(json.dumps(line), flush=True)
        del state
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
