"""The program's own spans in a traced window, and a traced run that reads
them.

The program marks its library-generation path with `torch.profiler`
ranges named `synference::<span>` (`synference_tpu_torch/runtime.py`:
`span`, `traced`). `ProgramTrace` is the harness's `Trace` with those
ranges read as well:
- `program_spans`: span -> [(start, end)] seconds from the window's start,
  the ranges that lie inside the window;
- `program_device_s`: span -> device seconds of the kernels launched
  inside its ranges (as `span_device_s` for the harness's spans);
- `idle_by_span`: the window's idle, each gap cut at every span edge and
  each piece put down to the innermost span of either kind open over it;
  "outside any span" keeps the idle with none open;
- `idle_outside_program_s`: the idle with no program span open;
- `host_syncs`: the CUDA runtime calls that block the host
  (`cuda*Synchronize`) in the window, by the innermost program span open
  at the call.
Every other attribute is the base's, read the same way, so a reader of
the base reads the same value here.

    python3 benchmark/program_trace.py --workload <cell> --seed <n> \
        --seconds <s>

runs the cell traced, as `run.py --trace 1` does, with the cell's
per-layer metrics and the program-span metrics of `PROGRAM_METRICS`, and
prints the result line with `traced_rate`, the rows a second of the traced
window, and the breakdown's `host_syncs`.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402
from collections import defaultdict  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

from benchmark import harness  # noqa: E402

PREFIX = "synference::"
# readers of the program's spans (`metrics/<name>.py`) and their units; a
# cell whose rate metric is `<rate>.<suffix>` reads `<name>.<suffix>`
PROGRAM_METRICS = {"library.readbacks_per_call": "count",
                   "library.to_host_ms": "ms",
                   "sed.window_enqueue_ms": "ms",
                   "device_idle.outside_program": "%"}
OUTSIDE = "outside any span"


def innermost(ranges: list) -> list:
    """[(start, end, label)] covering the ranges' union, each piece with
    the innermost range open over it; `ranges` is [(start, end, label)],
    nested as calls on one thread nest."""
    events = []
    for i, (a, b, _) in enumerate(ranges):
        events.append((a, 1, a - b, i))  # at a tie, the outer opens first
        events.append((b, 0, b - a, i))  # and ends close before opens
    events.sort()
    pieces, stack, t_prev = [], [], None
    for t, opens, _, i in events:
        if stack and t > t_prev:
            pieces.append((t_prev, t, ranges[stack[-1]][2]))
        if opens:
            stack.append(i)
        else:
            stack.remove(i)
        t_prev = t
    return pieces


def split_idle(gaps: list, pieces: list) -> dict:
    """Idle seconds by label: each gap (start, end) cut by the labelled
    pieces (sorted, disjoint); what no piece covers is `OUTSIDE`."""
    out = defaultdict(float)
    starts = [a for a, _, _ in pieces]
    for a, b in gaps:
        covered = 0.0
        j = max(bisect.bisect_right(starts, a) - 1, 0)
        while j < len(pieces) and pieces[j][0] < b:
            lo, hi = max(a, pieces[j][0]), min(b, pieces[j][1])
            if hi > lo:
                out[pieces[j][2]] += hi - lo
                covered += hi - lo
            j += 1
        if b - a - covered > 0.0:
            out[OUTSIDE] += b - a - covered
    return out


class ProgramTrace(harness.Trace):
    """`harness.Trace` that also reads the program's `synference::`
    ranges (module docstring)."""

    def __init__(self, run, spans):
        self.program_spans: dict = {}
        self.program_device_s: dict = {}
        self.idle_outside_program_s = 0.0
        self.host_syncs: dict = {}
        super().__init__(run, spans)

    def _read(self, prof) -> None:
        import torch

        super()._read(prof)
        cuda = torch.autograd.DeviceType.CUDA
        runtime, ops, syncs = {}, {}, []
        bench, program = defaultdict(list), defaultdict(list)
        kernels = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == cuda:
                if not name.startswith(("bench::", PREFIX)):
                    kernels.append((t0, t1, e.correlation_id(),
                                    e.linked_correlation_id()))
            elif name.startswith("bench::"):
                bench[name[7:]].append((t0, t1))
            elif name.startswith(PREFIX):
                program[name[len(PREFIX):]].append((t0, t1))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = t0
                if name.endswith("Synchronize"):
                    syncs.append(t0)
            else:
                ops[e.correlation_id()] = t0
        win = bench.pop("window", [])
        if not win:
            return
        w0, w1 = win[0]

        def rel(iv):
            return sorted(((a - w0) * 1e-9, (b - w0) * 1e-9) for a, b in iv
                          if a >= w0 and b <= w1)

        self.program_spans = {n: r for n, iv in program.items()
                              if (r := rel(iv))}
        # device time of the kernels launched inside each program span
        for name, iv in program.items():
            iv.sort()
            starts = [a for a, _ in iv]
            total, found = 0.0, False
            for a, b, corr, linked in kernels:
                if b <= w0 or a >= w1:
                    continue
                t = runtime.get(corr, ops.get(linked))
                if t is None:
                    continue
                i = bisect.bisect_right(starts, t) - 1
                if i >= 0 and t <= iv[i][1]:
                    total += (min(b, w1) - max(a, w0)) * 1e-9
                    found = True
            if found:
                self.program_device_s[name] = total
        # idle: the gaps between the union of the device operations
        merged = []
        for _, a, b in self.kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        edges = [0.0] + [x for iv in merged for x in iv] + [self.window_s]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        mine = [(a, b, n) for n, iv in self.program_spans.items()
                for a, b in iv]
        theirs = [(a, b, n) for n, iv in bench.items() for a, b in rel(iv)]
        self.idle_by_span = split_idle(gaps, innermost(mine + theirs))
        own = innermost(mine)
        self.idle_outside_program_s = split_idle(gaps, own)[OUTSIDE]
        # the host's blocking calls, by the innermost program span open
        starts = [a for a, _, _ in own]
        counts = defaultdict(int)
        for t in syncs:
            if not w0 <= t <= w1:
                continue
            t = (t - w0) * 1e-9
            i = bisect.bisect_right(starts, t) - 1
            open_ = i >= 0 and t <= own[i][1]
            counts[own[i][2] if open_ else OUTSIDE] += 1
        self.host_syncs = dict(counts)

    def breakdown(self) -> dict:
        out = super().breakdown()
        out["host_syncs"] = sorted(map(list, self.host_syncs.items()),
                                   key=lambda kv: -kv[1])
        return out


def program_metrics(spec: dict, cell: str) -> list:
    """The `PROGRAM_METRICS` entries under the names the cell reads them
    by (a `.<suffix>` twin where the cell's rate metric has one)."""
    e2e, _ = harness.cell_metrics(spec, cell)
    rates = [m["name"] for m in e2e if m["name"] != "setup_s"]
    suffix = rates[0].partition(".")[2] if rates else ""
    return [{"name": f"{n}.{suffix}" if suffix else n, "unit": u}
            for n, u in PROGRAM_METRICS.items()]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    harness.setup_env()
    import torch

    if not torch.cuda.is_available():
        harness.log("no CUDA device: this benchmark runs on the card only")
        return 3
    spec = harness.bench_spec()
    e2e, layer = harness.cell_metrics(spec, args.workload)
    harness.Trace = ProgramTrace  # run_cell reads its window through it
    result, _ = harness.run_cell(
        args.workload, args.seed, args.seconds, True, "cuda", T_START,
        end_to_end=e2e, per_layer=layer + program_metrics(spec,
                                                          args.workload))
    wl = harness.load_json("workloads", args.workload)
    rows = int(wl["params"]["rows_per_call"])
    result["traced_rate"] = (result["attempted"] * rows
                             / result["device"]["window_s"])
    result["checks"] = result.pop("checks")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
