"""The harness every cell runs under.

`run_cell` builds a cell from its files (`workloads/<cell>.json` names its
configuration `configs/<config>.json`, its traffic driver
`drivers/<driver>.py` and that module's parameters), lets the module set
up and drive its timed window, reads the per-layer metrics of a traced
run from `metrics/<metric>.py`, and has the module hold what the window
produced to the plain reference. Nothing here names a cell, a
configuration or a metric: adding one is adding its files and its entry
in BENCHMARK.json.

A driver module defines `run(ctx) -> dict` (set-up, then the window
between `ctx.begin_window()` and `ctx.end_window()`, returning
{"metrics", "attempted", "failed", "state"}) and `check(ctx, state) ->
list of (name, value, limit)`; a reading passes when value <= limit.

A metric reader defines `read(trace) -> float | None` and may name the
program's functions it needs wrapped in spans, `SPANS = {span: "module:
Qualified.name"}`. Spans are installed in traced runs only; a name the
program no longer has leaves its metrics out of the line, with a note on
standard error. A reader also finds the program's own `synference::`
ranges in the `Trace` (`program_spans`, `program_device_s`).
"""

from __future__ import annotations

import bisect
import gc
import importlib
import importlib.util
import inspect
import json
import os
import pathlib
import sys
import time
from collections import defaultdict

BENCH = pathlib.Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache the program or its libraries keep goes here, at a fixed path
# inside the checkout
CACHE = ROOT / ".bench_cache"
FORBIDDEN = ("jax", "jaxlib", "flax", "synference_tpu")


def setup_env() -> None:
    """Environment of a run: caches inside the checkout, no JAX backends
    for libraries that would load one, the repository importable."""
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "nv")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    os.environ.setdefault("OMP_NUM_THREADS", "4")
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(kind: str, name: str, root: pathlib.Path = BENCH) -> dict:
    return json.loads((root / kind / f"{name}.json").read_text())


def load_module(kind: str, name: str, root: pathlib.Path = BENCH):
    """`<root>/<kind>/<name>.py` as a module (names may hold dots)."""
    path = root / kind / f"{name}.py"
    mod_name = "benchmark_{}_{}".format(
        kind, "".join(c if c.isalnum() else "_" for c in name))
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def bench_spec(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end, per-layer) metric entries that `cell` reports."""
    e2e = [m for m in spec["end_to_end"]
           if "workloads" not in m or cell in m["workloads"]]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if (cell in m["workloads"] if "workloads" in m
                 else m["moves"] in names)]
    return e2e, layer


def forbidden_modules() -> list:
    """Top-level names of loaded modules that a run may not hold."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


# ---------------------------------------------------------------------------
# spans around the program's functions (traced runs only)
# ---------------------------------------------------------------------------
class Spans:
    """Host-clock spans, each also a `record_function` range named
    `bench::<span>` in the profiler's timeline."""

    def __init__(self):
        self.times = defaultdict(list)
        self._undo = []

    def wrap(self, span: str, target: str) -> bool:
        """Wrap `module:Owner.attr`; False when the program has no such
        name."""
        import torch

        mod_name, _, qual = target.partition(":")
        try:
            owner = importlib.import_module(mod_name)
            *path, attr = qual.split(".")
            for part in path:
                owner = getattr(owner, part)
            raw = inspect.getattr_static(owner, attr)
        except (ImportError, AttributeError):
            return False
        is_static = isinstance(raw, staticmethod)
        fn = raw.__func__ if is_static else raw
        if not callable(fn):
            return False
        times = self.times[span]

        def wrapper(*args, **kwargs):
            t0 = time.perf_counter()
            with torch.profiler.record_function("bench::" + span):
                out = fn(*args, **kwargs)
            times.append((t0, time.perf_counter()))
            return out

        setattr(owner, attr, staticmethod(wrapper) if is_static else wrapper)
        self._undo.append((owner, attr, raw))
        return True

    def restore(self) -> None:
        for owner, attr, raw in reversed(self._undo):
            setattr(owner, attr, raw)
        self._undo.clear()


# ---------------------------------------------------------------------------
# the run context a driver receives
# ---------------------------------------------------------------------------
class Run:
    """What a driver gets: the seed, the window length, the device, the
    configuration and its own parameters; `begin_window` / `end_window`
    around the measured work. In a traced run the window runs under
    `torch.profiler`."""

    def __init__(self, cell: str, seed: int, seconds: float, trace: bool,
                 device, config: dict, params: dict, limits: dict,
                 t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.trace = bool(trace)
        self.device = device
        self.config, self.params, self.limits = config, params, limits
        self.t_start = t_start
        self.t_begin = self.t_end = None
        self.counters: dict = {}
        self.work: dict = {}
        self.prof = None
        self._range = None

    def sync(self) -> None:
        import torch

        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def begin_window(self) -> None:
        import torch

        self.sync()
        if self.trace:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.device(self.device).type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()
            self._range = torch.profiler.record_function("bench::window")
            self._range.__enter__()
        self.t_begin = time.perf_counter()

    def end_window(self) -> None:
        self.sync()
        self.t_end = time.perf_counter()
        if self.trace:
            self._range.__exit__(None, None, None)
            self.prof.stop()

    @property
    def window_s(self) -> float:
        return self.t_end - self.t_begin

    def seed_of(self, i: int, salt: int = 0) -> int:
        """Seed of the i-th call drawn from the run's seed (63 bits)."""
        return (self.seed * 1_000_003 + salt * 7_919 + i) % (2 ** 63)


# ---------------------------------------------------------------------------
# reading a traced window
# ---------------------------------------------------------------------------
# the program's own ranges (`synference_tpu_torch.runtime.span`): host
# ranges on the profiler's clock, with no device-side annotation
PREFIX = "synference::"
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


def _device_s(ranges: dict, launches: list, w0: int, w1: int) -> dict:
    """span -> device seconds (inside the window) of the kernels whose
    launch falls inside one of the span's ranges; `launches` is [(launch
    time, start, end)]; spans that launched none are left out."""
    out = {}
    for span, iv in ranges.items():
        iv = sorted(iv)
        starts = [a for a, _ in iv]
        total, found = 0.0, False
        for t, a, b in launches:
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += (min(b, w1) - max(a, w0)) * 1e-9
                found = True
        if found:
            out[span] = total
    return out


class Trace:
    """A traced window as the metric readers see it, in seconds from the
    window's start:
    - `kernels`: device operations (name, start, end); `busy_s`: the union
      of their intervals;
    - `spans`: the host-clock durations of the harness's spans that fall
      in the window; `span_device_s`: the device time of the kernels
      launched inside each harness span;
    - `program_spans`: the program's `synference::<span>` ranges that lie
      in the window, span -> [(start, end)]; `program_device_s`: the
      device time of the kernels launched inside each;
    - `idle_by_span`: the window's idle, each gap cut at every span edge
      and each piece put down to the innermost span of either kind open
      over it; `OUTSIDE` keeps the idle with none open;
      `idle_outside_program_s`: the idle with no program span open;
    - `host_syncs`: the CUDA runtime calls that block the host
      (`cuda*Synchronize`) in the window, by the innermost program span
      open at the call;
    - `counters` and `work`: what the traffic driver counted."""

    def __init__(self, run: Run, spans: Spans | None):
        self.window_s = run.window_s
        self.counters = run.counters
        self.work = run.work
        self.spans = {
            name: [b - a for a, b in iv
                   if a >= run.t_begin and b <= run.t_end]
            for name, iv in (spans.times.items() if spans else ())}
        self.kernels: list = []
        self.span_device_s: dict = {}
        self.program_spans: dict = {}
        self.program_device_s: dict = {}
        self.idle_by_span: dict = {}
        self.idle_outside_program_s = 0.0
        self.host_syncs: dict = {}
        self.busy_s = 0.0
        if run.prof is not None:
            self._read(run.prof)

    def _read(self, prof) -> None:
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        runtime, ops, syncs = {}, {}, []
        ranges, program = defaultdict(list), defaultdict(list)
        kernels = []
        for e in prof.profiler.kineto_results.events():
            name = e.name()
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            if e.device_type() == cuda:
                if not name.startswith(("bench::", PREFIX)):
                    kernels.append((name, t0, t1, e.correlation_id(),
                                    e.linked_correlation_id()))
            elif name.startswith("bench::"):
                ranges[name[7:]].append((t0, t1))
            elif name.startswith(PREFIX):
                program[name[len(PREFIX):]].append((t0, t1))
            elif name.startswith("cu"):
                runtime[e.correlation_id()] = t0
                if name.endswith("Synchronize"):
                    syncs.append(t0)
            else:
                ops[e.correlation_id()] = t0
        win = ranges.pop("window", [])
        if not win:
            return
        w0, w1 = win[0]
        kernels = [k for k in kernels if k[2] > w0 and k[1] < w1]
        kernels.sort(key=lambda k: k[1])
        self.kernels = [(n, (max(a, w0) - w0) * 1e-9,
                         (min(b, w1) - w0) * 1e-9)
                        for n, a, b, _, _ in kernels]
        # busy: the union of the device operations' intervals
        merged = []
        for _, a, b in self.kernels:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        self.busy_s = sum(b - a for a, b in merged)

        # device time of the kernels launched inside each span, by the
        # launch's runtime call or, failing that, the operator's
        launches = [(t, a, b) for _, a, b, corr, linked in kernels
                    if (t := runtime.get(corr, ops.get(linked))) is not None]
        self.span_device_s = _device_s(ranges, launches, w0, w1)
        self.program_device_s = _device_s(program, launches, w0, w1)

        def rel(iv):
            return sorted(((a - w0) * 1e-9, (b - w0) * 1e-9) for a, b in iv
                          if a >= w0 and b <= w1)

        self.program_spans = {n: r for n, iv in program.items()
                              if (r := rel(iv))}
        # idle: the gaps between the busy intervals, by the innermost span
        edges = [0.0] + [x for iv in merged for x in iv] + [self.window_s]
        gaps = [(a, b) for a, b in zip(edges[::2], edges[1::2]) if b > a]
        mine = [(a, b, n) for n, iv in self.program_spans.items()
                for a, b in iv]
        theirs = [(a, b, n) for n, iv in ranges.items() for a, b in rel(iv)]
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
            inside = i >= 0 and t <= own[i][1]
            counts[own[i][2] if inside else OUTSIDE] += 1
        self.host_syncs = dict(counts)

    def kernel_s(self, *fragments) -> float:
        """Device seconds of operations whose name holds any fragment."""
        return sum(b - a for n, a, b in self.kernels
                   if any(f in n for f in fragments))

    def breakdown(self) -> dict:
        by_op = defaultdict(float)
        for n, a, b in self.kernels:
            by_op[n[:120]] += b - a
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_span.items(), key=lambda kv: -kv[1])[:10]
        syncs = sorted(self.host_syncs.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps],
                "host_syncs": [[n, c] for n, c in syncs]}


# ---------------------------------------------------------------------------
# one run of one cell
# ---------------------------------------------------------------------------
def run_cell(cell: str, seed: int, seconds: float, trace: bool, device,
             t_start: float, root: pathlib.Path = ROOT,
             workload: dict | None = None, config: dict | None = None,
             per_layer: list | None = None, end_to_end: list | None = None):
    """Run one cell; returns (result dict, checks). The keyword overrides
    let tests run a cell of their own at a small size on the CPU."""
    import torch

    bench = root / "benchmark"
    spec = bench_spec(root) if (per_layer is None or end_to_end is None) \
        else None
    if spec is not None:
        e2e, layer = cell_metrics(spec, cell)
        end_to_end = e2e if end_to_end is None else end_to_end
        per_layer = layer if per_layer is None else per_layer
    workload = workload or load_json("workloads", cell, bench)
    config = config or load_json("configs", workload["config"], bench)
    driver = load_module("drivers", workload["driver"], bench)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(min(4, torch.get_num_threads()))

    readers, spans = {}, None
    if trace:
        spans = Spans()
        for m in per_layer:
            mod = load_module("metrics", m["name"], bench)
            missing = [t for s, t in getattr(mod, "SPANS", {}).items()
                       if not spans.wrap(s, t)]
            if missing:
                log(f"metric {m['name']}: the program has no {missing}; "
                    "left out")
                continue
            readers[m["name"]] = (mod, m)

    ctx = Run(cell, seed, seconds, trace, device, config,
              workload.get("params", {}), workload.get("limits", {}),
              t_start)
    try:
        out = driver.run(ctx)
    finally:
        if spans is not None:
            spans.restore()
    setup_s = ctx.t_begin - t_start
    dev_type = torch.device(device).type
    peak = (torch.cuda.max_memory_allocated() if dev_type == "cuda" else 0)

    metrics = {}
    extra = {}
    if not trace:
        wanted = {m["name"]: m for m in end_to_end}
        values = dict(out["metrics"], setup_s=setup_s)
        for name, m in wanted.items():
            if name in values and values[name] is not None:
                metrics[name] = {"value": values[name], "unit": m["unit"]}
    else:
        tr = Trace(ctx, spans)
        for name, (mod, m) in readers.items():
            value = mod.read(tr)
            if value is None:
                log(f"metric {name}: nothing to read in this window")
                continue
            metrics[name] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": tr.busy_s, "window_s": tr.window_s,
                 "breakdown": tr.breakdown()}

    state = out.pop("state")
    gc.collect()
    if dev_type == "cuda":
        torch.cuda.empty_cache()
    checks = driver.check(ctx, state)
    del state
    result = {
        "correct": all(v <= lim for _, v, lim in checks),
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": {
            "platform": "gpu" if dev_type == "cuda" else dev_type,
            "kind": (torch.cuda.get_device_name(0) if dev_type == "cuda"
                     else "cpu"),
            "count": 1,
            "memory_peak_bytes": int(peak),
        },
    }
    if trace:
        result["device"]["busy_s"] = extra["busy_s"]
        result["device"]["window_s"] = extra["window_s"]
        result["breakdown"] = extra["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return result, checks
