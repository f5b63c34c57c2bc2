"""Small cells for the benchmark's CPU tests: the real configurations and
workloads cut to sizes a test run holds (a tiny grid, two or three bands,
a small flow), run through the harness on the CPU."""

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402

harness.setup_env()


def generate_cell(cell="north-star.generate", n_bands=2):
    wl = harness.load_json("workloads", cell)
    cfg = harness.load_json("configs", wl["config"])
    cfg["grid"].update(n_ages=8, n_mets=4, n_wav=1024)
    cfg["filters"] = cfg["filters"][:n_bands]
    wl["params"].update(rows_per_call=4096, warmup_calls=1,
                        sample_rows_per_call=16, max_sample_rows=256,
                        strata=64)
    return wl, cfg


def train_cell():
    wl = harness.load_json("workloads", "north-star.train")
    cfg = harness.load_json("configs", wl["config"])
    cfg["grid"].update(n_ages=8, n_mets=4, n_wav=1024)
    cfg["library_rows"], cfg["train_library_rows"] = 8192, 2048
    cfg["flow"].update(n_nets=2,
                       batch_size=128)
    return wl, cfg


# the train cell's metrics, for its file that BENCHMARK.json does not
# list yet
TRAIN_METRICS = (
    [{"name": "train_step_ms", "unit": "ms"}, {"name": "setup_s",
                                               "unit": "s"}],
    [{"name": n, "unit": u} for n, u in (
        ("train.launches_per_step", "count"), ("train.validation_ms", "ms"),
        ("train_mfu", "%"), ("device_idle.train", "%"))])


def run(cell, wl, cfg, trace=False, seconds=0.5, seed=2 ** 31 + 11,
        root=harness.ROOT):
    spec = harness.bench_spec(root)
    e2e, layer = harness.cell_metrics(spec, cell)
    if wl["driver"] == "train":
        e2e, layer = TRAIN_METRICS
    return harness.run_cell(cell, seed, seconds, trace, "cpu",
                            time.perf_counter(), root=root, workload=wl,
                            config=cfg, per_layer=layer, end_to_end=e2e)


def ctx(cell, wl, cfg, seed=2 ** 31 + 3, seconds=0.5):
    return harness.Run(cell, seed, seconds, False, "cpu", cfg,
                       wl.get("params", {}), wl.get("limits", {}),
                       time.perf_counter())


def dumps(obj) -> str:
    return json.dumps(obj)
