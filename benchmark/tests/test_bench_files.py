"""The benchmark's files against BENCHMARK.json and the benchmark's
contract: every configuration, cell, driver and per-layer metric is a file
of its own, found by name, and the JSON keeps to the format rules."""

import json
import re
import shutil
import subprocess
import sys

import _tiny
from _tiny import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = harness.BENCH
SPEC = harness.bench_spec()


def _one_line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["benchmark"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_are_files_found_by_name():
    files = {p.stem for p in (BENCH / "configs").glob("*.json")}
    names = {c["name"] for c in SPEC["configs"]}
    assert names == files
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = harness.load_json("configs", c["name"])
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert key in cfg and NAME.match(key)
        assert NAME.match(c["name"]) and _one_line(c["why"])
        assert _one_line(c["source"])


def test_workloads_are_files_found_by_name():
    """Every cell of BENCHMARK.json is a file; a cell file that
    BENCHMARK.json does not list yet (kept for a later PR) loads too."""
    files = {p.stem for p in (BENCH / "workloads").glob("*.json")}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert cells <= files
    for name in files:
        wl = harness.load_json("workloads", name)
        assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
        assert (BENCH / "configs" / f"{wl['config']}.json").exists()
        assert NAME.match(name) and _one_line(wl["why"])
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        wl = harness.load_json("workloads", w["name"])
        assert wl["config"] == w["config"] and wl["traffic"] == w["traffic"]
        assert (BENCH / "drivers" / f"{wl['driver']}.py").exists()
        driver = harness.load_module("drivers", wl["driver"])
        assert callable(driver.run) and callable(driver.check)
        assert w["chips"] == 1 and _one_line(w["why"])
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(SPEC["workloads"])


def test_metrics_are_files_and_every_cell_reports_enough():
    files = {p.stem for p in (BENCH / "metrics").glob("*.py")}
    assert {m["name"] for m in SPEC["per_layer"]} <= files
    for name in files:
        assert callable(harness.load_module("metrics", name).read)
    e2e_names = {m["name"] for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e_names
    for m in SPEC["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e_names and m["moves"] != "setup_s"
        assert _one_line(m["layer"]) and UNIT.match(m["unit"])
        mod = harness.load_module("metrics", m["name"])
        assert callable(mod.read)
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in SPEC["workloads"]:
        e2e, layer = harness.cell_metrics(SPEC, w["name"])
        names = {m["name"] for m in e2e}
        assert "setup_s" in names and len(names) >= 2
        assert layer
        for m in layer:
            assert m["moves"] in names


def test_a_new_cell_is_found_without_editing_a_file(tmp_path):
    """A throwaway cell and configuration, added as files and an entry,
    run from a copy of the benchmark with no other change."""
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p.relative_to(tmp_path): p.read_bytes()
              for p in (tmp_path / "benchmark").rglob("*") if p.is_file()}
    wl, cfg = _tiny.generate_cell(n_bands=2)
    cfg["name"] = "throwaway"
    wl["config"] = "throwaway"
    (tmp_path / "benchmark/configs/throwaway.json").write_text(
        json.dumps(cfg))
    (tmp_path / "benchmark/workloads/throwaway.generate.json").write_text(
        json.dumps(wl))
    spec = json.loads(json.dumps(SPEC))
    spec["workloads"].append({"name": "throwaway.generate",
                              "config": "throwaway", "traffic": "tiny",
                              "chips": 1, "why": "a test cell"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m and "north-star.generate" in m["workloads"]:
            m["workloads"].append("throwaway.generate")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    result, checks = harness.run_cell(
        "throwaway.generate", 5, 0.3, False, "cpu",
        __import__("time").perf_counter(), root=tmp_path)
    assert result["correct"], checks
    assert "library_seds_per_s" in result["metrics"]
    after = {p.relative_to(tmp_path): p.read_bytes()
             for p in (tmp_path / "benchmark").rglob("*")
             if p.is_file() and p.relative_to(tmp_path) in before}
    assert after == before


def test_run_without_a_card_prints_no_result(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(BENCH / "run.py"), "--workload",
         "north-star.generate", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
