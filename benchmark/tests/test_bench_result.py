"""The result line of a run, made on the CPU at a small size: its keys,
its types and the checks' key last; and a traced run's extra keys."""

import json

import _tiny


def test_result_line_format():
    wl, cfg = _tiny.generate_cell()
    result, checks = _tiny.run("north-star.generate", wl, cfg)
    line = json.loads(json.dumps(result))
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics",
            "device"} <= set(line)
    assert line["correct"] is True
    assert set(line["metrics"]) == {"library_seds_per_s", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert {"platform", "kind", "count",
            "memory_peak_bytes"} <= set(line["device"])
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit"}
    assert [n for n, _, _ in checks] == list(line["checks"])


def test_traced_result_line_format():
    wl, cfg = _tiny.generate_cell()
    result, _ = _tiny.run("north-star.generate", wl, cfg, trace=True)
    assert list(result)[-1] == "checks"
    assert "library.plan_ms" in result["metrics"]
    assert "setup_s" not in result["metrics"]
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps",
                                        "host_syncs"}
    assert all(len(v) <= 10 for v in result["breakdown"].values())
