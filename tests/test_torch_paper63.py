"""The port's paper-63 twin, `examples/paper63_e2e_torch.py`, end to end on
the CPU at tiny knobs: the script's `main` on a 24 × 4 × 512 synthetic grid
(the twin's own grid is 64 × 12 × 10⁴ λ) with all 63 survey curves, 200
rows, 2 epochs of NSF 69 × 15 with 2 members. At this depth the calibration
is a reading, not a gate: every metric finite, 126 feature dimensions, the
result JSON the last line of stdout."""

import contextlib
import importlib.util
import io
import json
import math
import pathlib

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """One intra-op thread while this module runs: beside the other test
    workers torch's default pool oversubscribes the cores, and its many
    small ops then run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_paper63_twin_runs_on_the_cpu(tmp_path):
    import synference_tpu_torch as tt

    spec = importlib.util.spec_from_file_location(
        "paper63_e2e_torch", ROOT / "examples" / "paper63_e2e_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    grid = tt.make_synthetic_grid(n_ages=24, n_mets=4, n_wav=512,
                                  lam_min=150.0)
    out = tmp_path / "result.json"
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = twin.main(200, str(out), "cpu", grid=grid, max_epochs=2,
                           n_nets=2, stop_after=2)
    assert json.loads(buf.getvalue().strip().splitlines()[-1]) == result
    assert json.loads(out.read_text()) == result
    assert result["n_filters"] == 63 and result["feature_dim"] == 126
    assert result["epochs"] == 2 and result["n_members"] == 2
    # this grid's windows span the whole table: the dense route, no K1
    assert result["k1_launches"] == 0
    assert math.isfinite(result["tarp_deviation"])
    assert len(result["r2"]) == 6 and len(result["tarp_ci"]["per_member"]) == 2
    assert result["pass"] == (result["tarp_deviation"] < 0.05)
    assert twin.survey_depths(["JWST/NIRCam.F444W", "HSC.g"]) == (29.0, 26.0)
