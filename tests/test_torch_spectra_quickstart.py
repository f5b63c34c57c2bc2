"""The port's spectroscopic quickstart, `examples/spectra_quickstart_torch.py`,
end to end on the CPU at small size knobs (SYNFERENCE_SPECTRA_N=2000,
SYNFERENCE_SPECTRA_EPOCHS=2): the library of spectra through the
instrument pipeline, the embedding-net NSF, the evaluation, the pass line
and the JSON summary. Below 20 000 spectra the example's TARP rule does not
apply; the metrics are readings: finite and in range."""

import json
import math
import os
import pathlib
import subprocess
import sys

import synference_tpu_torch as tt

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_spectra_quickstart_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, SYNFERENCE_SPECTRA_N="2000",
               SYNFERENCE_SPECTRA_EPOCHS="2",
               # many small ops: one intra-op thread beside the other
               # test workers
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "spectra_quickstart_torch.py"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert "SPECTRA_QUICKSTART_PASS" in lines
    result = json.loads(lines[-1])
    assert result["n_library"] == 2000 and result["epochs"] <= 2
    # the R = 100 grid (two pixels per resolution element) and the norm
    assert result["n_pixels"] == len(
        tt.generate_constant_r_grid(100, 6000.0, 53000.0)) + 1
    assert 0.0 <= result["tarp_deviation"] <= 0.5
    assert len(result["pit_ks"]) == 6
    assert all(0.0 <= v <= 1.0 for v in result["pit_ks"])
    assert math.isfinite(result["best_val_loss"])
    assert math.isfinite(result["z_r2"])
    assert result["device"] == "cpu"


def test_spectra_quickstart_needs_a_card_by_default(tmp_path):
    """--device defaults to cuda: without a card it exits with a message."""
    import torch

    if torch.cuda.is_available():
        return
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "spectra_quickstart_torch.py")],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0 and "no CUDA device" in proc.stderr
