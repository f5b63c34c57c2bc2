"""The port's quickstart, `examples/quickstart_torch.py`, end to end on the
CPU at its size knobs' small values (SYNFERENCE_QUICKSTART_N=512,
SYNFERENCE_QUICKSTART_EPOCHS=2): the library with supplementary quantities
written to HDF5 and read back by `SBIFitter.init_from_hdf5`, features, NSF
50 × 8 training, evaluation and the 50-object catalogue fit run, and the
last line is the results JSON. At two epochs the calibration is a reading,
not a gate: the metrics are finite and in range."""

import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_quickstart_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, SYNFERENCE_QUICKSTART_N="512",
               SYNFERENCE_QUICKSTART_EPOCHS="2")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "quickstart_torch.py"),
         "--device", "cpu", "--out-dir", str(tmp_path)], cwd=tmp_path,
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["n_library"] == 512 and result["epochs"] <= 2
    assert result["hdf5"] and (tmp_path / "quickstart_library.h5").exists()
    assert (tmp_path / "quickstart_model.pkl").exists()
    assert 0.0 <= result["tarp_deviation"] <= 0.5
    assert all(0.0 <= v <= 1.0 for v in result["pit_ks"])
    assert len(result["pit_ks"]) == 6
    assert math.isfinite(result["redshift_r"])
    assert math.isfinite(result["best_val_loss"])
    assert result["device"] == "cpu"
