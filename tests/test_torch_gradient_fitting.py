"""The port's gradient-fitting twin, `examples/gradient_fitting_torch.py`,
end to end on the CPU at small knobs (30 MAP steps; HMC 10 warmup, 16
samples per chain, 3 leapfrog): the Fisher forecast, the catalogue MAP with
Laplace σ and the HMC of object 0 run, and the last line is the results
JSON. At these step counts the fits are readings, not gates: every number
is finite, the Cramér–Rao bounds positive, the acceptance in (0, 1]."""

import json
import math
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_gradient_fitting_runs_on_the_cpu(tmp_path):
    env = dict(os.environ, SYNFERENCE_GRADFIT_MAP_STEPS="30",
               SYNFERENCE_GRADFIT_WARMUP="10",
               SYNFERENCE_GRADFIT_SAMPLES="16",
               SYNFERENCE_GRADFIT_LEAPFROG="3",
               # thousands of small ops: one intra-op thread beside the
               # other test workers
               OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "gradient_fitting_torch.py"),
         "--device", "cpu"], cwd=tmp_path, env=env, capture_output=True,
        text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["device"] == "cpu" and result["map_steps"] == 30
    assert result["hmc_steps"] == [10, 16, 3]
    assert all(v > 0 for v in result["cramer_rao_median"])
    for key in ("map_residual_abs_max", "laplace_sigma_median", "hmc_median",
                "hmc_std", "hmc_width_over_cramer_rao"):
        assert len(result[key]) == 2
        assert all(math.isfinite(v) for v in result[key]), key
    assert 0.0 < result["hmc_acceptance"] <= 1.0
    assert 8.0 <= result["hmc_median"][0] <= 11.0
