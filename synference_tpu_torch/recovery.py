"""SED recovery: push posterior draws back through the forward model.

Counterpart of `synference_tpu/recovery.py`: the posterior draws of one
object go through the simulator's dense path with spectra in one batch, and
the recovered f_ν, photometry and star-formation history are summarized by
quantiles on the host.
"""

from __future__ import annotations

import numpy as np

__all__ = ["recover_sed"]


def recover_sed(simulator, samples: np.ndarray, quantiles=(0.16, 0.5, 0.84),
                want_sfh: bool = True, max_draws: int = 256) -> dict:
    """Forward-model posterior draws into SED / photometry / SFH bands.

    Args:
        simulator: BatchSEDSimulator whose param_names match the sample
            columns.
        samples: (S, P) posterior draws for one object.
        quantiles: summary quantiles for the bands.
        want_sfh: also summarize the per-age-bin masses.
        max_draws: cap on forwarded draws (cost control).
    Returns:
        dict with "lam" (L,) observed-frame wavelengths [Å] (the rest grid
        times the draws' mean 1+z; quantiles are taken at fixed rest index),
        "lam_rest", "fnu_quantiles" (Q, L) [nJy], "photometry_quantiles"
        (Q, F) [nJy], "quantiles", "filter_codes", and with `want_sfh`
        "sfh_quantiles" (Q, A) [Msun] and "ages_yr" (A,).
    """
    samples = np.asarray(samples, np.float32)
    if samples.ndim != 2:
        raise ValueError("samples must be (S, P)")
    draws = samples[:max_draws]
    out = simulator.simulate(draws, want_spectra=True)
    fnu = out["fnu_njy"].cpu().numpy()
    phot = out["photometry_njy"].cpu().numpy()
    lam_rest = np.asarray(simulator.grid.lam)
    zp1 = 1.0
    if "redshift" in simulator.param_names:
        zc = draws[:, list(simulator.param_names).index("redshift")]
        zp1 = float(np.mean(1.0 + np.maximum(zc, 0.0)))
    result = {
        "lam": lam_rest * zp1,
        "lam_rest": lam_rest,
        "fnu_quantiles": np.quantile(fnu, quantiles, axis=0),
        "photometry_quantiles": np.quantile(phot, quantiles, axis=0),
        "quantiles": list(quantiles),
        "filter_codes": list(simulator.filters.codes),
    }
    if want_sfh:
        result["sfh_quantiles"] = np.quantile(
            out["sfh_mass"].cpu().numpy(), quantiles, axis=0)
        result["ages_yr"] = np.asarray(simulator.grid.ages_yr)
    return result
