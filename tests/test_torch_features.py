"""Port parity, features: `FeatureConfig`/`FeaturePipeline.build` for the
north-star configuration (asinh units, depth noise, one scatter, error
columns), `DepthNoiseModel`, the flag record (`to_flags` / `from_flags`,
the JAX package's names and values) and `transform_observations`.

The deterministic parts — depth σ, the asinh transform of a flux and the
propagation of its error, the feature column layout — must match the JAX
package to float32 rounding (rtol 1e-6, a few ulp of transcendental
functions). torch and JAX draw different noise, so the noise is checked by
distribution: z = (noisy − clean)/σ over 70,000 draws has |mean| < 0.03
and |std − 1| < 0.02 (≈ 8σ and 5σ of their sampling error).
"""

import jax
import numpy as np
import pytest
import torch

from synference_tpu.features import FeatureConfig as JConfig
from synference_tpu.features import FeaturePipeline as JPipeline
from synference_tpu.noise_models import DepthNoiseModel as JDepth
from synference_tpu_torch import units as tu
from synference_tpu_torch.features import FeatureConfig, FeaturePipeline
from synference_tpu_torch.noise_models import DepthNoiseModel

CODES = ("F090W", "F115W", "F150W", "F200W", "F277W", "F356W", "F444W")
DEPTHS = (29.5, 29.0, 28.7, 29.5, 30.1, 28.0, 29.2)


def _cfg(cls, **kw):
    base = dict(filter_codes=CODES, unit="asinh", depths_ab=DEPTHS,
                n_scatters=1, include_errors=True)
    base.update(kw)
    return cls(**base)


def _phot(n=10_000, seed=0):
    rng = np.random.default_rng(seed)
    return rng.lognormal(1.0, 2.5, (n, len(CODES))).astype(np.float32)


def test_depth_sigma_matches_jax():
    for d in DEPTHS:
        np.testing.assert_allclose(DepthNoiseModel(d, 5.0).sigma_njy,
                                   JDepth(d, 5.0).sigma_njy, rtol=1e-6)


@pytest.mark.parametrize("softening", [5.0, "snr_5", (1.0, 2, 3, 4, 5, 6, 7)])
def test_unit_transform_matches_jax(softening):
    port = FeaturePipeline(_cfg(FeatureConfig, asinh_softening_njy=softening))
    ref = JPipeline(_cfg(JConfig, asinh_softening_njy=softening))
    np.testing.assert_allclose(port._softening, ref._softening, rtol=1e-12)
    flux = _phot(512) - 2.0  # include negative (noisy) fluxes
    sigma = np.broadcast_to(
        np.array([m.sigma_njy for m in port.noise_models.values()],
                 np.float32), flux.shape).copy()
    x, xe = port._to_unit(torch.as_tensor(flux), torch.as_tensor(sigma))
    xr, xer = ref._to_unit(flux, sigma)
    np.testing.assert_allclose(x.numpy(), np.asarray(xr), rtol=1e-6)
    np.testing.assert_allclose(xe.numpy(), np.asarray(xer), rtol=1e-6)


def test_build_layout_and_noise_distribution():
    phot = _phot()
    port = FeaturePipeline(_cfg(FeatureConfig))
    ref = JPipeline(_cfg(JConfig))
    res = port.build(torch.Generator().manual_seed(0), phot,
                     parameters=np.arange(2 * len(phot)).reshape(-1, 2))
    jres = ref.build(jax.random.PRNGKey(0), phot,
                     parameters=np.arange(2 * len(phot)).reshape(-1, 2))
    assert res.feature_names == jres.feature_names
    assert res.features.shape == jres.features.shape == (len(phot), 14)
    np.testing.assert_array_equal(res.source_index, jres.source_index)
    np.testing.assert_array_equal(res.parameters, jres.parameters)
    assert np.isfinite(res.features).all()
    # error columns are deterministic given the noisy flux: invert the
    # asinh transform and re-derive them
    fb = torch.as_tensor(port._softening, dtype=torch.float32)
    x = torch.as_tensor(res.features[:, :7])
    noisy = tu.convert_flux(x, "asinh", "nJy", f_b_njy=fb)
    sig = np.array([m.sigma_njy for m in port.noise_models.values()],
                   np.float32)
    xe = tu.convert_flux_err(noisy, torch.as_tensor(sig).expand_as(noisy),
                             "nJy", "asinh", f_b_njy=fb)
    np.testing.assert_allclose(res.features[:, 7:], xe.numpy(), rtol=1e-4,
                               atol=1e-6)
    z = (noisy.numpy() - phot) / sig
    assert abs(z.mean()) < 0.03, z.mean()
    assert abs(z.std() - 1.0) < 0.02, z.std()


def test_scatters_repeat_rows():
    phot = _phot(300)
    res = FeaturePipeline(_cfg(FeatureConfig, n_scatters=3)).build(
        torch.Generator().manual_seed(1), phot, parameters=phot[:, :2])
    assert res.features.shape == (900, 14)
    np.testing.assert_array_equal(res.source_index, np.tile(np.arange(300), 3))
    np.testing.assert_array_equal(res.parameters, np.tile(phot[:, :2], (3, 1)))
    # independent draws per scatter copy
    assert not np.array_equal(res.features[:300], res.features[300:600])


def test_noise_model_apply():
    m = DepthNoiseModel(29.5, min_flux_error_njy=5.0)
    flux = torch.zeros(50_000)
    noisy, sigma = m.apply(torch.Generator().manual_seed(2), flux)
    assert torch.all(sigma == max(m.sigma_njy, 5.0))
    assert abs(float(noisy.std()) / m.sigma_njy - 1.0) < 0.02


def test_remove_filters_and_unported_options():
    res = FeaturePipeline(_cfg(FeatureConfig, remove_filters=("F115W",))
                          ).build(torch.Generator().manual_seed(0), _phot(64))
    assert res.features.shape == (64, 12)
    assert "F115W" not in res.feature_names
    for kw in (dict(normalize_method="F200W"), dict(missing_fraction=0.1),
               dict(extra_features=("F090W - F200W",)),
               dict(depths_ab=(DEPTHS, DEPTHS))):
        with pytest.raises(NotImplementedError, match="ROADMAP M6"):
            FeaturePipeline(_cfg(FeatureConfig, **kw))


@pytest.mark.parametrize("kw", [
    {}, {"asinh_softening_njy": (1.0, 2, 3, 4, 5, 6, 7), "unit": "AB"},
    {"asinh_softening_njy": "snr_5", "remove_filters": ("F115W",),
     "min_pct_error": 0.05, "n_scatters": 2, "depths_ab": None,
     "include_errors": False}])
def test_flags_are_the_jax_packages(kw):
    if kw.get("asinh_softening_njy") == "snr_5":
        kw = dict(kw, depths_ab=DEPTHS)
    cfg, jcfg = _cfg(FeatureConfig, **kw), _cfg(JConfig, **kw)
    assert cfg.to_flags() == jcfg.to_flags()
    # each package reads the other's record
    assert FeatureConfig.from_flags(jcfg.to_flags()) == cfg
    assert JConfig.from_flags(cfg.to_flags()) == jcfg
    phot = _phot(32)
    res = FeaturePipeline(cfg).build(torch.Generator().manual_seed(0), phot)
    jres = JPipeline(jcfg).build(jax.random.PRNGKey(0), phot)
    assert res.flags == jres.flags
    again = FeaturePipeline.from_flags(jres.flags)
    assert again.config == cfg and again.kept_codes == JPipeline.from_flags(
        res.flags).kept_codes


def test_flags_of_unported_options_raise():
    flags = _cfg(JConfig, normalize_method="F200W").to_flags()
    with pytest.raises(NotImplementedError, match="ROADMAP M6"):
        FeaturePipeline.from_flags(flags)
    flags = _cfg(JConfig, missing_fraction=0.2, include_flags=True).to_flags()
    with pytest.raises(NotImplementedError, match="ROADMAP M6"):
        FeaturePipeline.from_flags(flags)


@pytest.mark.parametrize("unit,flux_unit", [("asinh", "nJy"), ("AB", "nJy"),
                                            ("asinh", "Jy"), ("nJy", "AB")])
def test_transform_observations_matches_jax(unit, flux_unit):
    kw = dict(unit=unit, remove_filters=("F150W",), min_pct_error=0.03)
    port = FeaturePipeline(_cfg(FeatureConfig, **kw))
    ref = JPipeline(_cfg(JConfig, **kw))
    flux = _phot(200) + 0.5
    err = 0.1 * flux + 0.2
    if flux_unit == "Jy":
        flux, err = flux * 1e-9, err * 1e-9
    elif flux_unit == "AB":
        flux, err = 31.4 - 2.5 * np.log10(flux), 0.1 + 0 * flux
    out = port.transform_observations(flux, err, flux_unit, device="cpu")
    want = ref.transform_observations(flux, err, flux_unit)
    assert out.shape == want.shape == (200, 12)
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=1e-6)
    # without errors: photometry columns only
    out = port.transform_observations(flux, None, flux_unit, device="cpu")
    np.testing.assert_allclose(
        out, ref.transform_observations(flux, None, flux_unit), rtol=2e-5,
        atol=1e-6)
    with pytest.raises(NotImplementedError, match="ROADMAP M6"):
        port.transform_observations(flux, err, flux_unit,
                                    missing_mask=np.zeros_like(flux),
                                    device="cpu")
