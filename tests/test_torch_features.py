"""Port parity, features: `FeatureConfig`/`FeaturePipeline.build` against
the JAX package: the north-star configuration (asinh units, depth noise,
one scatter, error columns), `DepthNoiseModel`, the flag record
(`to_flags` / `from_flags`, the JAX package's names and values),
`transform_observations`, and the rest of the configuration:
normalisation (by a filter, a parameter or a supplementary column, with
`norm_unit`), missing bands (`missing_fraction`, `missing_flux_options`,
`missing_value`) with flag columns, filter-arithmetic and named extra
features, the fitted θ columns (`remove_parameters`, `add_parameters`,
`parameter_transforms`) and multi-set depths.

The deterministic parts — depth σ, the asinh transform of a flux and the
propagation of its error, normalisation, the feature column layout, extra
features and θ transforms — must match the JAX package to float32 rounding
(rtol 1e-6, a few ulp of transcendental functions; 2e-5 where a
conversion from Jy or AB runs first, as before). torch and JAX draw
different noise, so the noise is checked by distribution: z = (noisy −
clean)/σ over 70,000 draws has |mean| < 0.03 and |std − 1| < 0.02 (≈ 8σ
and 5σ of their sampling error). Missing-band masks and depth-set choices
are drawn in the test the way the JAX package draws them from its key and
passed to the port as arrays, so both packages see the same masks.
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
    """Every option of the JAX package's configuration is ported: none is
    reported unported and each builds."""
    res = FeaturePipeline(_cfg(FeatureConfig, remove_filters=("F115W",))
                          ).build(torch.Generator().manual_seed(0), _phot(64))
    assert res.features.shape == (64, 12)
    assert "F115W" not in res.feature_names
    for kw in (dict(normalize_method="F200W"), dict(missing_fraction=0.1),
               dict(extra_features=("F090W - F200W",)),
               dict(depths_ab=(DEPTHS, DEPTHS))):
        cfg = _cfg(FeatureConfig, **kw)
        assert cfg.unported_fields() == []
        res = FeaturePipeline(cfg).build(torch.Generator().manual_seed(0),
                                         _phot(64))
        assert np.isfinite(res.features).all()


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
    """Flag records with normalisation or missing bands, which the port
    refused before they were ported, now replay: the same pipeline as the
    JAX package's record describes."""
    for kw in (dict(normalize_method="F200W"),
               dict(missing_fraction=0.2, include_flags=True)):
        flags = _cfg(JConfig, **kw).to_flags()
        pipe = FeaturePipeline.from_flags(flags)
        assert pipe.config == _cfg(FeatureConfig, **kw)
        assert pipe.config.to_flags() == flags


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
    mask = (np.random.default_rng(1).uniform(size=flux.shape) < 0.2
            ).astype(np.float32)
    np.testing.assert_allclose(
        port.transform_observations(flux, err, flux_unit, missing_mask=mask,
                                    device="cpu"),
        ref.transform_observations(flux, err, flux_unit, missing_mask=mask),
        rtol=2e-5, atol=1e-6)


# -- the rest of the configuration, against the JAX package ------------------
PNAMES = ("log10_mass", "redshift", "tau_v")
SNAMES = ("ref_flux", "sfr_100")


def _library(n=256, seed=3):
    rng = np.random.default_rng(seed)
    phot = _phot(n, seed)
    params = np.stack([rng.uniform(8, 11, n), rng.uniform(0.1, 6, n),
                       rng.uniform(0, 2, n)], axis=1).astype(np.float32)
    supp = np.stack([rng.lognormal(3.0, 1.0, n), rng.uniform(0.1, 10, n)],
                    axis=1).astype(np.float32)
    return phot, params, supp


def _jax_masks(cfg, key, rows, n_cols):
    """The missing-band mask the JAX package draws from `key`."""
    _, k_missing = jax.random.split(key)
    if cfg.missing_flux_options:
        opts = np.asarray(cfg.missing_flux_options, np.float32)
        if cfg.normalize_method in cfg.filter_codes:
            opts = np.delete(opts, list(cfg.filter_codes).index(
                cfg.normalize_method), axis=1)
        choice = np.asarray(jax.random.randint(k_missing, (rows,), 0,
                                               opts.shape[0]))
        return opts[choice]
    return np.asarray(jax.random.uniform(k_missing, (rows, n_cols))
                      < cfg.missing_fraction).astype(np.float32)


def _both(kw, n_scatters=1, **build):
    """Build features in both packages on the same library and masks."""
    phot, params, supp = _library()
    kw = dict(dict(depths_ab=None, n_scatters=n_scatters), **kw)
    cfg, jcfg = _cfg(FeatureConfig, **kw), _cfg(JConfig, **kw)
    key = jax.random.PRNGKey(5)
    args = dict(parameters=params, parameter_names=PNAMES,
                supplementary=supp, supplementary_names=SNAMES)
    kept = [c for c in CODES if c not in cfg.remove_filters]
    n_cols = len(kept) - (cfg.normalize_method in kept)
    if cfg.missing_fraction or cfg.missing_flux_options:
        build["missing_mask"] = _jax_masks(cfg, key, len(phot) * n_scatters,
                                           n_cols)
    res = FeaturePipeline(cfg).build(torch.Generator().manual_seed(0), phot,
                                     **args, **build)
    jres = JPipeline(jcfg).build(key, phot, **args)
    return res, jres


@pytest.mark.parametrize("kw", [
    dict(normalize_method="F200W"),
    dict(normalize_method="F200W", unit="nJy", norm_unit="AB"),
    dict(normalize_method="ref_flux"),
    dict(normalize_method="ref_flux", unit="nJy"),
    dict(normalize_method="log10_mass", unit="nJy", norm_unit="nJy"),
    dict(missing_fraction=0.2, include_flags=True),
    dict(missing_fraction=0.2, include_flags=True, missing_value=-9.0,
         normalize_method="F150W"),
    dict(missing_flux_options=((0, 0, 0, 0, 0, 0, 1), (1, 0, 0, 0, 0, 0, 0),
                               (0, 0, 0, 0, 0, 0, 0)), include_flags=True),
    dict(extra_features=("F090W - F200W", "redshift", "sfr_100",
                         "(F277W + F356W) / 2")),
    dict(remove_parameters=("redshift",), add_parameters=("sfr_100",),
         parameter_transforms=(("sfr_100", "log10"), ("tau_v", "sqrt"))),
    dict(normalize_method="F444W", missing_fraction=0.3, include_flags=True,
         extra_features=("F090W - F150W", "redshift"),
         remove_filters=("F115W",), parameter_transforms=(
             ("log10_mass", "pow10"),), min_pct_error=0.05),
])
def test_build_options_match_jax(kw):
    """Without noise (no depths) every feature column is deterministic:
    1e-6 relative, and 1e-5 absolute for magnitude-space columns (a
    difference of two ~25 mag values keeps their few-ulp absolute error).
    Scatter copies (n_scatters=2) tile the named columns."""
    res, jres = _both(kw, n_scatters=2)
    assert res.feature_names == jres.feature_names
    assert res.parameter_names == jres.parameter_names
    assert res.flags == jres.flags
    np.testing.assert_array_equal(res.source_index, jres.source_index)
    np.testing.assert_allclose(res.features, jres.features, rtol=1e-6,
                               atol=1e-5)
    np.testing.assert_allclose(res.parameters, jres.parameters, rtol=1e-6)


def test_missing_bands_with_errors_and_flags():
    """Missing bands set flux and error columns to `missing_value` and flag
    them; with depth noise the error columns (unit nJy: σ itself) match."""
    kw = dict(unit="nJy", depths_ab=DEPTHS, missing_fraction=0.25,
              include_flags=True)
    phot = _phot(2000)
    cfg, jcfg = _cfg(FeatureConfig, **kw), _cfg(JConfig, **kw)
    key = jax.random.PRNGKey(1)
    mask = _jax_masks(cfg, key, 2000, 7)
    res = FeaturePipeline(cfg).build(torch.Generator().manual_seed(0), phot,
                                     missing_mask=mask)
    jres = JPipeline(jcfg).build(key, phot)
    assert res.feature_names == jres.feature_names
    f, jf = res.features, jres.features
    np.testing.assert_array_equal(f[:, 14:], jf[:, 14:])  # flags
    np.testing.assert_array_equal(f[:, :14] == 99.0, jf[:, :14] == 99.0)
    np.testing.assert_allclose(f[:, 7:14], jf[:, 7:14], rtol=1e-6)
    assert abs(mask.mean() - 0.25) < 0.02


def test_drawn_masks_follow_the_configuration():
    """Masks the port draws itself: the right fraction, or only the preset
    options."""
    phot = _phot(4000)
    res = FeaturePipeline(_cfg(FeatureConfig, depths_ab=None,
                               missing_fraction=0.3, include_flags=True)
                          ).build(torch.Generator().manual_seed(0), phot)
    flags = res.features[:, 7:]
    assert abs(flags.mean() - 0.3) < 0.02
    opts = ((0, 1, 0, 0, 0, 0, 1), (0, 0, 0, 0, 0, 0, 0))
    res = FeaturePipeline(_cfg(FeatureConfig, depths_ab=None,
                               missing_flux_options=opts, include_flags=True)
                          ).build(torch.Generator().manual_seed(0), phot)
    rows = {tuple(r) for r in res.features[:, 7:].astype(int)}
    assert rows == set(opts)


def test_multi_set_depths_match_jax():
    """2-D depths: one set per row; with the set choices passed in, σ (the
    error columns in nJy) matches at 1e-6, the noise by distribution, and
    the snr softening is the mean over sets."""
    sets = (DEPTHS, tuple(d - 1.0 for d in DEPTHS), tuple(d + 0.5
                                                          for d in DEPTHS))
    kw = dict(unit="nJy", depths_ab=sets, n_scatters=2)
    cfg, jcfg = _cfg(FeatureConfig, **kw), _cfg(JConfig, **kw)
    phot = _phot(5000)
    key = jax.random.PRNGKey(2)
    k_scatter, _ = jax.random.split(key)
    k_set, _ = jax.random.split(k_scatter)
    choice = np.asarray(jax.random.randint(k_set, (10000,), 0, 3))
    port = FeaturePipeline(cfg)
    res = port.build(torch.Generator().manual_seed(0), phot,
                     depth_set=choice)
    jres = JPipeline(jcfg).build(key, phot)
    np.testing.assert_allclose(res.features[:, 7:], jres.features[:, 7:],
                               rtol=1e-6)
    z = (res.features[:, :7] - np.tile(phot, (2, 1))) / res.features[:, 7:]
    assert abs(z.mean()) < 0.03 and abs(z.std() - 1.0) < 0.02
    soft = _cfg(FeatureConfig, depths_ab=sets, asinh_softening_njy="snr_5")
    np.testing.assert_allclose(
        FeaturePipeline(soft)._softening,
        JPipeline(_cfg(JConfig, depths_ab=sets,
                       asinh_softening_njy="snr_5"))._softening, rtol=1e-12)
    drawn = port.build(torch.Generator().manual_seed(0), phot)
    counts = np.unique(drawn.features[:, 7], return_counts=True)[1]
    assert len(counts) == 3 and counts.min() > 3000


@pytest.mark.parametrize("kw", [
    dict(normalize_method="F200W", missing_fraction=0.2, include_flags=True,
         extra_features=("F090W - F150W",)),
    dict(normalize_method="ref_flux", extra_features=("redshift",
                                                      "F150W - F444W")),
    dict(normalize_method="ref_flux", unit="nJy", missing_flux_options=(
        (1, 0, 0, 0, 0, 0, 0), (0, 0, 0, 0, 0, 0, 0)), include_flags=True),
])
def test_records_replay_on_observations_both_ways(kw):
    """A flag record written by either package rebuilds the pipeline in the
    other; replaying it on a catalogue (missing mask, named extra values,
    norm values) gives the same features, 2e-5 relative."""
    phot, params, supp = _library(200, seed=7)
    err = 0.1 * phot + 0.3  # the training features hold no error columns
    res, jres = _both(kw)
    mask = (np.random.default_rng(2).uniform(size=phot.shape) < 0.15
            ).astype(np.float32)
    extra = {"redshift": params[:, 1]}
    norm = supp[:, 0] if kw["normalize_method"] == "ref_flux" else None
    port = FeaturePipeline.from_flags(jres.flags)
    ref = JPipeline.from_flags(res.flags)
    out = port.transform_observations(phot, None, "nJy", missing_mask=mask,
                                      extra_values=extra, norm_values=norm,
                                      device="cpu")
    want = ref.transform_observations(phot, None, "nJy", missing_mask=mask,
                                      extra_values=extra, norm_values=norm)
    assert out.shape == want.shape
    assert out.shape[1] == res.features.shape[1]
    np.testing.assert_allclose(out, want, rtol=2e-5, atol=1e-5)
    if norm is not None:
        with pytest.raises(ValueError, match="norm_values"):
            port.transform_observations(phot, err, "nJy", device="cpu",
                                        extra_values=extra)
    if "redshift" in kw.get("extra_features", ()):
        with pytest.raises(ValueError, match="extra_values"):
            port.transform_observations(phot, err, "nJy", device="cpu",
                                        norm_values=norm)


def test_option_errors():
    phot, params, supp = _library(16)
    args = dict(parameters=params, parameter_names=PNAMES,
                supplementary=supp, supplementary_names=SNAMES)
    gen = torch.Generator().manual_seed(0)
    for kw, match in ((dict(normalize_method="nope"), "neither a filter"),
                      (dict(add_parameters=("nope",)), "add_parameters"),
                      (dict(parameter_transforms=(("tau_v", "cube"),)),
                       "unknown parameter transform"),
                      (dict(normalize_method="redshift"), "flux in nJy")):
        pipe = FeaturePipeline(_cfg(FeatureConfig, depths_ab=None, **kw))
        with pytest.raises(ValueError, match=match):
            pipe.build(gen, phot - (100 if "redshift" in str(kw) else 0),
                       **(args if "redshift" not in str(kw) else dict(
                           args, parameters=params - 20)))
