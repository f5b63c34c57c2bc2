"""Photometric and spectroscopic uncertainty models on torch tensors.

Counterpart of `synference_tpu/noise_models.py`: every model has
`apply(generator, flux_njy, draws=None) -> (noisy_flux_njy, sigma_njy)`,
all in nJy, on the flux's device. Its random numbers come from an explicit
`torch.Generator`, or are passed in as `draws`, a dict of tensors of the
flux's shape named as in the model's `DRAWS` ("u" uniforms in [0, 1) for the
truncated-normal σ, "g"/"g3" standard normals, "u3" a second σ draw), so a
test can feed both packages the same numbers.

Models whose native space is not nJy (asinh magnitudes, AB) scatter there
and convert back. Fitting from an observed catalogue (binned median/std of
errors against flux, `fit_binned_error_model`) runs on the host in numpy at
construction; the unit conversions before it round to float32 as the JAX
package's do. The σ tables are moved to the flux's device on first use.

HDF5 (de)serialisation keeps the `__class__`-keyed group layout with the
reference's class-name aliases (`MODEL_CLASS_REGISTRY`), so model files
written by either package load in the other.
"""

from __future__ import annotations

import numpy as np
import torch

from . import units as U

__all__ = [
    "NoiseModel",
    "DepthNoiseModel",
    "SpectralNoiseModel",
    "EmpiricalNoiseModel",
    "AsinhEmpiricalNoiseModel",
    "GeneralEmpiricalNoiseModel",
    "MODEL_CLASS_REGISTRY",
    "save_noise_model_hdf5",
    "load_noise_model_hdf5",
    "fit_binned_error_model",
    "create_noise_models_from_catalogue",
]


# ---------------------------------------------------------------------------
# shared numerics
# ---------------------------------------------------------------------------


def _truncnorm_nonneg(u01, mu, sigma):
    """σ' ~ N(mu, sigma) truncated to σ' ≥ 0 by inverse CDF at the uniforms
    `u01` (the JAX package's `uniform(minval=Φ(−mu/sigma), maxval=1)`)."""
    sigma_safe = torch.clamp(sigma, min=1.0e-12)
    lo = torch.special.ndtr(-mu / sigma_safe)
    u = torch.maximum(lo, u01 * (1.0 - lo) + lo)
    u = torch.clamp(u, 1.0e-7, 1.0 - 1.0e-7)
    out = mu + sigma_safe * torch.special.ndtri(u)
    return torch.where(sigma > 1.0e-12, torch.clamp(out, min=0.0), mu)


def _interp(x, xp, fp):
    """`jnp.interp(x, xp, fp)` for any-shaped x on 1-D knots: linear, clamped
    to the end values outside them."""
    xf = x.reshape(-1)
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, xf.contiguous(), right=True), 1,
                    n - 1)
    dx = xp[i] - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1], fp[i - 1] + ((xf - xp[i - 1])
                                                 / torch.where(dx0, 1.0, dx))
                    * (fp[i] - fp[i - 1]))
    f = torch.where(xf < xp[0], fp[0], f)
    f = torch.where(xf > xp[-1], fp[-1], f)
    return f.reshape(x.shape)


def fit_binned_error_model(fluxes: np.ndarray, errors: np.ndarray,
                           num_bins: int = 20, log_bins: bool = True,
                           min_samples_per_bin: int = 10,
                           precomputed_bins: np.ndarray | None = None):
    """Binned median/std of errors against flux (host numpy, float64);
    returns (bin centres, median, std) over the bins holding at least
    `min_samples_per_bin` sources."""
    fluxes = np.asarray(fluxes, dtype=np.float64)
    errors = np.asarray(errors, dtype=np.float64)
    valid = np.isfinite(fluxes) & np.isfinite(errors)
    f, e = fluxes[valid], errors[valid]
    if precomputed_bins is not None:
        bins = np.asarray(precomputed_bins)
    elif log_bins:
        pos = f > 0
        if not pos.any():
            raise ValueError("Log-binning requires positive flux values.")
        bins = np.logspace(np.log10(f[pos].min()), np.log10(f.max()),
                           num_bins + 1)
    else:
        bins = np.linspace(f.min(), f.max(), num_bins + 1)
    idx = np.clip(np.digitize(f, bins) - 1, 0, len(bins) - 2)
    centers, med, std = [], [], []
    for i in range(len(bins) - 1):
        sel = idx == i
        if sel.sum() >= min_samples_per_bin:
            centers.append(0.5 * (bins[i] + bins[i + 1]))
            med.append(np.median(e[sel]))
            std.append(np.std(e[sel]))
    if len(centers) < 2:
        raise ValueError("Could not create enough valid bins for interpolation.")
    return np.asarray(centers), np.asarray(med), np.asarray(std)


# ---------------------------------------------------------------------------
# model classes
# ---------------------------------------------------------------------------


class NoiseModel:
    """Interface: `apply(generator, flux_njy, draws=None) -> (noisy_flux_njy,
    sigma_njy)`; `DRAWS` names the random inputs, in the order `apply` draws
    them from the generator."""

    DRAWS: tuple = ()

    def _draws(self, generator, like, draws):
        """The named draws: given, or drawn from `generator` in `DRAWS`
        order (uniforms for names starting with "u", normals else)."""
        if draws is not None:
            return {k: (draws[k] if isinstance(draws[k], torch.Tensor)
                        else torch.tensor(np.asarray(draws[k]))).to(
                            dtype=like.dtype, device=like.device)
                    for k in self.DRAWS}
        out = {}
        for k in self.DRAWS:
            fn = torch.rand if k.startswith("u") else torch.randn
            out[k] = fn(like.shape, generator=generator, dtype=like.dtype,
                        device=like.device)
        return out

    def apply(self, generator, flux_njy, draws=None):
        raise NotImplementedError

    def serialize_to_hdf5(self, group) -> None:
        raise NotImplementedError

    @classmethod
    def _from_hdf5_group(cls, group) -> "NoiseModel":
        raise NotImplementedError


class DepthNoiseModel(NoiseModel):
    """Gaussian noise at a fixed survey depth: σ = flux(depth_ab) /
    depth_sigma_level, clipped to [min, max] flux error (nJy)."""

    DRAWS = ("g",)

    def __init__(self, depth_ab: float, depth_sigma_level: float = 5.0,
                 min_flux_error_njy: float = 0.0,
                 max_flux_error_njy: float = np.inf):
        self.depth_ab = float(depth_ab)
        self.depth_sigma_level = float(depth_sigma_level)
        self.sigma_njy = float(U.ab_depth_to_sigma_njy(depth_ab,
                                                       depth_sigma_level))
        self.min_flux_error_njy = float(min_flux_error_njy)
        self.max_flux_error_njy = float(max_flux_error_njy)

    def apply(self, generator, flux_njy, draws=None):
        g = self._draws(generator, flux_njy, draws)["g"]
        sigma = torch.clamp(torch.full_like(flux_njy, self.sigma_njy),
                            self.min_flux_error_njy, self.max_flux_error_njy)
        return flux_njy + self.sigma_njy * g, sigma

    def serialize_to_hdf5(self, group):
        group.attrs["__class__"] = "DepthNoiseModel"
        group.attrs["depth_ab"] = self.depth_ab
        group.attrs["depth_sigma_level"] = self.depth_sigma_level
        group.attrs["min_flux_error_njy"] = self.min_flux_error_njy
        group.attrs["max_flux_error_njy"] = self.max_flux_error_njy

    @classmethod
    def _from_hdf5_group(cls, group):
        a = group.attrs
        return cls(depth_ab=float(a["depth_ab"]),
                   depth_sigma_level=float(a["depth_sigma_level"]),
                   min_flux_error_njy=float(a.get("min_flux_error_njy", 0.0)),
                   max_flux_error_njy=float(a.get("max_flux_error_njy",
                                                  np.inf)))


class _Tables:
    """numpy float32 tables, as tensors on the device asked for (cached)."""

    def _table(self, name: str, device):
        cache = self.__dict__.setdefault("_on_device", {})
        key = (name, str(device))
        if key not in cache:
            cache[key] = torch.as_tensor(getattr(self, name), device=device)
        return cache[key]


class SpectralNoiseModel(NoiseModel, _Tables):
    """Per-pixel Gaussian noise from a fixed error kernel (L,) in nJy."""

    DRAWS = ("g",)

    def __init__(self, error_kernel_njy: np.ndarray):
        self.error_kernel_njy = np.asarray(error_kernel_njy, np.float32)

    def apply(self, generator, flux_njy, draws=None):
        g = self._draws(generator, flux_njy, draws)["g"]
        kern = self._table("error_kernel_njy", flux_njy.device)
        return flux_njy + kern * g, kern.expand(flux_njy.shape)

    def serialize_to_hdf5(self, group):
        group.attrs["__class__"] = "SpectralNoiseModel"
        group.create_dataset("error_kernel_njy", data=self.error_kernel_njy)

    @classmethod
    def _from_hdf5_group(cls, group):
        return cls(error_kernel_njy=group["error_kernel_njy"][:])


class EmpiricalNoiseModel(NoiseModel, _Tables):
    """p(σ | flux) learned from a real catalogue in nJy: per-flux median σ
    and std(σ) interpolated over bin centres, σ drawn from a truncated
    normal, then Gaussian scatter."""

    DRAWS = ("u", "g")

    def __init__(self, bin_centers, median_error_in_bin, std_error_in_bin,
                 num_bins: int = 20, log_bins: bool = True,
                 min_samples_per_bin: int = 10):
        self.bin_centers = np.asarray(bin_centers, np.float32)
        self.median_error_in_bin = np.asarray(median_error_in_bin, np.float32)
        self.std_error_in_bin = np.asarray(std_error_in_bin, np.float32)
        self.num_bins = num_bins
        self.log_bins = log_bins
        self.min_samples_per_bin = min_samples_per_bin

    @classmethod
    def from_catalogue(cls, fluxes_njy, errors_njy, num_bins=20,
                       log_bins=True, min_samples_per_bin=10):
        c, m, s = fit_binned_error_model(fluxes_njy, errors_njy, num_bins,
                                         log_bins, min_samples_per_bin)
        return cls(c, m, s, num_bins, log_bins, min_samples_per_bin)

    def _at(self, name, x):
        return _interp(x, self._table("bin_centers", x.device),
                       self._table(name, x.device))

    def sigma_mean_std(self, flux):
        """The interpolated median σ and std(σ) (≥ 0) at `flux`."""
        return (self._at("median_error_in_bin", flux),
                torch.clamp(self._at("std_error_in_bin", flux), min=0.0))

    def sample_uncertainty(self, u01, flux):
        mu, sd = self.sigma_mean_std(flux)
        return _truncnorm_nonneg(u01, mu, sd)

    def apply(self, generator, flux_njy, draws=None):
        d = self._draws(generator, flux_njy, draws)
        sigma = self.sample_uncertainty(d["u"], flux_njy)
        return flux_njy + sigma * d["g"], sigma

    def serialize_to_hdf5(self, group):
        group.attrs["__class__"] = type(self).__name__
        group.attrs["num_bins"] = self.num_bins
        group.attrs["log_bins"] = self.log_bins
        group.attrs["min_samples_per_bin"] = self.min_samples_per_bin
        for name in ("bin_centers", "median_error_in_bin",
                     "std_error_in_bin"):
            group.create_dataset(name, data=getattr(self, name))

    @staticmethod
    def _base_kwargs(group) -> dict:
        a = group.attrs
        return dict(bin_centers=group["bin_centers"][:],
                    median_error_in_bin=group["median_error_in_bin"][:],
                    std_error_in_bin=group["std_error_in_bin"][:],
                    num_bins=int(a.get("num_bins", 20)),
                    log_bins=bool(a.get("log_bins", True)),
                    min_samples_per_bin=int(a.get("min_samples_per_bin", 10)))

    @classmethod
    def _from_hdf5_group(cls, group):
        return EmpiricalNoiseModel(**cls._base_kwargs(group))


class AsinhEmpiricalNoiseModel(EmpiricalNoiseModel):
    """Empirical model in asinh ("luptitude") space, which holds negative
    and low-SNR fluxes: softening b = asinh_b_factor × median(catalogue
    error); the interpolators live in asinh magnitudes. `apply` converts
    nJy -> asinh, scatters there and converts back. With error_type other
    than "empirical" the reported σ is drawn again at the noisy magnitude."""

    DRAWS = ("u", "g", "u3")

    def __init__(self, bin_centers, median_error_in_bin, std_error_in_bin,
                 b_njy: float, error_type: str = "empirical", **kw):
        super().__init__(bin_centers, median_error_in_bin, std_error_in_bin,
                         **kw)
        self.b_njy = float(b_njy)
        self.error_type = error_type

    @classmethod
    def from_catalogue(cls, fluxes_njy, errors_njy, asinh_b_factor=5.0,
                       error_type="empirical", num_bins=20,
                       min_samples_per_bin=10, **kw):
        fluxes_njy = np.asarray(fluxes_njy)
        errors_njy = np.asarray(errors_njy)
        valid = np.isfinite(fluxes_njy) & np.isfinite(errors_njy)
        b_njy = asinh_b_factor * np.median(errors_njy[valid])
        b_jy = b_njy * U.NJY_IN_JY
        f_jy = fluxes_njy[valid] * U.NJY_IN_JY
        mag = U.f_jy_to_asinh(f_jy, b_jy).numpy()
        mag_err = U.f_jy_err_to_asinh(
            f_jy, errors_njy[valid] * U.NJY_IN_JY, b_jy).numpy()
        c, m, s = fit_binned_error_model(mag, mag_err, num_bins,
                                         log_bins=False,
                                         min_samples_per_bin=min_samples_per_bin)
        return cls(c, m, s, b_njy=b_njy, error_type=error_type,
                   num_bins=num_bins, log_bins=False,
                   min_samples_per_bin=min_samples_per_bin)

    def apply(self, generator, flux_njy, draws=None):
        d = self._draws(generator, flux_njy, draws)
        b_jy = self.b_njy * U.NJY_IN_JY
        mag = U.f_jy_to_asinh(flux_njy * U.NJY_IN_JY, b_jy)
        sig_mag = self.sample_uncertainty(d["u"], mag)
        noisy_mag = mag + sig_mag * d["g"]
        final_sig = (sig_mag if self.error_type == "empirical"
                     else self.sample_uncertainty(d["u3"], noisy_mag))
        return (U.asinh_to_f_jy(noisy_mag, b_jy) / U.NJY_IN_JY,
                U.asinh_err_to_f_jy_err(noisy_mag, final_sig, b_jy)
                / U.NJY_IN_JY)

    def serialize_to_hdf5(self, group):
        super().serialize_to_hdf5(group)
        group.attrs["b_njy"] = self.b_njy
        group.attrs["error_type"] = self.error_type

    @classmethod
    def _from_hdf5_group(cls, group):
        return cls(b_njy=float(group.attrs["b_njy"]),
                   error_type=str(group.attrs.get("error_type", "empirical")),
                   **cls._base_kwargs(group))


class GeneralEmpiricalNoiseModel(EmpiricalNoiseModel):
    """The most featured empirical model, with upper limits.

    Interpolation space is AB magnitudes or nJy (`interpolation_unit`).
    With `upper_limits`, sources whose SNR before or after scattering falls
    below `treat_as_upper_limits_below` get their flux replaced per
    `upper_limit_flux_behaviour` ("scatter_limit", "upper_limit" or a number
    in interpolation units) and their σ per `upper_limit_flux_err_behaviour`
    ("flux", "upper_limit", "sig_N" or a number).
    """

    DRAWS = ("u", "g", "g3")

    def __init__(self, bin_centers, median_error_in_bin, std_error_in_bin,
                 interpolation_unit: str = "AB",
                 upper_limits: bool = False,
                 treat_as_upper_limits_below: float | None = None,
                 upper_limit_value: float | None = None,
                 upper_limit_flux_behaviour="scatter_limit",
                 upper_limit_flux_err_behaviour="flux",
                 sigma_clip: float | None = None, **kw):
        super().__init__(bin_centers, median_error_in_bin, std_error_in_bin,
                         **kw)
        self.interpolation_unit = U.FluxUnit.parse(interpolation_unit)
        self.upper_limits = bool(upper_limits)
        self.treat_as_upper_limits_below = treat_as_upper_limits_below
        self.upper_limit_value = upper_limit_value
        self.upper_limit_flux_behaviour = upper_limit_flux_behaviour
        self.upper_limit_flux_err_behaviour = upper_limit_flux_err_behaviour
        self.sigma_clip = sigma_clip

    @classmethod
    def from_catalogue(cls, fluxes, errors, flux_unit="AB",
                       interpolation_unit=None, num_bins=20,
                       min_samples_per_bin=10, upper_limits=False,
                       treat_as_upper_limits_below=None,
                       upper_limit_flux_behaviour="scatter_limit",
                       upper_limit_flux_err_behaviour="flux",
                       sigma_clip=None, min_flux_for_binning=None, **kw):
        fu = U.FluxUnit.parse(flux_unit)
        iu = U.FluxUnit.parse(interpolation_unit or flux_unit)
        fluxes = np.asarray(fluxes, np.float64)
        errors = np.asarray(errors, np.float64)
        f_i = U.convert_flux(fluxes, fu, iu).numpy()
        e_i = U.convert_flux_err(fluxes, errors, fu, iu).numpy()
        valid = np.isfinite(f_i) & np.isfinite(e_i) & (e_i > 0)
        if min_flux_for_binning is not None:
            valid &= f_i > min_flux_for_binning
        log_bins = iu != U.FluxUnit.AB
        c, m, s = fit_binned_error_model(
            f_i[valid], e_i[valid], num_bins, log_bins=log_bins,
            min_samples_per_bin=min_samples_per_bin)
        ul_value = None
        if upper_limits and treat_as_upper_limits_below is not None:
            # flux at the threshold SNR by log-log interpolation of SNR(flux)
            f_njy = U.convert_flux(f_i[valid], iu, U.FluxUnit.NJY).numpy()
            e_njy = U.convert_flux_err(f_i[valid], e_i[valid], iu,
                                       U.FluxUnit.NJY).numpy()
            with np.errstate(divide="ignore", invalid="ignore"):
                snr = f_njy / e_njy
            ok = np.isfinite(snr) & (snr > 0) & (f_njy > 0)
            if ok.sum() >= 2:
                order = np.argsort(snr[ok])
                ul_flux_njy = 10 ** np.interp(
                    np.log10(treat_as_upper_limits_below),
                    np.log10(snr[ok][order]), np.log10(f_njy[ok][order]))
                ul_value = float(U.convert_flux(ul_flux_njy, U.FluxUnit.NJY,
                                                iu))
        return cls(c, m, s, interpolation_unit=iu, upper_limits=upper_limits,
                   treat_as_upper_limits_below=treat_as_upper_limits_below,
                   upper_limit_value=ul_value,
                   upper_limit_flux_behaviour=upper_limit_flux_behaviour,
                   upper_limit_flux_err_behaviour=upper_limit_flux_err_behaviour,
                   sigma_clip=sigma_clip, num_bins=num_bins,
                   log_bins=log_bins, min_samples_per_bin=min_samples_per_bin)

    def _snr(self, flux_i, sigma_i):
        f_njy = U.convert_flux(flux_i, self.interpolation_unit, U.FluxUnit.NJY)
        e_njy = U.convert_flux_err(flux_i, sigma_i, self.interpolation_unit,
                                   U.FluxUnit.NJY)
        return f_njy / torch.clamp(e_njy, min=1.0e-30)

    def _replacement_sigma(self, ulv: float, like):
        """σ of an upper limit per `upper_limit_flux_err_behaviour`."""
        eb = self.upper_limit_flux_err_behaviour
        at_ulv = torch.full((1,), ulv, dtype=like.dtype, device=like.device)
        if eb == "flux" or (isinstance(eb, str) and eb.startswith("sig_")
                            and self.interpolation_unit != U.FluxUnit.AB):
            return self._at("median_error_in_bin", at_ulv)[0]
        if eb == "upper_limit":
            return ulv
        if isinstance(eb, str) and eb.startswith("sig_"):
            return U.POGSON / float(eb.split("_")[1])
        return float(eb)

    def apply(self, generator, flux_njy, draws=None):
        d = self._draws(generator, flux_njy, draws)
        iu = self.interpolation_unit
        f_i = U.convert_flux(flux_njy, U.FluxUnit.NJY, iu)
        sigma_i = self.sample_uncertainty(d["u"], f_i)
        limits = (self.upper_limits
                  and self.treat_as_upper_limits_below is not None)
        pre_mask = (self._snr(f_i, sigma_i) < self.treat_as_upper_limits_below
                    if limits else torch.zeros_like(f_i, dtype=torch.bool))
        g = d["g"]
        if self.sigma_clip is not None:
            g = torch.clamp(g, -self.sigma_clip, self.sigma_clip)
        # pre-identified upper limits are not scattered
        noisy_i = torch.where(pre_mask, f_i, f_i + sigma_i * g)
        final_sigma_i = sigma_i
        if limits and self.upper_limit_value is not None:
            mask = pre_mask | (self._snr(noisy_i, final_sigma_i)
                               < self.treat_as_upper_limits_below)
            ulv = float(self.upper_limit_value)
            fb = self.upper_limit_flux_behaviour
            if fb == "scatter_limit":
                at_ulv = torch.full((1,), ulv, dtype=f_i.dtype,
                                    device=f_i.device)
                sd = self._at("std_error_in_bin", at_ulv)[0]
                repl = ulv + sd * torch.clamp(d["g3"], -3.0, 3.0)
            elif fb == "upper_limit":
                repl = torch.full_like(f_i, ulv)
            else:
                repl = torch.full_like(f_i, float(fb))
            noisy_i = torch.where(mask, repl, noisy_i)
            final_sigma_i = torch.where(
                mask, torch.as_tensor(self._replacement_sigma(ulv, f_i),
                                      dtype=f_i.dtype, device=f_i.device),
                final_sigma_i)
        return (U.convert_flux(noisy_i, iu, U.FluxUnit.NJY),
                U.convert_flux_err(noisy_i, final_sigma_i, iu,
                                   U.FluxUnit.NJY))

    def serialize_to_hdf5(self, group):
        super().serialize_to_hdf5(group)
        a = group.attrs
        a["interpolation_unit"] = self.interpolation_unit.value
        a["upper_limits"] = self.upper_limits
        if self.treat_as_upper_limits_below is not None:
            a["treat_as_upper_limits_below"] = self.treat_as_upper_limits_below
        if self.upper_limit_value is not None:
            a["upper_limit_value"] = self.upper_limit_value
        a["upper_limit_flux_behaviour"] = str(self.upper_limit_flux_behaviour)
        a["upper_limit_flux_err_behaviour"] = str(
            self.upper_limit_flux_err_behaviour)
        if self.sigma_clip is not None:
            a["sigma_clip"] = self.sigma_clip

    @classmethod
    def _from_hdf5_group(cls, group):
        a = group.attrs

        def _opt(name):
            return float(a[name]) if name in a else None

        fb = str(a.get("upper_limit_flux_behaviour", "scatter_limit"))
        try:
            fb = float(fb)
        except ValueError:
            pass
        return cls(
            interpolation_unit=str(a.get("interpolation_unit", "AB")),
            upper_limits=bool(a.get("upper_limits", False)),
            treat_as_upper_limits_below=_opt("treat_as_upper_limits_below"),
            upper_limit_value=_opt("upper_limit_value"),
            upper_limit_flux_behaviour=fb,
            upper_limit_flux_err_behaviour=str(
                a.get("upper_limit_flux_err_behaviour", "flux")),
            sigma_clip=_opt("sigma_clip"), **cls._base_kwargs(group))


# ---------------------------------------------------------------------------
# registry and construction from a catalogue
# ---------------------------------------------------------------------------

MODEL_CLASS_REGISTRY = {
    "DepthNoiseModel": DepthNoiseModel,
    "SpectralNoiseModel": SpectralNoiseModel,
    "EmpiricalNoiseModel": EmpiricalNoiseModel,
    "AsinhEmpiricalNoiseModel": AsinhEmpiricalNoiseModel,
    "GeneralEmpiricalNoiseModel": GeneralEmpiricalNoiseModel,
    # the reference's class names, for its files
    "DepthUncertaintyModel": DepthNoiseModel,
    "SpectralUncertaintyModel": SpectralNoiseModel,
    "AsinhEmpiricalUncertaintyModel": AsinhEmpiricalNoiseModel,
    "GeneralEmpiricalUncertaintyModel": GeneralEmpiricalNoiseModel,
}


def create_noise_models_from_catalogue(flux_njy_by_band: dict,
                                       err_njy_by_band: dict,
                                       model_type: str = "general",
                                       **kwargs) -> dict:
    """Per-band noise models from observed catalogue arrays ({band: fluxes},
    {band: errors}, nJy): "general" (interpolated in nJy), "asinh",
    "empirical" or "depth" (a 5σ depth from the median error)."""
    models = {}
    for band, flux in flux_njy_by_band.items():
        err = err_njy_by_band[band]
        if model_type == "general":
            models[band] = GeneralEmpiricalNoiseModel.from_catalogue(
                np.asarray(flux), np.asarray(err), flux_unit="nJy",
                interpolation_unit="nJy", **kwargs)
        elif model_type == "asinh":
            models[band] = AsinhEmpiricalNoiseModel.from_catalogue(
                flux, err, **kwargs)
        elif model_type == "empirical":
            models[band] = EmpiricalNoiseModel.from_catalogue(flux, err,
                                                              **kwargs)
        elif model_type == "depth":
            sigma = float(np.nanmedian(err))
            depth_ab = float(U.njy_to_ab(5.0 * sigma))
            models[band] = DepthNoiseModel(depth_ab, 5.0, **kwargs)
        else:
            raise ValueError(f"unknown model_type {model_type!r}")
    return models


def save_noise_model_hdf5(model: NoiseModel, group) -> None:
    model.serialize_to_hdf5(group)


def load_noise_model_hdf5(group) -> NoiseModel:
    cls_name = str(group.attrs["__class__"])
    try:
        cls = MODEL_CLASS_REGISTRY[cls_name]
    except KeyError as e:
        raise ValueError(f"Unknown noise model class {cls_name!r}") from e
    return cls._from_hdf5_group(group)
