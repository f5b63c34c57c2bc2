"""Photometric filters.

Counterpart of `synference_tpu/filters.py`. Filter curves stay host numpy:
the simulator reads them once at construction, where they become the knot
and denominator tables (`ops/photometry_kernel.py`).

Convention: photon-counting mean flux density,
    f_filter = ∫ f_nu(λ) T(λ) dλ/λ / ∫ T(λ) dλ/λ.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

__all__ = ["Filter", "FilterSet", "tophat_filter"]


@dataclass
class Filter:
    """A single filter transmission curve on observed-frame wavelengths [Å]."""

    code: str
    lam: np.ndarray  # (K,) ascending, Angstrom
    transmission: np.ndarray  # (K,) >= 0


def tophat_filter(code: str, center: float, width: float) -> Filter:
    """Ideal tophat filter; edges sampled exactly so interpolation stays sharp."""
    lo, hi = center - width / 2.0, center + width / 2.0
    eps = 1.0e-3 * width
    lam = np.array([lo - eps, lo, hi, hi + eps])
    trans = np.array([0.0, 1.0, 1.0, 0.0])
    return Filter(code=code, lam=lam, transmission=trans)


class FilterSet:
    """An ordered stack of filters (the photometry output bands)."""

    def __init__(self, filters: list):
        self.filters = list(filters)
        self.codes = [f.code for f in self.filters]

    def __len__(self) -> int:
        return len(self.filters)

    def __getitem__(self, i) -> Filter:
        return self.filters[i]

    def shifted_table(self, lam_rest: np.ndarray, z_max: float = 25.0):
        """Transmissions on an extended log-λ grid: with λ_obs = λ_rest(1+z),
        a redshift is a shift of s(z) = log10(1+z)/dlog columns.

        Returns:
            table: (F, L + max_shift + 1) float32 transmissions at
                lam_rest[0] * 10**(dlog * arange(...)).
            dlog: log10 column spacing.
            max_shift: number of extra columns (clamp for s(z)).
        """
        lam_rest = np.asarray(lam_rest)
        dlogs = np.diff(np.log10(lam_rest))
        dlog = float(dlogs.mean())
        if not np.allclose(dlogs, dlog, rtol=1e-4):
            raise ValueError("shifted_table requires log-uniform lam_rest")
        max_shift = int(np.ceil(np.log10(1.0 + z_max) / dlog)) + 1
        n_cols = len(lam_rest) + max_shift + 1
        lam_ext = lam_rest[0] * 10.0 ** (dlog * np.arange(n_cols))
        table = np.zeros((len(self.filters), n_cols), dtype=np.float32)
        for i, f in enumerate(self.filters):
            table[i] = np.interp(lam_ext, f.lam, f.transmission, left=0.0, right=0.0)
        return table, dlog, max_shift

    # -- persistence: the JAX package's layout inside a library's Model group
    def to_hdf5(self, group) -> None:
        """Write the curves into an h5py group (attrs `filter_codes`, one
        `filter_{i}` subgroup of `lam` / `transmission` each)."""
        group.attrs["filter_codes"] = self.codes
        for i, f in enumerate(self.filters):
            g = group.create_group(f"filter_{i}")
            g.attrs["code"] = f.code
            g.create_dataset("lam", data=f.lam)
            g.create_dataset("transmission", data=f.transmission)

    @classmethod
    def from_hdf5(cls, group) -> "FilterSet":
        codes = list(group.attrs["filter_codes"])
        return cls([
            Filter(code=str(group[f"filter_{i}"].attrs["code"]),
                   lam=np.asarray(group[f"filter_{i}"]["lam"][:]),
                   transmission=np.asarray(
                       group[f"filter_{i}"]["transmission"][:]))
            for i in range(len(codes))])
