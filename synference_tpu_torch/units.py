"""Unit system and photometric conversions on torch tensors.

Counterpart of `synference_tpu/units.py`: the same constants and the same
formulas (AB zero point 3631 Jy; asinh magnitudes with softening b, reference
`utils.py:647-807`), written as plain functions on tensors. Python scalars
and numpy inputs become float32 tensors, as the JAX package's weak-typed
scalars do, so both packages round alike.
"""

from __future__ import annotations

import enum
import math

import torch

# ---------------------------------------------------------------------------
# Physical constants (CGS + astronomy)
# ---------------------------------------------------------------------------

C_CM_S = 2.99792458e10  # speed of light [cm/s]
C_AA_S = 2.99792458e18  # speed of light [Angstrom/s]
JY_CGS = 1.0e-23  # 1 Jansky [erg/s/cm^2/Hz]
NJY_IN_JY = 1.0e-9
AB_ZP_JY = 3631.0  # AB zero-point flux [Jy]
MPC_CM = 3.0856775814913673e24  # 1 Mpc [cm]
PC_CM = 3.0856775814913673e18  # 1 pc [cm]
MSUN_G = 1.98892e33  # solar mass [g]
YR_S = 3.1557e7  # Julian year [s]
GYR_S = 3.1557e16
LN10 = math.log(10.0)
POGSON = 2.5 / LN10  # = 2.5 log10(e), the asinh-mag scale factor


class FluxUnit(str, enum.Enum):
    """Units a photometric feature vector can be expressed in."""

    NJY = "nJy"
    JY = "Jy"
    AB = "AB"
    ASINH = "asinh"
    LOG10_NJY = "log10_nJy"

    @classmethod
    def parse(cls, s: "FluxUnit | str") -> "FluxUnit":
        if isinstance(s, FluxUnit):
            return s
        aliases = {
            "njy": cls.NJY,
            "jy": cls.JY,
            "ab": cls.AB,
            "abmag": cls.AB,
            "mag": cls.AB,
            "asinh": cls.ASINH,
            "asinh mag": cls.ASINH,
            "log10 njy": cls.LOG10_NJY,
            "log10_njy": cls.LOG10_NJY,
            "log10(njy)": cls.LOG10_NJY,
        }
        try:
            return aliases[str(s).strip().lower()]
        except KeyError as e:
            raise ValueError(f"Unknown flux unit {s!r}") from e


def _t(x) -> torch.Tensor:
    """Tensor view of `x`; non-tensor inputs become float32."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32)


# ---------------------------------------------------------------------------
# AB magnitudes
# ---------------------------------------------------------------------------


def njy_to_jy(f_njy):
    return _t(f_njy) * NJY_IN_JY


def jy_to_njy(f_jy):
    return _t(f_jy) / NJY_IN_JY


def jy_to_ab(f_jy):
    """Flux [Jy] -> AB magnitude. m = -2.5 log10(f/3631 Jy)."""
    return -2.5 * torch.log10(_t(f_jy) / AB_ZP_JY)


def ab_to_jy(mag):
    return AB_ZP_JY * torch.pow(10.0, -0.4 * _t(mag))


def njy_to_ab(f_njy):
    return jy_to_ab(njy_to_jy(f_njy))


def ab_to_njy(mag):
    return jy_to_njy(ab_to_jy(mag))


def jy_err_to_ab_err(f_jy, f_jy_err):
    """Gaussian error propagation of AB mag: dm = 2.5 log10(e) * df/f."""
    return POGSON * _t(f_jy_err) / _t(f_jy)


def ab_err_to_jy_err(mag, mag_err):
    return _t(mag_err) * ab_to_jy(mag) / POGSON


# ---------------------------------------------------------------------------
# asinh ("luptitude") magnitudes — reference utils.py:647-807
# ---------------------------------------------------------------------------


def f_jy_to_asinh(f_jy, f_b_jy=5.0e-9):
    """Flux [Jy] -> asinh magnitude with softening f_b [Jy]:
    m = -2.5 log10(e) * [ asinh(f / 2b) + ln(b / 3631) ]."""
    f_jy, f_b = _t(f_jy), _t(f_b_jy).to(_t(f_jy).device)
    return -POGSON * (torch.asinh(f_jy / (2.0 * f_b)) + torch.log(f_b / AB_ZP_JY))


def f_jy_err_to_asinh(f_jy, f_jy_err, f_b_jy=5.0e-9):
    """Flux error [Jy] -> asinh magnitude error:
    dm = 2.5 log10(e) * df / sqrt(f^2 + (2b)^2)."""
    f_jy, f_b = _t(f_jy), _t(f_b_jy).to(_t(f_jy).device)
    return POGSON * _t(f_jy_err) / torch.sqrt(f_jy**2 + (2.0 * f_b) ** 2)


def asinh_to_f_jy(m_asinh, f_b_jy=5.0e-9):
    """asinh magnitude -> flux [Jy]."""
    m = _t(m_asinh)
    f_b = _t(f_b_jy).to(m.device)
    arg = -m / POGSON - torch.log(f_b / AB_ZP_JY)
    return 2.0 * f_b * torch.sinh(arg)


def asinh_err_to_f_jy_err(m_asinh, m_asinh_err, f_b_jy=5.0e-9):
    """asinh magnitude error -> flux error [Jy]."""
    f_jy = asinh_to_f_jy(m_asinh, f_b_jy)
    f_b = _t(f_b_jy).to(f_jy.device)
    return _t(m_asinh_err) * torch.sqrt(f_jy**2 + (2.0 * f_b) ** 2) / POGSON


def ab_depth_to_sigma_njy(depth_ab, sigma_level=5.0):
    """AB-mag survey depth at `sigma_level` -> 1-sigma noise in nJy."""
    return ab_to_njy(depth_ab) / sigma_level


# ---------------------------------------------------------------------------
# Unit-graph conversion for feature vectors
# ---------------------------------------------------------------------------


def convert_flux(value, from_unit, to_unit, f_b_njy=5.0):
    """Convert photometry between any two supported units.

    `f_b_njy` is the asinh softening in nJy (scalar or per-filter array).
    """
    fu, tu = FluxUnit.parse(from_unit), FluxUnit.parse(to_unit)
    value = _t(value)
    if fu == tu:
        return value
    f_b_jy = _t(f_b_njy).to(value.device) * NJY_IN_JY
    if fu == FluxUnit.NJY:
        f_jy = njy_to_jy(value)
    elif fu == FluxUnit.JY:
        f_jy = value
    elif fu == FluxUnit.AB:
        f_jy = ab_to_jy(value)
    elif fu == FluxUnit.ASINH:
        f_jy = asinh_to_f_jy(value, f_b_jy)
    else:
        f_jy = njy_to_jy(torch.pow(10.0, value))
    if tu == FluxUnit.NJY:
        return jy_to_njy(f_jy)
    if tu == FluxUnit.JY:
        return f_jy
    if tu == FluxUnit.AB:
        return jy_to_ab(f_jy)
    if tu == FluxUnit.ASINH:
        return f_jy_to_asinh(f_jy, f_b_jy)
    return torch.log10(jy_to_njy(f_jy))


def convert_flux_err(value, err, from_unit, to_unit, f_b_njy=5.0):
    """Convert photometric errors between units (propagating through flux)."""
    fu, tu = FluxUnit.parse(from_unit), FluxUnit.parse(to_unit)
    value, err = _t(value), _t(err)
    if fu == tu:
        return err
    f_b_jy = _t(f_b_njy).to(value.device) * NJY_IN_JY
    if fu == FluxUnit.NJY:
        f_jy, e_jy = njy_to_jy(value), njy_to_jy(err)
    elif fu == FluxUnit.JY:
        f_jy, e_jy = value, err
    elif fu == FluxUnit.AB:
        f_jy, e_jy = ab_to_jy(value), ab_err_to_jy_err(value, err)
    elif fu == FluxUnit.ASINH:
        f_jy = asinh_to_f_jy(value, f_b_jy)
        e_jy = asinh_err_to_f_jy_err(value, err, f_b_jy)
    else:
        f_jy = njy_to_jy(torch.pow(10.0, value))
        e_jy = err * LN10 * f_jy
    if tu == FluxUnit.NJY:
        return jy_to_njy(e_jy)
    if tu == FluxUnit.JY:
        return e_jy
    if tu == FluxUnit.AB:
        return jy_err_to_ab_err(f_jy, e_jy)
    if tu == FluxUnit.ASINH:
        return f_jy_err_to_asinh(f_jy, e_jy, f_b_jy)
    return e_jy / (LN10 * f_jy)
