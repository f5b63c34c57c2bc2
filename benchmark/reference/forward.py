"""Plain forward model: θ → band photometry [nJy], for the library cells.

A frozen, plain-PyTorch statement of the model the configurations run
(lognormal SFH over the grid's age bins, delta metallicity, Calzetti 2000
screen, Inoue 2014 IGM, flat ΛCDM distances, photon-counting band means),
with the photometry taken the way the model defines it: the flux row
times dλ/λ is integrated against each band at integer-column knot shifts
(the band curves read in float32 at the knot's shifted wavelengths, the
IGM of the knot's redshift folded in), both operands of that product
rounded to bfloat16, and the galaxy's real shift interpolated between
knots by a monotone cubic (Fritsch-Butland slopes), numerator and
denominator alike. Every table is built here from the benchmark's own
grid arrays and filter curves, nothing is read from the program under
test, and it imports nothing of it.

Precision is the configuration's: float32 throughout, with the first
product (SFZH × spectra) taken in float64 and rounded once, and the knot
product of bf16 operands summed in float64 and rounded once (the exact
answers of those two products). `first_product` can be replaced: the
control passes `tf32_first_product`, the same product with both operands
rounded to TF32 as a tensor core reads them.
"""

from __future__ import annotations

import numpy as np
import torch

# constants of the model (CODATA / IAU values)
C_CM_S = 2.99792458e10
MPC_CM = 3.0856775814913673e24
FOUR_PI = 4.0 * np.pi

_GL_X, _GL_W = np.polynomial.legendre.leggauss(64)

# Inoue, Shimizu, Iwata & Tanaka 2014, Table 2: λ_j [Å], A_LAF1..3, A_DLA1..2
_INOUE = np.array([
    [1215.67, 1.690e-02, 2.354e-03, 1.026e-04, 1.617e-04, 5.390e-05],
    [1025.72, 4.692e-03, 6.536e-04, 2.849e-05, 1.545e-04, 5.151e-05],
    [972.537, 2.239e-03, 3.119e-04, 1.360e-05, 1.498e-04, 4.992e-05],
    [949.743, 1.319e-03, 1.837e-04, 8.010e-06, 1.460e-04, 4.868e-05],
    [937.803, 8.707e-04, 1.213e-04, 5.287e-06, 1.429e-04, 4.763e-05],
    [930.748, 6.178e-04, 8.606e-05, 3.752e-06, 1.402e-04, 4.672e-05],
    [926.226, 4.609e-04, 6.421e-05, 2.799e-06, 1.377e-04, 4.590e-05],
    [923.150, 3.569e-04, 4.971e-05, 2.167e-06, 1.355e-04, 4.516e-05],
    [920.963, 2.843e-04, 3.960e-05, 1.726e-06, 1.335e-04, 4.448e-05],
    [919.352, 2.318e-04, 3.229e-05, 1.407e-06, 1.316e-04, 4.385e-05],
    [918.129, 1.923e-04, 2.679e-05, 1.168e-06, 1.298e-04, 4.326e-05],
    [917.181, 1.622e-04, 2.259e-05, 9.847e-07, 1.281e-04, 4.271e-05],
    [916.429, 1.385e-04, 1.929e-05, 8.410e-07, 1.265e-04, 4.218e-05],
    [915.824, 1.196e-04, 1.666e-05, 7.263e-07, 1.250e-04, 4.168e-05],
    [915.329, 1.043e-04, 1.453e-05, 6.334e-07, 1.236e-04, 4.120e-05],
    [914.919, 9.174e-05, 1.278e-05, 5.571e-07, 1.222e-04, 4.075e-05],
    [914.576, 8.128e-05, 1.132e-05, 4.936e-07, 1.209e-04, 4.031e-05],
    [914.286, 7.251e-05, 1.010e-05, 4.403e-07, 1.197e-04, 3.989e-05],
    [914.039, 6.505e-05, 9.062e-06, 3.950e-07, 1.185e-04, 3.949e-05],
    [913.826, 5.868e-05, 8.174e-06, 3.563e-07, 1.173e-04, 3.910e-05],
    [913.641, 5.319e-05, 7.409e-06, 3.230e-07, 1.162e-04, 3.872e-05],
    [913.480, 4.843e-05, 6.746e-06, 2.941e-07, 1.151e-04, 3.836e-05],
    [913.339, 4.427e-05, 6.167e-06, 2.689e-07, 1.140e-04, 3.800e-05],
    [913.215, 4.063e-05, 5.660e-06, 2.467e-07, 1.130e-04, 3.766e-05],
    [913.104, 3.738e-05, 5.207e-06, 2.270e-07, 1.120e-04, 3.732e-05],
    [913.006, 3.454e-05, 4.811e-06, 2.097e-07, 1.110e-04, 3.700e-05],
    [912.918, 3.199e-05, 4.456e-06, 1.943e-07, 1.101e-04, 3.668e-05],
    [912.839, 2.971e-05, 4.139e-06, 1.804e-07, 1.091e-04, 3.637e-05],
    [912.768, 2.766e-05, 3.853e-06, 1.680e-07, 1.082e-04, 3.607e-05],
    [912.703, 2.582e-05, 3.596e-06, 1.568e-07, 1.073e-04, 3.578e-05],
    [912.645, 2.415e-05, 3.364e-06, 1.466e-07, 1.065e-04, 3.549e-05],
    [912.592, 2.263e-05, 3.153e-06, 1.375e-07, 1.056e-04, 3.521e-05],
    [912.543, 2.126e-05, 2.961e-06, 1.291e-07, 1.048e-04, 3.493e-05],
    [912.499, 2.000e-05, 2.785e-06, 1.214e-07, 1.040e-04, 3.466e-05],
    [912.458, 1.885e-05, 2.625e-06, 1.145e-07, 1.032e-04, 3.440e-05],
    [912.420, 1.779e-05, 2.479e-06, 1.080e-07, 1.024e-04, 3.414e-05],
    [912.385, 1.682e-05, 2.343e-06, 1.022e-07, 1.017e-04, 3.389e-05],
    [912.353, 1.593e-05, 2.219e-06, 9.673e-08, 1.009e-04, 3.364e-05],
    [912.324, 1.510e-05, 2.103e-06, 9.169e-08, 1.002e-04, 3.339e-05],
], dtype=np.float32)
_LAM_L = 911.8


def exact_first_product(a, b):
    """a @ b in float64, rounded once to float32."""
    return (a.double() @ b.double()).float()


def tf32_round(x):
    """x rounded to TF32 (10 mantissa bits), to nearest, ties away."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_first_product(a, b):
    """The first product with both operands rounded to TF32: what a TF32
    tensor-core product reads (the control's precision)."""
    return (tf32_round(a).double() @ tf32_round(b).double()).float()


def _interp_f32(x, xp, fp):
    """Linear interpolation, zero outside [xp0, xp-1], in float32."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    df = fp[i] - fp[i - 1]
    dx = xp[i] - xp[i - 1]
    delta = x - xp[i - 1]
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, fp[i - 1],
                    fp[i - 1] + (delta / torch.where(dx0, 1.0, dx)) * df)
    f = torch.where(x < xp[0], 0.0, f)
    return torch.where(x > xp[-1], 0.0, f)


def _interp_f64(x, xp, fp):
    """np.interp(x, xp, fp, left=0, right=0) on float64 tensors."""
    n = xp.shape[0]
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1,
                    n - 1)
    slope = (fp[i] - fp[i - 1]) / (xp[i] - xp[i - 1])
    f = slope * (x - xp[i - 1]) + fp[i - 1]
    f = torch.where(x == xp[-1], fp[-1], f)
    return torch.where((x < xp[0]) | (x > xp[-1]), 0.0, f)


def _igm_inoue14(lam_obs, z):
    """Inoue 2014 IGM transmission at observed λ for redshift z (float32;
    z broadcasts against lam_obs)."""
    tab = torch.as_tensor(_INOUE, device=lam_obs.device)
    zp1 = 1.0 + z
    lam_j = tab[:, 0]
    x = lam_obs[..., None] / lam_j
    in_band = (x > 1.0) & (lam_obs[..., None] < lam_j * zp1[..., None])
    a1, a2, a3, d1, d2 = (tab[:, k] for k in (1, 2, 3, 4, 5))
    laf = torch.where(x < 2.2, a1 * x ** 1.2,
                      torch.where(x < 5.7, a2 * x ** 3.7, a3 * x ** 5.5))
    dla = torch.where(x < 3.0, d1 * x ** 2.0, d2 * x ** 3.0)
    tau = torch.sum(torch.where(in_band, laf + dla, 0.0), dim=-1)

    x_raw = lam_obs / _LAM_L
    in_lc = x_raw < zp1
    xc = torch.clamp(x_raw, min=1.0)
    low = 0.325 * (xc ** 1.2 - zp1 ** (-0.9) * xc ** 2.1)
    mid = torch.where(
        xc < 2.2,
        2.55e-2 * zp1 ** 1.6 * xc ** 2.1 + 0.325 * xc ** 1.2
        - 0.250 * xc ** 2.1,
        2.55e-2 * (zp1 ** 1.6 * xc ** 2.1 - xc ** 3.7))
    high = torch.where(
        xc < 2.2,
        5.22e-4 * zp1 ** 3.4 * xc ** 2.1 + 0.325 * xc ** 1.2
        - 3.14e-2 * xc ** 2.1,
        torch.where(
            xc < 5.7,
            5.22e-4 * zp1 ** 3.4 * xc ** 2.1 + 0.218 * xc ** 2.1
            - 2.55e-2 * xc ** 3.7,
            5.22e-4 * (zp1 ** 3.4 * xc ** 2.1 - xc ** 5.5)))
    t_laf = torch.where(z < 1.2, low, torch.where(z < 4.7, mid, high))
    tau = tau + torch.where(in_lc, torch.clamp(t_laf, min=0.0), 0.0)
    low = (0.211 * zp1 ** 2.0 - 7.66e-2 * zp1 ** 2.3 * xc ** (-0.3)
           - 0.135 * xc ** 2.0)
    high = torch.where(
        xc < 3.0,
        0.634 + 4.7e-2 * zp1 ** 3.0 - 1.78e-2 * zp1 ** 3.3 * xc ** (-0.3)
        - 0.135 * xc ** 2.0 - 0.291 * xc ** (-0.3),
        4.7e-2 * zp1 ** 3.0 - 1.78e-2 * zp1 ** 3.3 * xc ** (-0.3)
        - 2.92e-2 * xc ** 3.0)
    t_dla = torch.where(z < 2.0, low, high)
    tau = tau + torch.where(in_lc, torch.clamp(t_dla, min=0.0), 0.0)
    return torch.exp(-tau)


def _calzetti(lam):
    """Calzetti et al. 2000 k(λ)/R_V, R_V = 4.05, clamped at 0."""
    rv = 4.05
    inv = 1.0 / torch.clamp(lam * 1.0e-4, min=1.0e-4)
    mu = lam * 1.0e-4
    k_short = 2.659 * (-2.156 + 1.509 * inv - 0.198 * inv ** 2
                       + 0.011 * inv ** 3) + rv
    k_long = 2.659 * (-1.857 + 1.040 * inv) + rv
    return torch.clamp(torch.where(mu < 0.63, k_short, k_long), min=0.0) / rv


def _gauss_legendre(upper, integrand):
    x = torch.as_tensor(_GL_X, dtype=torch.float32, device=upper.device)
    w = torch.as_tensor(_GL_W, dtype=torch.float32, device=upper.device)
    half = 0.5 * upper[..., None]
    return torch.sum(w * integrand(half * (x + 1.0)), dim=-1) * half[..., 0]


def _uniform_lerp(table, x0, dx, x):
    s = (x - x0) / dx
    k = torch.clamp(torch.floor(s).to(torch.int64), 0, table.shape[0] - 2)
    frac = torch.clamp(s - k.to(s.dtype), 0.0, 1.0)
    return table[k] * (1.0 - frac) + table[k + 1] * frac


def _fb_slope(da, db):
    """Fritsch-Butland harmonic-mean slope, scale-normalised."""
    same = ((da > 0.0) & (db > 0.0)) | ((da < 0.0) & (db < 0.0))
    m = torch.abs(da) + torch.abs(db)
    sc = 1.0 / torch.clamp(m, min=1.0e-30)
    das, dbs = da * sc, db * sc
    ms = torch.where(same, torch.abs(das) + torch.abs(dbs), 1.0)
    na = torch.where(same, das / ms, 0.5)
    nb = torch.where(same, dbs / ms, 0.5)
    return torch.where(same, m * (2.0 * na * nb) / (na + nb), 0.0)


def _cubic(vm1, v0, v1, v2, k, t, n_knots: int):
    """Monotone cubic Hermite through four knot rows (B, F); the end
    knots take linearly extrapolated virtual neighbours."""
    vm1 = torch.where((k == 0)[:, None], 2.0 * v0 - v1, vm1)
    v2 = torch.where((k + 2 > n_knots - 1)[:, None], 2.0 * v1 - v0, v2)
    m0 = _fb_slope(v0 - vm1, v1 - v0)
    m1 = _fb_slope(v1 - v0, v2 - v1)
    t2 = t * t
    t3 = t2 * t
    return ((2.0 * t3 - 3.0 * t2 + 1.0) * v0 + (t3 - 2.0 * t2 + t) * m0
            + (-2.0 * t3 + 3.0 * t2) * v1 + (t3 - t2) * m1)


class ForwardModel:
    """The model's tables, built on `device` from the benchmark's grid
    arrays (`inputs.make_grid`) and filter curves (`inputs.make_filters`),
    and `photometry(θ)`.

    `model` holds the configuration's choices: "param_names", "z_max",
    "knot_spacing_dex", "cosmology" {"h0", "om0"}."""

    def __init__(self, grid: dict, filters: list, model: dict, device):
        dev = self.device = torch.device(device)
        f32 = torch.float32
        self.param_names = tuple(model["param_names"])
        z_max = float(model["z_max"])
        lam = np.asarray(grid["lam"], np.float64)
        n_wav = lam.shape[0]
        self.n_f = len(filters)
        self.f8 = int(np.ceil(self.n_f / 8) * 8)
        dlog = float(np.diff(np.log10(lam)).mean())
        self.dlog = dlog
        max_shift = int(np.ceil(np.log10(1.0 + z_max) / dlog)) + 1
        delta = self.delta = max(1, round(model["knot_spacing_dex"] / dlog))
        n_knots = self.n_knots = max_shift // delta + 2
        # the λ support: columns no band reaches at any knot shift add
        # nothing to any band
        f_lo = min(float(np.min(c[1])) for c in filters)
        f_hi = max(float(np.max(c[1])) for c in filters)
        m0 = int(np.floor(np.log10(f_lo / lam[0]) / dlog)) - 1
        m1 = int(np.ceil(np.log10(f_hi / lam[0]) / dlog)) + 2
        l0 = max(0, m0 - (n_knots - 1) * delta)
        l1 = int(np.clip(m1, l0 + 1, n_wav))
        self.support = (l0, l1)

        lam32 = torch.as_tensor(lam.astype(np.float32), device=dev)
        wlam = torch.as_tensor((np.gradient(lam) / lam).astype(np.float32),
                               device=dev)
        spectra = torch.as_tensor(grid["total"], device=dev)
        spectra = spectra.reshape(-1, n_wav)[:, l0:l1]
        self.sed_w = (spectra * wlam[None, l0:l1]).contiguous()
        self.curve = _calzetti(lam32)[l0:l1].contiguous()

        # knot matrix M[l, k·F8 + f] = T_f(λ0·10^((l + kδ)Δ)), float32
        # wavelengths, with the IGM of knot k's redshift folded in
        lam0 = torch.tensor(float(lam[0]), dtype=f32, device=dev)
        dlog32 = torch.tensor(dlog, dtype=f32, device=dev)
        l_idx = torch.arange(l0, l1, dtype=f32, device=dev)
        shifts = torch.arange(n_knots, dtype=f32, device=dev) * delta
        lam_eval = (lam0 * 10.0 ** ((l_idx[None, :] + shifts[:, None])
                                    * dlog32)).reshape(-1)
        knot = torch.zeros(n_knots, self.f8, l1 - l0, dtype=f32, device=dev)
        for i, (_, fl, ft) in enumerate(filters):
            xp = torch.as_tensor(np.asarray(fl, np.float32), device=dev)
            fp = torch.as_tensor(np.asarray(ft, np.float32), device=dev)
            knot[:, i] = _interp_f32(lam_eval, xp, fp).reshape(n_knots, -1)
        zp1 = 10.0 ** (delta * dlog * torch.arange(n_knots, dtype=f32,
                                                   device=dev))
        rows = []
        for k in range(n_knots):
            z = zp1[k:k + 1] - 1.0
            rows.append(_igm_inoue14(lam32[l0:l1] * (1.0 + z), z))
        igm = torch.stack(rows)  # (K, L)
        knot = knot * igm[:, None, :]
        # (K, F8, L) -> (L, K, F8), rounded to bf16: the product's operand
        self.knot = knot.permute(2, 0, 1).to(torch.bfloat16).contiguous()

        # denominators at the knots: Σ_l w_l T_f(λ0·10^((l + kδ)Δ)),
        # float64 over the whole grid, kept as float32
        w64 = wlam.double()
        lam_k = (float(lam[0]) * 10.0 ** (
            (torch.arange(n_wav, dtype=torch.float64, device=dev)[None, :]
             + (torch.arange(n_knots, device=dev) * delta)[:, None]
             .double()) * dlog))
        den = torch.zeros(n_knots, self.f8, dtype=f32, device=dev)
        for i, (_, fl, ft) in enumerate(filters):
            xp = torch.as_tensor(np.asarray(fl, np.float64), device=dev)
            fp = torch.as_tensor(np.asarray(ft, np.float64), device=dev)
            den[:, i] = (_interp_f64(lam_k, xp, fp) @ w64).float()
        self.den = den

        # cosmology: age and luminosity distance as 2048-knot lerp tables
        # over log(1+z), each knot a 64-node Gauss-Legendre quadrature
        h0, om0 = (float(model["cosmology"][k]) for k in ("h0", "om0"))
        ode0 = 1.0 - om0
        t_h = MPC_CM / 1.0e5 / 3.1557e16 / h0
        d_h = C_CM_S / 1.0e5 / h0
        zg = torch.as_tensor(np.expm1(np.linspace(0.0, np.log1p(z_max),
                                                  2048)), dtype=f32,
                             device=dev)
        a = 1.0 / (1.0 + zg)
        self.age_table = t_h * _gauss_legendre(
            a, lambda aa: torch.sqrt(aa) / torch.sqrt(om0 + ode0 * aa ** 3)
        ) * 1.0e9
        self.age_dx = float(np.log1p(z_max) / 2047.0)
        zd = torch.as_tensor(np.expm1(np.linspace(
            np.log1p(1.0e-4), np.log1p(z_max), 2048)), dtype=f32, device=dev)
        d_c = d_h * _gauss_legendre(
            zd, lambda zz: 1.0 / torch.sqrt(om0 * (1.0 + zz) ** 3 + ode0))
        self.d19_table = (1.0 + zd) * d_c * MPC_CM * 1.0e-19
        self.d19_x0 = float(np.log1p(1.0e-4))
        self.d19_dx = float((np.log1p(z_max) - np.log1p(1.0e-4)) / 2047.0)

        la = np.asarray(grid["log10_ages"], np.float64)
        mids = 0.5 * (la[1:] + la[:-1])
        lo = np.concatenate([[0.0], 10.0 ** mids])
        hi = 10.0 ** np.concatenate([mids, [la[-1]]])
        self.edges = torch.as_tensor(
            np.concatenate([lo, [hi[-1]]]).astype(np.float32), device=dev)
        self.log10_mets = torch.as_tensor(np.log10(np.asarray(
            grid["metallicities"], np.float64)).astype(np.float32),
            device=dev)

    # -- per galaxy ------------------------------------------------------
    def _col(self, theta, name):
        return theta[:, self.param_names.index(name)].contiguous()

    def sfzh(self, theta):
        """(B, A·Z) stellar mass [Msun] per grid cell."""
        z = self._col(theta, "redshift")
        max_age = _uniform_lerp(self.age_table, 0.0, self.age_dx,
                                torch.log1p(torch.clamp(z, min=0.0)))
        # lognormal SFH: cumulative mass Φ((ln x − μ)/τ) at the bin edges,
        # x the time since onset, the SFR's mode at lookback `peak_age`
        x = torch.clamp(max_age[:, None] - self.edges, min=0.0)
        tau = torch.clamp(self._col(theta, "tau"), min=1.0e-3)[:, None]
        x_peak = torch.clamp(max_age - self._col(theta, "peak_age"),
                             min=1.0e4)[:, None]
        mu = torch.log(x_peak) + tau ** 2
        m = torch.special.ndtr((torch.log(torch.clamp(x, min=1.0)) - mu)
                               / tau)
        w = torch.clamp(m[:, :-1] - m[:, 1:], min=0.0)
        total = torch.cumsum(w, dim=1)[:, -1:]
        w_age = torch.where(total > 1.0e-30,
                            w / torch.clamp(total, min=1.0e-30),
                            torch.full_like(w, 1.0 / w.shape[1]))
        # delta metallicity, shared linearly in log10 Z by the two
        # neighbouring grid cells
        mets = self.log10_mets
        lz = torch.clamp(self._col(theta, "log10_metallicity"), mets[0],
                         mets[-1])
        n = mets.shape[0]
        idx = torch.clamp(torch.searchsorted(mets, lz, right=True) - 1, 0,
                          n - 2)
        frac = (lz - mets[idx]) / torch.clamp(mets[idx + 1] - mets[idx],
                                              min=1.0e-12)
        w_met = torch.zeros(lz.shape[0], n, dtype=lz.dtype, device=lz.device)
        w_met = w_met.scatter(1, idx[:, None], (1.0 - frac)[:, None])
        w_met = w_met.scatter_add(1, (idx + 1)[:, None], frac[:, None])
        mass = 10.0 ** self._col(theta, "log10_mass")
        sfzh = w_age[:, :, None] * w_met[:, None, :]
        return (sfzh * mass[:, None, None]).reshape(theta.shape[0], -1)

    def photometry(self, theta, first_product=exact_first_product,
                   block: int = 512):
        """(B, P) θ float32 on the model's device -> (B, F) band fluxes
        [nJy], in blocks of `block` rows."""
        out = []
        for i in range(0, theta.shape[0], block):
            out.append(self._block(theta[i:i + block], first_product))
        return torch.cat(out)

    def _block(self, theta, first_product):
        z = self._col(theta, "redshift")
        s = torch.log10(1.0 + torch.clamp(z, min=0.0)) / self.dlog
        inv_d = 1.0 / _uniform_lerp(self.d19_table, self.d19_x0,
                                    self.d19_dx,
                                    torch.log1p(torch.clamp(z, min=1.0e-4)))
        scale = (1.0 + z) * (1.0e-6 / FOUR_PI) * inv_d * inv_d
        lnu = first_product(self.sfzh(theta), self.sed_w)
        fw = lnu * torch.exp(-self._col(theta, "tau_v")[:, None]
                             * self.curve[None, :])
        fw = fw.to(torch.bfloat16).double()
        n_k, d = self.n_knots, self.delta
        c = torch.clamp(s, 0.0, (n_k - 1) * d - 1.0e-3) / d
        k = torch.clamp(torch.floor(c).to(torch.int64), 0, n_k - 2)
        t = (c - k.to(c.dtype))[:, None]
        knots = torch.stack([torch.clamp(k - 1, min=0), k, k + 1,
                             torch.clamp(k + 2, max=n_k - 1)], dim=1)
        num = torch.empty(theta.shape[0], 4, self.f8, dtype=torch.float32,
                          device=theta.device)
        # each group of rows in one knot interval reads its four knots
        for kk in torch.unique(k).tolist():
            rows = torch.nonzero(k == kk)[:, 0]
            cols = self.knot[:, knots[rows[0]]].reshape(self.knot.shape[0],
                                                        -1)
            num[rows] = (fw[rows] @ cols.double()).float().reshape(
                -1, 4, self.f8)
        den = self.den[knots]  # (B, 4, F8)
        ratio = (_cubic(*num.unbind(1), k, t, n_k)
                 / torch.clamp(_cubic(*den.unbind(1), k, t, n_k),
                               min=1.0e-30))
        return (ratio * scale[:, None])[:, :self.n_f]
