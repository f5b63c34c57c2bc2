"""Port parity, the simulator's gradient: the monotone-cubic slope under
both AD modes, the `_mega_off` route, the kernel wrappers' gradient
refusal, and `sim.photometry` Jacobians against the JAX package's.

- `_fb_slope` at L_ν-scale inputs: da = s·e^t, db = 3s·e^{2t}, d/dt at
  t = 0.5 under `torch.func.jacrev` and `jacfwd` for s = 1, 1e20, 1e30,
  against the float64 closed form 6s·e^{2t}(2 + 3e^t)/(1 + 3e^t)²: relative
  error < 1e-5. Without the detached rescale the reverse mode gives NaN at
  s = 1e20 and 1e30.
- `_knot_interp` (order 3) on knot values of scale 1e30: its Jacobian with
  respect to a log-scale of the values, both modes, against `jax.jacrev` /
  `jax.jacfwd` of the JAX package's `_knot_interp`: < 1e-5 of the largest
  entry.
- `sim.photometry` Jacobians on the 32×5×512 test grid, 4 tophat bands,
  lognormal SFH, Calzetti, Inoue14, four θ rows, routes "xla", interp
  orders 1 and 3 (the port with the JAX tables loaded) and conv, each in
  both modes, against the JAX simulator's with `_mega_off` set: |Δ| below
  1e-4 of the largest entry of the same object's θ column (measured
  ≤ 6.7e-5, the conv route; ≤ 3e-5 for xla and interp). On the CPU the
  interp route with `_mega_off` unset takes K2's plain version, which is
  differentiable: the same bound.
- A bright galaxy far from its data (log10 M = 11 at z ≤ 0.12, the data at
  half the model flux, σ = 1.15 nJy: |∂ log L/∂f| ~ 1e7): the port's
  log-likelihood gradient is finite on the interp and conv routes (the
  scale multiplies in two factors); every entry of the JAX package's but
  ∂/∂z, which overflows to NaN there, agrees to 1e-5 relative.
- `_mega_off` keeps K1 and K2 out: the gates close, `photometry()` equals
  `_photometry_fused` bit for bit, the fused window body refuses.
- `refuse_autodiff` (the guard of the four CUDA wrappers) raises on a
  tensor that requires grad in grad mode, on a forward-AD dual, inside
  `torch.func` transforms, and not otherwise; the CUDA branches themselves
  are tested on the card (`tests/test_torch_cuda.py`).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.autograd import forward_ad

import synference_tpu as jst
import synference_tpu_torch as tt
from synference_tpu.ops import photometry_kernel as jpk
from synference_tpu_torch.ops import fused_sed as tfs
from synference_tpu_torch.ops import photometry_kernel as tpk
from synference_tpu_torch.ops._cuda import refuse_autodiff
from test_torch_dense import _jax_state

PNAMES = ("log10_mass", "redshift", "peak_age", "tau", "log10_metallicity",
          "tau_v")
_CENTERS = [9000.0, 11500.0, 15000.0, 20000.0]
_WIDTHS = [2000.0, 2600.0, 3300.0, 4600.0]
ROUTES = {
    "xla": dict(photometry_backend="xla"),
    "interp1": dict(photometry_backend="pallas", photometry_variant="interp",
                    photometry_interp_order=1),
    "interp3": dict(photometry_backend="pallas", photometry_variant="interp",
                    photometry_interp_order=3),
    "conv": dict(photometry_backend="pallas", photometry_variant="conv"),
}
MODES = {"rev": (jax.jacrev, torch.func.jacrev),
         "fwd": (jax.jacfwd, torch.func.jacfwd)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One intra-op thread per test: these loops run thousands of small
    ops, and beside the other test workers the default thread pool turns a
    1-s C2ST into minutes (measured: 1.2 s against 156 s on 8 loaded
    cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _closed_form(s, t):
    e = np.exp(t)
    return 6.0 * s * e * e * (2.0 + 3.0 * e) / (1.0 + 3.0 * e) ** 2


@pytest.mark.parametrize("mode", ["rev", "fwd"])
@pytest.mark.parametrize("s", [1.0, 1e20, 1e30])
def test_fb_slope_gradient_at_knot_scales(s, mode):
    def f(t):
        return tpk._fb_slope(s * torch.exp(t), 3.0 * s * torch.exp(2.0 * t))

    g = float(MODES[mode][1](f)(torch.tensor(0.5)))
    assert np.isfinite(g)
    assert g == pytest.approx(_closed_form(s, 0.5), rel=1e-5)


@pytest.mark.parametrize("mode", ["rev", "fwd"])
def test_knot_interp_gradient_matches_jax(mode):
    rng = np.random.default_rng(0)
    b, k, f = 6, 12, 8
    base = rng.uniform(0.5, 2.0, (b, k, f)).astype(np.float32)
    w = rng.normal(0.0, 1.0, (b, k, f)).astype(np.float32)
    s = rng.uniform(0.0, 40.0, b).astype(np.float32)
    scale = 1e30

    def jfun(t):
        vals = scale * jnp.asarray(base) * jnp.exp(t * jnp.asarray(w))
        return jpk._knot_interp(vals, jnp.asarray(s), k, 4, 3)

    def tfun(t):
        vals = scale * torch.as_tensor(base) * torch.exp(t * torch.as_tensor(w))
        return tpk._knot_interp(vals, torch.as_tensor(s), k, 4, 3)

    jf, tf = MODES[mode]
    ref = np.asarray(jf(jfun)(jnp.float32(0.1)))
    port = tf(tfun)(torch.tensor(0.1)).numpy()
    assert np.isfinite(port).all() and np.isfinite(ref).all()
    assert np.abs(port - ref).max() < 1e-5 * np.abs(ref).max()


def _sim(pkg, route):
    grid = pkg.make_synthetic_grid(n_ages=32, n_mets=5, n_wav=512, seed=0)
    filt = pkg.FilterSet([pkg.tophat_filter(f"F{i}", c, w) for i, (c, w)
                          in enumerate(zip(_CENTERS, _WIDTHS))])
    kw = dict(ROUTES[route])
    if pkg is tt:
        kw["device"] = "cpu"
    return pkg.BatchSEDSimulator(grid, filt, PNAMES,
                                 emission=pkg.EmissionConfig(igm="inoue14"),
                                 **kw)


@functools.lru_cache(maxsize=None)
def _pair(route):
    jsim, tsim = _sim(jst, route), _sim(tt, route)
    if route != "conv":  # conv keeps no knot matrix to load
        tsim.load_state(_jax_state(jsim))
    jsim._mega_off = True
    return jsim, tsim


def _theta(n=4):
    rng = np.random.default_rng(3)
    return np.column_stack([
        rng.uniform(8, 11, n), rng.uniform(0.05, 8, n),
        rng.uniform(1e8, 1e9, n), rng.uniform(.1, 1.2, n),
        rng.uniform(-3.5, -2, n), rng.uniform(0, 2, n)]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_jacobian(route, mode):
    jsim, _ = _pair(route)
    jf = MODES[mode][0](lambda r: jsim.photometry(r[None])[0])
    return np.asarray(jax.jit(jax.vmap(jf))(jnp.asarray(_theta())))


@pytest.mark.parametrize("mode", ["rev", "fwd"])
@pytest.mark.parametrize("route,mega_off", [
    ("xla", True), ("interp1", True), ("interp3", True), ("conv", True),
    ("interp1", False), ("interp3", False)])
def test_photometry_jacobian_matches_jax(route, mega_off, mode):
    _, tsim = _pair(route)
    tsim._mega_off = mega_off
    try:
        tf = MODES[mode][1](lambda r: tsim.photometry(r[None])[0])
        port = torch.func.vmap(tf)(torch.as_tensor(_theta())).numpy()
    finally:
        tsim._mega_off = False
    ref = _jax_jacobian(route, mode)
    assert np.isfinite(port).all()
    col_max = np.abs(ref).max(axis=1, keepdims=True)  # (B, 1, P)
    assert (np.abs(port - ref) <= 1e-4 * col_max).all(), \
        (np.abs(port - ref) / col_max).max()


@pytest.mark.parametrize("route", ["interp3", "conv"])
def test_bright_galaxy_gradient_is_finite(route):
    from synference_tpu import mcmc as jm
    from synference_tpu_torch import mcmc as tm

    jsim, tsim = _pair(route)
    theta = np.array([[11.0, 0.05, 3e8, 0.5, -2.0, 0.1],
                      [11.0, 0.12, 1e9, 0.3, -2.3, 0.3]], np.float32)
    obs = 0.5 * np.asarray(jsim.photometry(jnp.asarray(theta)))
    sig = np.full_like(obs, 1.15)
    ref = np.asarray(jax.jit(jax.grad(
        lambda t: jm.censored_gaussian_loglike_rows(
            jsim.photometry(t), obs, sig).sum()))(jnp.asarray(theta)))
    t = torch.as_tensor(theta).requires_grad_(True)
    with tm._plain_route(tsim):
        ll = tm.censored_gaussian_loglike_rows(
            tsim.photometry(t), torch.as_tensor(obs), torch.as_tensor(sig))
    (g,) = torch.autograd.grad(ll.sum(), t)
    assert torch.isfinite(g).all()
    keep = [0, 2, 3, 4, 5]
    np.testing.assert_allclose(g.numpy()[:, keep], ref[:, keep], rtol=1e-5)


def test_mega_off_takes_the_plain_route():
    _, tsim = _pair("interp3")
    assert tsim._mega_supported() and tsim._window_mega_supported()
    theta = torch.as_tensor(_theta(16))
    tsim._mega_off = True
    try:
        assert not tsim._mega_supported()
        assert not tsim._window_mega_supported()
        got = tsim.photometry(theta)
        params = tsim.theta_dict(theta)
        sfzh, _ = tsim._sfzh(params)
        lnu, _ = tsim._apply_emission(params, sfzh, trimmed=True)
        ref = tsim._photometry_fused(lnu, params["redshift"])
        assert torch.equal(got, ref)
        with pytest.raises(ValueError, match="fused"):
            tsim.photometry_zsorted_device(
                theta[torch.argsort(theta[:, 1])], fused=True)
    finally:
        tsim._mega_off = False
    assert type(tsim)._mega_off is False


def test_k2_plain_version_is_differentiable_on_the_cpu():
    """The CPU branch of the K2 wrapper stays the plain version, with a
    gradient."""
    _, tsim = _pair("interp3")
    theta = torch.as_tensor(_theta(8)).requires_grad_(True)
    out = tsim.photometry(theta)
    (g,) = torch.autograd.grad(out.sum(), theta)
    assert torch.isfinite(g).all() and (g.abs().sum(dim=1) > 0).all()
    assert tfs.fused_sed_photometry.launches == 0


def test_refuse_autodiff_cases():
    t = torch.ones(4)
    refuse_autodiff("k", t, None, 3)  # plain tensors and non-tensors pass
    leaf = torch.ones(4, requires_grad=True)
    with pytest.raises(RuntimeError, match="_mega_off"):
        refuse_autodiff("k", t, leaf)
    with torch.no_grad():
        refuse_autodiff("k", leaf)  # no gradient is being recorded
    with forward_ad.dual_level():
        dual = forward_ad.make_dual(torch.ones(4), torch.ones(4))
        with pytest.raises(RuntimeError, match="forward-AD"):
            refuse_autodiff("k", dual)
        refuse_autodiff("k", t)


@pytest.mark.parametrize("transform", ["jacrev", "jacfwd", "vmap"])
def test_refuse_autodiff_inside_torch_func(transform):
    def f(x):
        refuse_autodiff("k", x)
        return x * 2.0

    with pytest.raises(RuntimeError, match="torch.func"):
        getattr(torch.func, transform)(f)(torch.ones(3))
