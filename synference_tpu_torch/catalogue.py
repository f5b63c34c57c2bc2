"""Catalogue fitting: OOD screening, missing-band marginalisation (SBI++),
batched posterior quantiles.

Counterpart of `synference_tpu/catalogue.py`:

- `fit_catalogue`: replay the features on a catalogue, vote on which
  objects lie out of the training distribution, sample every object's
  posterior in one pass (or pool it over imputations of missing bands), and
  return per-parameter quantile columns; with a simulator, also push the
  draws back through the forward model (`reconstruct_photometry`, K2 on
  the card) and recover SED bands (`recover_seds_batched`, K3 for the
  roll/bank variants).
- `ood_vote`: the eight-method majority vote. Mahalanobis runs on the device
  in float32 as in the JAX package; ECOD, HBOS, kNN and PCA on the device in
  float64 (the JAX package runs them in float64 numpy); isolation forest,
  LOF and the elliptic envelope call scikit-learn on the host, imported
  when asked for.
- `MissingPhotometryHandler`: χ² nearest neighbours over the library in the
  valid bands, a weighted-KDE draw per missing band, optional rescatter
  through a noise model.

Randomness comes from a `torch.Generator`, or draws passed in (`base=` for
posterior normals, `comp=` / `jitter=` for the KDE draw). The MCMC
convergence columns of the JAX package's `fit_catalogue` wait for the MCMC
posteriors (ROADMAP M13).
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "mahalanobis_ood",
    "ood_vote",
    "ood_feature_contributions",
    "compare_methods_feature_importance",
    "MissingPhotometryHandler",
    "reconstruct_photometry",
    "recover_seds_batched",
    "fit_catalogue",
    "fit_catalogue_table",
]

OOD_METHODS = ("mahalanobis", "iforest", "lof", "elliptic", "ecod", "hbos",
               "knn", "pca")
_SKLEARN_METHODS = ("iforest", "lof", "elliptic")
# elements of one kNN distance block (rows × library), float64
_KNN_BLOCK = 1 << 25
# elements of one χ² block (objects × library × bands), float32
_CHI2_BLOCK = 1 << 26


def _tensor(a, device, dtype):
    return torch.atleast_2d(torch.as_tensor(a, dtype=dtype, device=device))


def _quantile(values, q: float):
    """np.quantile's default (linear) quantile of a 1-D tensor, by sort
    (torch.quantile refuses inputs above 2^24 elements)."""
    s = torch.sort(values.flatten()).values
    pos = q * (s.shape[0] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, s.shape[0] - 1)
    t = pos - lo
    a, b = s[lo], s[hi]
    # numpy's lerp: from the upper end when t >= 0.5
    return b - (b - a) * (1.0 - t) if t >= 0.5 else a + (b - a) * t


# ---------------------------------------------------------------------------
# Out-of-distribution detection
# ---------------------------------------------------------------------------


def _moments(train, test, method: str):
    """(test − μ, covariance) of the train set; "robust_mahalanobis" takes
    them from the central 90% by a first-pass standardised distance."""
    if method == "robust_mahalanobis":
        mu0 = train.mean(0)
        sd0 = train.std(0, correction=0) + 1e-12
        r2 = (((train - mu0) / sd0) ** 2).sum(1)
        w = (r2 <= _quantile(r2, 0.9)).to(train.dtype)
        mu = (train * w[:, None]).sum(0) / w.sum()
        xc = (train - mu) * w[:, None]
        cov = (xc.T @ xc) / (w.sum() - 1.0)
    else:
        mu = train.mean(0)
        xc = train - mu
        cov = (xc.T @ xc) / (train.shape[0] - 1)
    return test - mu, cov


def _precision(cov, shrinkage: float):
    d = cov.shape[0]
    eye = torch.eye(d, dtype=cov.dtype, device=cov.device)
    return torch.linalg.inv(cov + shrinkage * torch.trace(cov) / d * eye)


def mahalanobis_ood(train, test, chi2_quantile: float = 0.999,
                    shrinkage: float = 1.0e-3, *, device):
    """Mahalanobis OOD flag in float32 on `device`: (is_outlier (M,),
    distances (M,)) as numpy, the threshold the χ² quantile of the feature
    dimension."""
    from scipy.stats import chi2

    train = _tensor(train, device, torch.float32)
    diff, cov = _moments(train, _tensor(test, device, torch.float32),
                         "mahalanobis")
    dist2 = ((diff @ _precision(cov, shrinkage)) * diff).sum(1)
    thresh = chi2.ppf(chi2_quantile, df=cov.shape[0])
    return ((dist2 > thresh).cpu().numpy(),
            torch.sqrt(dist2).cpu().numpy())


def ood_feature_contributions(train, test, method: str = "mahalanobis",
                              feature_names=None, confidence: float = 0.95,
                              shrinkage: float = 1.0e-3, *, device):
    """Per-feature attribution of a distance-based OOD score, float32 on
    `device`: for Mahalanobis d² = Σ_i diff_i (P diff)_i, contribution i
    that summand; "standardized_euclidean" the z-scores²;
    "robust_mahalanobis" (μ, Σ) from the central 90% of the train set.

    Returns feature_contributions (M, D), total_distances (M,),
    feature_importance (D,) (mean |contribution|, summing to 1),
    outlier_mask (M,), threshold, feature_names, method."""
    from scipy.stats import chi2

    if method not in ("mahalanobis", "robust_mahalanobis",
                      "standardized_euclidean"):
        raise ValueError(
            f"method {method!r} not in ('mahalanobis', "
            "'robust_mahalanobis', 'standardized_euclidean')")
    train = _tensor(train, device, torch.float32)
    d = train.shape[1]
    if feature_names is None:
        feature_names = [f"feature_{i}" for i in range(d)]
    diff, cov = _moments(train, _tensor(test, device, torch.float32), method)
    if method == "standardized_euclidean":
        contrib = diff**2 / (torch.diag(cov) + 1e-12)
    else:
        contrib = diff * (diff @ _precision(cov, shrinkage))
    dist = torch.sqrt(torch.clamp(contrib.sum(1), min=0.0))
    importance = contrib.abs().mean(0)
    importance = importance / importance.sum()
    thresh = float(np.sqrt(chi2.ppf(confidence, df=d)))
    return {
        "feature_names": list(feature_names),
        "method": method,
        "feature_contributions": contrib.cpu().numpy(),
        "total_distances": dist.cpu().numpy(),
        "feature_importance": importance.cpu().numpy(),
        "outlier_mask": (dist > thresh).cpu().numpy(),
        "threshold": thresh,
    }


def compare_methods_feature_importance(train, test, feature_names=None,
                                       confidence: float = 0.95, *, device):
    """`ood_feature_contributions` for the three distance methods, plus
    "agreement": the mean pairwise Spearman rank correlation of their
    importances (1.0 = every method ranks the features alike)."""
    methods = ("mahalanobis", "robust_mahalanobis", "standardized_euclidean")
    out = {m: ood_feature_contributions(
        train, test, method=m, feature_names=feature_names,
        confidence=confidence, device=device) for m in methods}
    ranks = [np.argsort(np.argsort(out[m]["feature_importance"])).astype(
        np.float64) for m in methods]
    cors = []
    for i in range(len(ranks)):
        for j in range(i + 1, len(ranks)):
            a = (ranks[i] - ranks[i].mean()) / max(ranks[i].std(), 1e-12)
            b = (ranks[j] - ranks[j].mean()) / max(ranks[j].std(), 1e-12)
            cors.append(float((a * b).mean()))
    out["agreement"] = float(np.mean(cors))
    return out


def _flag_by_train_quantile(score_train, score_test, contamination: float):
    """Flag test scores above the (1 − c) quantile of the train scores
    (PyOD's thresholding convention)."""
    return score_test > _quantile(score_train, 1.0 - contamination)


def _ecod_scores(train, test):
    """ECOD (Li et al. 2022): per-dimension empirical tail probabilities,
    summed −log left/right tails, skewness-selected. float64 tensors."""
    n = train.shape[0]
    sorted_cols = torch.sort(train.T.contiguous(), dim=1).values  # (D, N)
    skew = (((train - train.mean(0)) ** 3).mean(0)
            / torch.clamp(train.std(0, correction=0) ** 3, min=1e-12))
    scores = []
    for x in (train, test):
        xt = x.T.contiguous()
        left = (torch.searchsorted(sorted_cols, xt, right=True).T
                .to(train.dtype) / (n + 1))
        right = 1.0 - (torch.searchsorted(sorted_cols, xt).T
                       .to(train.dtype) / (n + 1))
        o_l = -torch.log(torch.clamp(left, 1.0 / (n + 1), 1.0))
        o_r = -torch.log(torch.clamp(right, 1.0 / (n + 1), 1.0))
        o_auto = torch.where(skew[None, :] < 0, o_l, o_r)
        scores.append(torch.maximum(torch.maximum(o_l.sum(1), o_r.sum(1)),
                                    o_auto.sum(1)))
    return scores


def _histogram_edges(col, n_bins: int):
    """`np.histogram`'s bin edges: a float64 linspace from the column's min
    to its max (widened by ±0.5 when they are equal)."""
    lo, hi = col.min(), col.max()
    if bool(lo == hi):
        lo, hi = lo - 0.5, hi + 0.5
    step = (hi - lo) / n_bins
    edges = torch.arange(n_bins + 1, dtype=col.dtype, device=col.device) \
        * step + lo
    edges[-1] = hi
    return edges


def _hbos_scores(train, test, n_bins: int = 20):
    """HBOS: per-dimension histogram density, score = Σ −log density.
    float64 tensors; bins are [e_i, e_i+1), the last closed, as
    `np.histogram` bins them."""
    scores_tr = torch.zeros(train.shape[0], dtype=train.dtype,
                            device=train.device)
    scores_te = torch.zeros(test.shape[0], dtype=test.dtype,
                            device=test.device)
    for col, col_te in zip(train.T.contiguous(), test.T.contiguous()):
        edges = _histogram_edges(col, n_bins)
        idx = torch.clamp(torch.bucketize(col, edges, right=True) - 1, 0,
                          n_bins - 1)
        counts = torch.bincount(idx, minlength=n_bins).to(train.dtype)
        hist = counts / torch.diff(edges) / counts.sum()
        hist = torch.clamp(hist, min=1e-12)
        for x, out in ((col, scores_tr), (col_te, scores_te)):
            # np.digitize(x, edges) − 1, clipped
            k = torch.clamp(torch.bucketize(x, edges, right=True) - 1, 0,
                            n_bins - 1)
            dens = torch.where((x < edges[0]) | (x > edges[-1]), 1e-12,
                               hist[k])
            out += -torch.log(dens)
    return scores_tr, scores_te


def _knn_scores(train, test, k: int = 10):
    """Distance to the k-th nearest training point (np.partition's k-th,
    counting a point's own zero distance), in row blocks of at most
    `_KNN_BLOCK` distances. Squared distances come from |x|² + |t|² − 2x·t
    about the train mean (distances are shift invariant; centring keeps the
    cancellation small)."""
    mu = train.mean(0)
    t = train - mu
    tt = (t * t).sum(1)
    rows = max(1, _KNN_BLOCK // train.shape[0])

    def kth(x):
        x = x - mu
        out = torch.empty(x.shape[0], dtype=x.dtype, device=x.device)
        for i in range(0, x.shape[0], rows):
            xb = x[i:i + rows]
            # |t|² − 2x·t orders the row as d² does; |x|² is added after
            part = torch.addmm(tt[None, :], xb, t.T, alpha=-2.0)
            vals = torch.topk(part, k + 1, dim=1, largest=False).values
            d2 = vals[:, k] + (xb * xb).sum(1)
            out[i:i + rows] = torch.sqrt(torch.clamp(d2, min=0.0))
        return out

    return kth(train), kth(test)


def _pca_scores(train, test, var_frac: float = 0.9):
    """Reconstruction error after projecting onto the leading principal
    components that hold `var_frac` of the variance. float64 tensors."""
    mu = train.mean(0)
    _, s, vt = torch.linalg.svd(train - mu, full_matrices=False)
    var = (s**2 / (s**2).sum()).cpu().numpy()
    n_pc = max(1, int(np.searchsorted(np.cumsum(var), var_frac) + 1))
    n_pc = min(n_pc, vt.shape[0] - 1) if vt.shape[0] > 1 else 1
    v = vt[:n_pc]

    def err(x):
        d = x - mu
        return torch.sqrt(((d - (d @ v.T) @ v) ** 2).sum(-1))

    return err(train), err(test)


_SCORE_METHODS = {"ecod": _ecod_scores, "hbos": _hbos_scores,
                  "knn": _knn_scores, "pca": _pca_scores}


def _sklearn_flags(method: str, train, test, random_state: int):
    """One of scikit-learn's detectors, fitted on the train set (host)."""
    try:
        if method == "iforest":
            from sklearn.ensemble import IsolationForest

            clf = IsolationForest(random_state=random_state,
                                  n_estimators=100)
        elif method == "lof":
            from sklearn.neighbors import LocalOutlierFactor

            clf = LocalOutlierFactor(novelty=True, n_neighbors=20)
        else:
            from sklearn.covariance import EllipticEnvelope

            clf = EllipticEnvelope(random_state=random_state,
                                   support_fraction=0.9)
    except ImportError as e:
        raise ImportError(
            f"OOD method {method!r} needs scikit-learn, which is not "
            "installed; install it or leave the method out of `methods`"
        ) from e
    clf.fit(train)
    return clf.predict(test) == -1


def ood_vote(train, test, methods=OOD_METHODS, vote_fraction: float = 0.5,
             random_state: int = 0, contamination: float = 0.02, *, device):
    """Multi-method OOD majority vote: an object is flagged when at least
    `vote_fraction` of `methods` flag it. Score methods threshold at the
    (1 − contamination) quantile of their train scores. A method that
    cannot run raises; the vote never runs over fewer methods than asked.

    Returns (flags (M,) bool, votes (len(methods), M) int), numpy."""
    unknown = [m for m in methods if m not in OOD_METHODS]
    if unknown:
        raise ValueError(f"unknown OOD methods {unknown}")
    train64 = _tensor(train, device, torch.float64)
    test64 = _tensor(test, device, torch.float64)
    votes = []
    for m in methods:
        if m == "mahalanobis":
            flag, _ = mahalanobis_ood(train64, test64, device=device)
        elif m in _SKLEARN_METHODS:
            flag = _sklearn_flags(m, train64.cpu().numpy(),
                                  test64.cpu().numpy(), random_state)
        else:
            s_tr, s_te = _SCORE_METHODS[m](train64, test64)
            flag = _flag_by_train_quantile(s_tr, s_te,
                                           contamination).cpu().numpy()
        votes.append(np.asarray(flag).astype(int))
    votes = np.stack(votes)
    return votes.mean(0) >= vote_fraction, votes


# ---------------------------------------------------------------------------
# SBI++ missing-data marginalisation
# ---------------------------------------------------------------------------


class MissingPhotometryHandler:
    """Impute missing bands from library nearest neighbours, pool posteriors.

    For an object with missing bands, the K library SEDs closest in χ² over
    the valid bands give a weighted Gaussian KDE per missing band; nmc
    imputed flux vectors are drawn from it and the posterior is pooled over
    them.

    Args:
        library_phot_njy: (N, F) noiseless library photometry, kept on
            `device`.
        k_neighbors: χ² nearest-neighbour count.
        nmc: imputations per object.
        kde_bandwidth_frac: KDE σ as a fraction of the neighbours' weighted
            std per band.
        noise_models: optional per-band sequence of NoiseModels (None entries
            allowed); each missing-band KDE draw is then rescattered through
            its band's model and takes the model's σ.
        device: where the library and the search live.
    """

    def __init__(self, library_phot_njy, k_neighbors: int = 64,
                 nmc: int = 16, kde_bandwidth_frac: float = 0.5,
                 noise_models=None, *, device):
        self.device = torch.device(device)
        self.library = _tensor(library_phot_njy, self.device, torch.float32)
        self.k = int(k_neighbors)
        self.nmc = int(nmc)
        self.bw = float(kde_bandwidth_frac)
        if noise_models is not None:
            noise_models = list(noise_models)
            if len(noise_models) != self.library.shape[1]:
                raise ValueError(
                    f"noise_models must have one entry per band "
                    f"({self.library.shape[1]}), got {len(noise_models)}")
        self.noise_models = noise_models

    def neighbours(self, flux, err, miss):
        """χ² over the valid bands against the whole library, in blocks of
        objects: (K nearest indices, their −χ²), both (M, K), nearest
        first."""
        lib = self.library
        rows = max(1, _CHI2_BLOCK // (lib.shape[0] * lib.shape[1]))
        idx, neg = [], []
        for i in range(0, flux.shape[0], rows):
            f, e, m = flux[i:i + rows], err[i:i + rows], miss[i:i + rows]
            # zero the missing entries before the arithmetic: NaN
            # placeholders would otherwise poison the sum (0·NaN = NaN)
            f_safe = torch.where(m == 1.0, 0.0, f)
            e_safe = torch.where(m == 1.0, 1.0, torch.clamp(e, min=1.0e-30))
            diff = (lib[None] - f_safe[:, None]) / e_safe[:, None]
            chi2 = ((1.0 - m)[:, None] * diff**2).sum(dim=2)  # (rows, N)
            top = torch.topk(-chi2, self.k, dim=1)
            idx.append(top.indices)
            neg.append(top.values)
        return torch.cat(idx), torch.cat(neg)

    def impute(self, generator: torch.Generator | None, flux_njy, err_njy,
               missing_mask, return_errors: bool = False, *, comp=None,
               jitter=None):
        """(M, nmc, F) imputed flux vectors (valid bands repeated as they
        are), and with `return_errors` their σ: the observed errors for
        valid bands; for missing bands the noise-model σ when `noise_models`
        is set, else 10% + 1 nJy.

        `comp` (M, nmc) neighbour ranks and `jitter` (M, nmc, F) standard
        normals replace the draws from `generator`."""
        dev = self.device
        flux = _tensor(flux_njy, dev, torch.float32)
        err = torch.clamp(_tensor(err_njy, dev, torch.float32), min=1.0e-3)
        miss = _tensor(missing_mask, dev, torch.float32)
        m, n_f = flux.shape
        idx, neg = self.neighbours(flux, err, miss)
        w = torch.softmax(0.5 * neg, dim=1)  # ∝ exp(−χ²/2)
        neigh = self.library[idx]  # (M, K, F)
        mu_w = (w[..., None] * neigh).sum(dim=1)
        var_w = (w[..., None] * (neigh - mu_w[:, None]) ** 2).sum(dim=1)
        sd = torch.sqrt(torch.clamp(var_w, min=1.0e-12)) * self.bw
        if comp is None:
            comp = torch.multinomial(torch.clamp(w, min=1.0e-12), self.nmc,
                                     replacement=True, generator=generator)
        comp = torch.as_tensor(comp, device=dev).long()
        if jitter is None:
            jitter = torch.randn((m, self.nmc, n_f), generator=generator,
                                 device=dev)
        jitter = torch.as_tensor(jitter, dtype=torch.float32, device=dev)
        base = torch.gather(neigh, 1, comp[..., None].expand(-1, -1, n_f))
        drawn = base + sd[:, None] * jitter
        miss3 = miss[:, None, :].expand(-1, self.nmc, -1)
        imputed = torch.where(miss3 == 1.0, drawn, flux[:, None, :])
        sig = torch.where(miss3 == 1.0, 0.1 * imputed.abs() + 1.0,
                          err[:, None, :].expand_as(imputed))
        if self.noise_models is not None:
            # the KDE draw is the true flux: rescatter it through the band's
            # model, so the imputed vector carries realistic noise and σ
            imputed, sig = imputed.clone(), sig.clone()
            for j, model in enumerate(self.noise_models):
                if model is None:
                    continue
                scat, s_j = model.apply(generator, imputed[..., j])
                hit = miss3[..., j] == 1.0
                imputed[..., j] = torch.where(hit, scat, imputed[..., j])
                sig[..., j] = torch.where(hit, s_j, sig[..., j])
        if return_errors:
            return imputed, sig
        return imputed

    def process_observations(self, generator, posterior, feature_fn,
                             flux_njy, err_njy, missing_mask,
                             n_samples: int = 1000, *, comp=None,
                             jitter=None, base=None):
        """(M, n_samples, P) posterior draws pooled over each object's
        imputations. `feature_fn(flux (B, F), err (B, F)) -> (B, D)` turns
        imputed vectors into features; `base` holds the posterior's base
        normals for the M·nmc imputed objects."""
        imputed, sig = self.impute(generator, flux_njy, err_njy, missing_mask,
                                   return_errors=True, comp=comp,
                                   jitter=jitter)
        m, nmc, n_f = imputed.shape
        feats = feature_fn(imputed.reshape(m * nmc, n_f),
                           sig.reshape(m * nmc, n_f))
        per = -(-n_samples // nmc)  # never fewer draws than asked
        with torch.no_grad():
            samples = posterior.sample_batch(feats, per, generator, base=base)
        return samples.reshape(m, nmc * per, -1)[:, :n_samples]


# ---------------------------------------------------------------------------
# fit_catalogue
# ---------------------------------------------------------------------------


def _simulator_columns(samples, parameter_names, simulator):
    """(M, S, P_fit) draws -> (M, S, P_sim) in the simulator's θ order;
    raises when the fitter's columns do not cover the simulator's."""
    names = list(parameter_names)
    missing = [p for p in simulator.param_names if p not in names]
    if missing:
        raise ValueError(
            f"simulator parameters {missing} not among fitter parameters "
            f"{names}; rebuild the simulator with "
            "`library.simulator_from_library` on the training library")
    return samples[..., [names.index(p) for p in simulator.param_names]]


def reconstruct_photometry(simulator, samples, parameter_names,
                           max_draws: int = 64, chunk: int = 16384):
    """(M, min(S, max_draws), F) band fluxes [nJy] of posterior draws
    (M, S, P_fit), through `simulator.photometry` in chunks of `chunk`
    rows (K2 on the card)."""
    draws = _simulator_columns(np.asarray(samples, np.float32)[:, :max_draws],
                               parameter_names, simulator)
    m, s, p = draws.shape
    flat = torch.as_tensor(draws.reshape(m * s, p), device=simulator.device)
    with torch.no_grad():
        out = torch.cat([simulator.photometry(flat[i:i + chunk])
                         for i in range(0, flat.shape[0], chunk)])
    return out.cpu().numpy().reshape(m, s, -1)


def recover_seds_batched(simulator, samples, parameter_names,
                         quantiles=(0.16, 0.5, 0.84), max_draws: int = 32,
                         rows_per_call: int = 4096):
    """Per-object observed-frame SED quantile bands from posterior draws,
    through `simulate(want_spectra=True)` in calls of about `rows_per_call`
    rows (objects × draws).

    Returns lam (M, L): the rest grid × the posterior-mean (1+z);
    lam_rest (L,); fnu_quantiles (M, Q, L) [nJy]; quantiles."""
    draws = _simulator_columns(np.asarray(samples, np.float32)[:, :max_draws],
                               parameter_names, simulator)
    m, s, p = draws.shape
    obj_chunk = max(1, rows_per_call // s)
    qs = []
    for i in range(0, m, obj_chunk):
        blk = torch.as_tensor(draws[i:i + obj_chunk].reshape(-1, p),
                              device=simulator.device)
        with torch.no_grad():
            fnu = simulator.simulate(blk, want_spectra=True)["fnu_njy"]
        fnu = fnu.cpu().numpy().reshape(-1, s, fnu.shape[-1])
        qs.append(np.moveaxis(np.quantile(fnu, quantiles, axis=1), 0, 1))
    lam_rest = np.asarray(simulator.grid.lam)
    zp1 = np.ones(m)
    if "redshift" in simulator.param_names:
        zc = draws[:, :, list(simulator.param_names).index("redshift")]
        zp1 = np.mean(1.0 + np.maximum(zc, 0.0), axis=1)
    return {"lam": lam_rest[None, :] * zp1[:, None], "lam_rest": lam_rest,
            "fnu_quantiles": np.concatenate(qs, axis=0),
            "quantiles": list(quantiles)}


def fit_catalogue(fitter, flux, flux_err, flux_unit: str = "nJy",
                  missing_mask=None, n_samples: int = 1000,
                  quantiles=(0.16, 0.5, 0.84), check_ood: bool = True,
                  ood_methods=OOD_METHODS,
                  missing_data_handler: MissingPhotometryHandler | None = None,
                  simulator=None, recon_draws: int = 64,
                  recover_seds: bool = False, sed_draws: int = 32,
                  generator: torch.Generator | None = None, base=None):
    """Fit an observed catalogue with a trained fitter, on its device.

    Returns a dict of columns: `{param}_q{percent}` per fitted parameter and
    quantile, `flag_ood` / `ood_votes`, `n_missing`,
    `sampling_acceptance`, and the raw draws under "_samples" and the
    features under "_features". With `simulator`, also
    `recon_{filter}_q{p}` from `recon_draws` draws per object (and
    "_recon_photometry"); with `recover_seds`, SED bands under
    "_recovered_seds".

    Objects with missing bands are pooled over imputations when a
    `missing_data_handler` is given. Draws come from `generator` (seed 0 on
    the fitter's device when None), or the posterior's base normals `base`.
    """
    if generator is None:
        generator = torch.Generator(device=fitter.device).manual_seed(0)
    flux = np.atleast_2d(np.asarray(flux, np.float32))
    flux_err = np.atleast_2d(np.asarray(flux_err, np.float32))
    feats = fitter.features_from_observations(flux, flux_err, flux_unit,
                                              missing_mask=missing_mask)
    out = {}
    if check_ood and fitter.features is not None:
        flags, votes = ood_vote(fitter.features, feats, methods=ood_methods,
                                device=fitter.device)
        out["flag_ood"] = flags
        out["ood_votes"] = votes.sum(axis=0)
    if missing_mask is not None:
        out["n_missing"] = np.asarray(missing_mask).sum(axis=1).astype(int)
    if missing_mask is not None and missing_data_handler is not None:
        from . import units as U

        flux_njy = U.convert_flux(flux, flux_unit, "nJy")
        err_njy = U.convert_flux_err(flux, flux_err, flux_unit, "nJy")

        def feature_fn(fl, er):
            return fitter.features_from_observations(fl, er, "nJy")

        samples = missing_data_handler.process_observations(
            generator, fitter.posterior, feature_fn, flux_njy, err_njy,
            missing_mask, n_samples, base=base).cpu().numpy()
    else:
        with torch.no_grad():
            samples, acc = fitter.posterior.sample_batch_with_acceptance(
                feats, n_samples, generator, base=base)
        samples = samples.cpu().numpy()
        # in-support fraction of the raw flow draws per object: well below
        # 1 flags posterior mass clipped onto the prior's faces
        out["sampling_acceptance"] = acc.cpu().numpy()
    for i, name in enumerate(fitter.parameter_names):
        for q in quantiles:
            out[f"{name}_q{int(round(q * 100))}"] = np.quantile(
                samples[..., i], q, axis=1)
    if simulator is not None:
        recon = reconstruct_photometry(simulator, samples,
                                       fitter.parameter_names,
                                       max_draws=recon_draws)
        for j, code in enumerate(simulator.filters.codes):
            for q in quantiles:
                out[f"recon_{code}_q{int(round(q * 100))}"] = np.quantile(
                    recon[:, :, j], q, axis=1)
        out["_recon_photometry"] = recon
        if recover_seds:
            out["_recovered_seds"] = recover_seds_batched(
                simulator, samples, fitter.parameter_names,
                quantiles=quantiles, max_draws=sed_draws)
    elif recover_seds:
        raise ValueError(
            "recover_seds=True needs `simulator` (rebuild one with "
            "library.simulator_from_library on the training library)")
    out["_samples"] = samples
    out["_features"] = feats
    return out


def fit_catalogue_table(fitter, observations, flux_columns, err_columns,
                        flux_unit: str = "nJy", missing_data_flag=None,
                        append_to_input: bool = True,
                        save_path: str | None = None, **kwargs):
    """Table-level catalogue fitting: a pandas DataFrame (or a dict of
    equal-length columns) in, a DataFrame out.

    `flux_columns` / `err_columns` follow `fitter.filter_codes`; entries
    equal to `missing_data_flag` (and non-finite fluxes) become the
    missing-band mask. With `append_to_input` the result columns are added
    to a copy of the input, else they stand beside an ID column. `save_path`
    writes the table as CSV. `kwargs` go to `fit_catalogue`.

    Returns (DataFrame, the raw `fit_catalogue` dict)."""
    import pandas as pd

    if not isinstance(observations, pd.DataFrame):
        observations = pd.DataFrame(observations)
    if (len(flux_columns) != len(fitter.filter_codes)
            or len(err_columns) != len(fitter.filter_codes)):
        raise ValueError(
            f"need one flux and one err column per fitter filter "
            f"({len(fitter.filter_codes)}), got {len(flux_columns)} flux / "
            f"{len(err_columns)} err")
    absent = [c for c in tuple(flux_columns) + tuple(err_columns)
              if c not in observations.columns]
    if absent:
        raise ValueError(f"columns not in the table: {absent}")
    flux = observations[list(flux_columns)].to_numpy(np.float32)
    err = observations[list(err_columns)].to_numpy(np.float32)
    missing_mask = kwargs.pop("missing_mask", None)
    if missing_data_flag is not None and missing_mask is None:
        missing_mask = ((flux == missing_data_flag)
                        | ~np.isfinite(flux)).astype(np.float32)
    out = fit_catalogue(fitter, flux, err, flux_unit,
                        missing_mask=missing_mask, **kwargs)
    table = observations.copy() if append_to_input else pd.DataFrame(
        {"ID": (observations["ID"] if "ID" in observations.columns
                else np.arange(len(observations)) + 1)})
    n = len(observations)
    for k, v in out.items():
        if isinstance(v, dict):
            continue
        arr = np.asarray(v)
        if arr.ndim == 1 and arr.shape[0] == n:
            table[k] = arr
    if save_path is not None:
        table.to_csv(save_path, index=False)
    return table, out
