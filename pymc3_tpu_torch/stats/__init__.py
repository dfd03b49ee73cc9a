"""Diagnostics and model comparison (cf. ``pymc3_tpu/stats/__init__.py``).

Rank-normalized split R-hat, bulk ESS (FFT autocorrelation, Geyer's initial
monotone sequence), HPD intervals, Geweke, BFMI, Bayesian R², the summary
table, PSIS-LOO, WAIC and ``compare``, on the host in numpy; the pointwise
log-likelihood matrix behind LOO and WAIC is evaluated on the model's
device. Inputs are upcast to float64: a float32 reduction over millions of
draws drifts by a visible fraction of a posterior sd. ``summary`` and
``compare`` return DataFrames and import pandas when called; nothing else
needs it. ``rhat_device`` and ``ess_device`` run on the card
(``stats/device.py``).
"""
from __future__ import annotations

import functools
import warnings
from collections import namedtuple
from typing import Dict

import numpy as np
import torch

from ..config import floatX, get_config

__all__ = [
    "bfmi", "compare", "ess", "geweke", "hpd", "loo", "mcse", "r2_score",
    "rhat", "summary", "waic", "rhat_device", "ess_device",
    # deprecated aliases kept for parity (stats/__init__.py:56-80)
    "effective_n", "gelman_rubin", "map_args",
]

from .device import rhat_device, ess_device  # noqa: E402


def map_args(func):
    """Rename deprecated ``varnames`` kwarg (cf. ``stats/__init__.py:26``)."""

    @functools.wraps(func)
    def wrapped(*args, **kwargs):
        if "varnames" in kwargs and "var_names" not in kwargs:
            warnings.warn(
                "Keyword argument `varnames` renamed to `var_names`",
                DeprecationWarning)
            kwargs["var_names"] = kwargs.pop("varnames")
        return func(*args, **kwargs)
    return wrapped


def _trace_to_arrays(trace, var_names=None, combine=False,
                     include_transformed=False):
    """Extract {name: (chains, draws, *shape) arrays} from a MultiTrace,
    dict, or array.

    Float inputs are upcast to float64: the diagnostics reduce over
    chains*draws samples, and a sequential float32 accumulation drifts
    ~0.2 posterior sds by 1M draws (caught by the benchmark moment gate
    at 512 chains)."""
    def _f64(v):
        v = np.asarray(v)
        return v.astype(np.float64) if v.dtype.kind == "f" else v

    if isinstance(trace, dict):
        return {k: np.atleast_2d(_f64(v))[None] if np.asarray(v).ndim < 2
                else _f64(v)[None] for k, v in trace.items()}
    if isinstance(trace, np.ndarray):
        arr = _f64(trace)
        if arr.ndim == 1:
            arr = arr[None, :]
        return {"x": arr}
    # MultiTrace
    if var_names is None:
        var_names = [v for v in trace.varnames
                     if include_transformed or not v.endswith("__")]
    out = {}
    for name in var_names:
        chains = [trace.get_values(name, chains=[c]) for c in trace.chains]
        out[name] = _f64(np.stack(chains, axis=0))
    return out


def _split_chains(ary):
    """(chains, draws, ...) -> (2*chains, draws//2, ...)."""
    c, n = ary.shape[:2]
    half = n // 2
    return np.concatenate([ary[:, :half], ary[:, half:2 * half]], axis=0)


def _z_scale(ary):
    """Rank-normalization (Vehtari et al. 2019)."""
    # imported here: scipy.stats takes seconds to load, and only the
    # diagnostics need it
    from scipy import stats as st
    r = st.rankdata(ary, method="average").reshape(ary.shape)
    z = st.norm.ppf((r - 0.5) / ary.size)
    return z


def _rhat_single(ary):
    """Split R-hat on (chains, draws) array."""
    ary = _split_chains(np.asarray(ary, dtype=np.float64))
    m, n = ary.shape
    if n < 2:
        return np.nan
    chain_mean = ary.mean(axis=1)
    chain_var = ary.var(axis=1, ddof=1)
    between = n * chain_mean.var(ddof=1)
    within = chain_var.mean()
    vhat = (n - 1) / n * within + between / n
    if within == 0:
        return np.nan
    return np.sqrt(vhat / within)


def _rhat_rank(ary):
    """Rank-normalized split R-hat: max of bulk and tail (folded) variants."""
    ary = np.asarray(ary, dtype=np.float64)
    rhat_bulk = _rhat_single(_z_scale(ary))
    folded = np.abs(ary - np.median(ary))
    rhat_tail = _rhat_single(_z_scale(folded))
    return max(rhat_bulk, rhat_tail)


def _autocov(ary):
    """Per-chain autocovariance via FFT, shape (chains, draws)."""
    n = ary.shape[1]
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    centered = ary - ary.mean(axis=1, keepdims=True)
    f = np.fft.rfft(centered, m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n].real
    return acov / n


def _ess_single(ary, relative=False):
    """Bulk ESS on (chains, draws) (Geyer initial monotone sequence)."""
    ary = _split_chains(np.asarray(ary, dtype=np.float64))
    m, n = ary.shape
    if n < 4:
        return np.nan
    acov = _autocov(ary)
    chain_mean = ary.mean(axis=1)
    mean_var = acov[:, 0].mean() * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n
    if m > 1:
        var_plus += chain_mean.var(ddof=1)
    if var_plus == 0:
        return np.nan

    rho_hat_t = np.zeros(n)
    rho_hat_even = 1.0
    rho_hat_t[0] = rho_hat_even
    rho_hat_odd = 1.0 - (mean_var - acov[:, 1].mean()) / var_plus
    rho_hat_t[1] = rho_hat_odd
    # Geyer's initial positive sequence
    t = 1
    while t < (n - 3) and (rho_hat_even + rho_hat_odd) > 0.0:
        rho_hat_even = 1.0 - (mean_var - acov[:, t + 1].mean()) / var_plus
        rho_hat_odd = 1.0 - (mean_var - acov[:, t + 2].mean()) / var_plus
        if (rho_hat_even + rho_hat_odd) >= 0:
            rho_hat_t[t + 1] = rho_hat_even
            rho_hat_t[t + 2] = rho_hat_odd
        t += 2
    max_t = t - 2
    # improve estimation
    if rho_hat_even > 0:
        rho_hat_t[max_t + 1] = rho_hat_even
    # Geyer's initial monotone sequence
    t = 1
    while t <= max_t - 2:
        if (rho_hat_t[t + 1] + rho_hat_t[t + 2]) > \
                (rho_hat_t[t - 1] + rho_hat_t[t]):
            rho_hat_t[t + 1] = (rho_hat_t[t - 1] + rho_hat_t[t]) / 2.0
            rho_hat_t[t + 2] = rho_hat_t[t + 1]
        t += 2
    ess = m * n
    tau_hat = -1.0 + 2.0 * rho_hat_t[:max_t + 1].sum() + \
        np.max([rho_hat_t[max_t + 1], 0])
    tau_hat = max(tau_hat, 1.0 / np.log10(ess)) if ess > 10 else max(tau_hat, 1e-8)
    ess = ess / tau_hat
    return ess / (m * n) if relative else ess


def _diag_device():
    """Where ``rhat`` ranks its draws: the configured device when it is a
    card that exists, else the CPU."""
    device = torch.device(get_config().device)
    if device.type == "cuda" and not torch.cuda.is_available():
        return torch.device("cpu")
    return device


def _z_scale_columns(x):
    """:func:`_z_scale` of every column of ``x (N, k)`` at once: ties take
    their average rank, as ``scipy.stats.rankdata(method="average")``
    gives. Also returns the sorted columns."""
    N, k = x.shape
    srt, order = torch.sort(x, dim=0)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[1:] = srt[1:] != srt[:-1]
    # a run of equal values is one group; number groups apart per column
    group = torch.cumsum(new, dim=0) - 1 + N * torch.arange(
        k, device=x.device)
    pos = torch.arange(1, N + 1, dtype=x.dtype, device=x.device)[:, None]
    sums = torch.zeros(N * k, dtype=x.dtype, device=x.device).index_add_(
        0, group.reshape(-1), pos.expand(N, k).reshape(-1))
    counts = torch.zeros_like(sums).index_add_(
        0, group.reshape(-1), torch.ones_like(sums))
    avg = (sums / torch.clamp(counts, min=1.0))[group]
    ranks = torch.empty_like(avg).scatter_(0, order, avg)
    return torch.special.ndtri((ranks - 0.5) / N), srt


def _rhat_split_columns(x):
    """:func:`_rhat_single` of every column of ``x (chains, draws, k)``."""
    half = x.shape[1] // 2
    if half < 2:
        return torch.full(x.shape[2:], torch.nan, dtype=x.dtype)
    x = torch.cat([x[:, :half], x[:, half:2 * half]])
    n = x.shape[1]
    within = x.var(dim=1, correction=1).mean(dim=0)
    between = n * x.mean(dim=1).var(dim=0, correction=1)
    vhat = (n - 1) / n * within + between / n
    return torch.where(within == 0, torch.nan, torch.sqrt(vhat / within))


def _rhat_rank_columns(ary):
    """:func:`_rhat_rank` of every column of ``ary (chains, draws, k)``,
    computed on :func:`_diag_device` in float64: one sort of all the draws
    of every column at once, where the per-column loop ranked each with
    scipy (most of a phase's wall at 256 chains x 1,300 draws x 100
    columns)."""
    c, n, k = ary.shape
    x = torch.as_tensor(np.asarray(ary, dtype=np.float64),
                        device=_diag_device()).reshape(c * n, k)
    z, srt = _z_scale_columns(x)
    bulk = _rhat_split_columns(z.reshape(c, n, k))
    median = 0.5 * (srt[(c * n - 1) // 2] + srt[(c * n) // 2])
    zf, _ = _z_scale_columns(torch.abs(x - median))
    tail = _rhat_split_columns(zf.reshape(c, n, k))
    # the max of (bulk, tail) as Python's max takes it: NaN only from bulk
    out = torch.where(torch.isnan(bulk) | ~(tail > bulk), bulk, tail)
    return out.cpu().numpy()


def _per_element(fn, arrays: Dict[str, np.ndarray]):
    out = {}
    for name, ary in arrays.items():
        c, n = ary.shape[:2]
        flat = ary.reshape(c, n, -1)
        vals = np.array([fn(flat[:, :, i]) for i in range(flat.shape[2])])
        out[name] = vals.reshape(ary.shape[2:]) if ary.ndim > 2 else vals[0]
    return out


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------
def rhat(data, var_names=None, **kwargs):
    """Rank-normalized split R-hat (cf. ArviZ delegation,
    ``stats/__init__.py:43``), every element of a variable at once."""
    out = {}
    for name, ary in _trace_to_arrays(data, var_names).items():
        c, n = ary.shape[:2]
        vals = _rhat_rank_columns(ary.reshape(c, n, -1))
        out[name] = vals.reshape(ary.shape[2:]) if ary.ndim > 2 else vals[0]
    return out


def ess(data, var_names=None, relative=False, **kwargs):
    """Effective sample size."""
    arrays = _trace_to_arrays(data, var_names)
    return _per_element(lambda a: _ess_single(a, relative), arrays)


def mcse(data, var_names=None, **kwargs):
    """Monte-Carlo standard error (mean)."""
    arrays = _trace_to_arrays(data, var_names)

    def _mcse(a):
        e = _ess_single(a)
        return np.nan if not np.isfinite(e) or e <= 0 else a.std(ddof=1) / np.sqrt(e)
    return _per_element(_mcse, arrays)


def hpd(x, alpha=0.05, credible_interval=None, **kwargs):
    """Highest posterior density interval (pymc3 3.8 convention:
    ``alpha`` is the tail mass; interval has prob ``1-alpha``)."""
    if credible_interval is not None:
        alpha = 1 - credible_interval
    x = np.asarray(x)
    if x.ndim == 2:
        # (draws, k): interval per column
        return np.array([_hpd_1d(x[:, i], alpha)
                         for i in range(x.shape[1])])
    if x.ndim > 2:
        flat = x.reshape(x.shape[0] * x.shape[1], -1)
        return np.array([_hpd_1d(flat[:, i], alpha)
                         for i in range(flat.shape[1])]).reshape(
            x.shape[2:] + (2,))
    return _hpd_1d(x, alpha)


def _hpd_1d(x, alpha):
    x = np.sort(np.asarray(x).ravel())
    n = len(x)
    cred_mass = 1.0 - alpha
    interval_idx_inc = int(np.floor(cred_mass * n))
    n_intervals = n - interval_idx_inc
    if n_intervals <= 0:
        return np.array([x[0], x[-1]])
    interval_width = x[interval_idx_inc:] - x[:n_intervals]
    min_idx = np.argmin(interval_width)
    return np.array([x[min_idx], x[min_idx + interval_idx_inc]])


def geweke(ary, first=0.1, last=0.5, intervals=20):
    """Geweke z-scores over the chain (cf. ArviZ ``geweke``)."""
    ary = np.asarray(ary).ravel()
    if first + last >= 1:
        raise ValueError("Invalid intervals for Geweke convergence analysis")
    zscores = []
    n = len(ary)
    last_start = int((1 - last) * n)
    step = max(int((last_start) / (intervals or 1)), 1)
    for start in range(0, last_start, step):
        seg = ary[start:]
        n_seg = len(seg)
        first_sl = seg[:int(first * n_seg)]
        last_sl = seg[int((1 - last) * n_seg):]
        z = (first_sl.mean() - last_sl.mean()) / np.sqrt(
            first_sl.var() + last_sl.var())
        zscores.append([start, z])
    return np.array(zscores)


def bfmi(trace):
    """Bayesian fraction of missing information (cf. ArviZ ``bfmi``)."""
    if hasattr(trace, "get_sampler_stats"):
        energy = trace.get_sampler_stats("energy", combine=False,
                                         squeeze=False)
        energy = np.atleast_2d(np.asarray(energy))
    else:
        energy = np.atleast_2d(np.asarray(trace))
    num = np.square(np.diff(energy, axis=1)).mean(axis=1)
    den = np.var(energy, axis=1)
    return num / den


def r2_score(y_true, y_pred, round_to=2):
    """Bayesian R² (Gelman et al. 2018)."""
    y_true = np.asarray(y_true)
    y_pred = np.asarray(y_pred)
    r2_tuple = namedtuple("r2", ["r2", "r2_std"])
    if y_pred.ndim == 1:
        var_y_est = np.var(y_pred)
        var_e = np.var(y_true - y_pred)
        r2 = var_y_est / (var_y_est + var_e)
        return r2_tuple(np.round(r2, round_to), 0.0)
    var_y_est = np.var(y_pred, axis=1)
    var_e = np.var(y_true[None, :] - y_pred, axis=1)
    r2 = var_y_est / (var_y_est + var_e)
    return r2_tuple(np.round(np.mean(r2), round_to),
                    np.round(np.std(r2), round_to))


# ---------------------------------------------------------------------------
# pointwise log likelihood, WAIC / LOO
# ---------------------------------------------------------------------------
# points per vmapped call of the pointwise log likelihood: a chunk holds
# chunk x n_obs values and the model's intermediates
_LL_ELEMENTS = 1 << 24


def _trace_q(trace, model):
    """``(chains * draws, n)`` flat points of every draw, chain after chain
    (the JAX package's ``trace.point(i, chain=c)`` order), in ``floatX``."""
    parts = []
    for vm in model.ordering.vmap:
        vals = np.stack(trace.get_values(vm.var, combine=False,
                                         squeeze=False))
        parts.append(vals.reshape(vals.shape[0] * vals.shape[1], -1))
    return np.concatenate(parts, axis=1).astype(floatX())


def _log_likelihood_matrix(trace, model=None):
    """(samples, n_obs) pointwise log-likelihood of all observed RVs,
    evaluated on the model's device in one ``torch.func.vmap`` per chunk of
    draws; returns numpy."""
    from ..model import modelcontext
    from ..node import _ev
    model = modelcontext(model)
    obs = model.observed_RVs
    ordering = model.ordering

    def pointwise(q):
        env = model._env_from_q(q, ordering)
        memo = {}
        return torch.cat([torch.ravel(o.distribution.logp(
            _ev(o, env, memo), env, memo)) for o in obs])

    qs = torch.as_tensor(_trace_q(trace, model), device=model.device)
    n_obs = sum(int(np.prod(o.data.shape, dtype=int)) for o in obs)
    chunk = max(1, _LL_ELEMENTS // max(n_obs, 1))
    batched = torch.func.vmap(pointwise)
    with torch.no_grad():
        out = [batched(qs[i:i + chunk]) for i in range(0, len(qs), chunk)]
    return torch.cat(out).cpu().numpy()


WAIC_r = namedtuple("WAIC_r", "waic, waic_se, p_waic, var_warn")
LOO_r = namedtuple("LOO_r", "loo, loo_se, p_loo, shape_warn")


def _scaled(elpd_i, scale):
    if scale == "deviance":
        return -2 * elpd_i
    if scale == "log":
        return elpd_i
    return -elpd_i


def waic(trace, model=None, pointwise=False, scale="deviance"):
    """Widely-applicable information criterion (cf. ArviZ ``waic``)."""
    ll = _log_likelihood_matrix(trace, model)
    S, n = ll.shape
    lppd_i = _logsumexp(ll, axis=0) - np.log(S)
    p_waic_i = np.var(ll, axis=0, ddof=1)
    var_warn = int((p_waic_i > 0.4).any())
    out_i = _scaled(lppd_i - p_waic_i, scale)
    se = np.sqrt(n * np.var(out_i))
    if pointwise:
        WAICp = namedtuple("WAIC_r",
                           "waic, waic_se, p_waic, var_warn, waic_i")
        return WAICp(out_i.sum(), se, p_waic_i.sum(), var_warn, out_i)
    return WAIC_r(out_i.sum(), se, p_waic_i.sum(), var_warn)


def _psislw(log_weights, reff=1.0):
    """Pareto-smoothed importance sampling weights (Vehtari et al.). Each
    observation's weights are one contiguous row of the transpose."""
    lw = np.ascontiguousarray(np.asarray(log_weights, dtype=np.float64).T)
    S = lw.shape[1]
    khats = np.empty(lw.shape[0])
    out = np.empty_like(lw)
    cutoff_ind = -int(np.ceil(min(S / 5.0, 3 * np.sqrt(S / reff)))) - 1
    for i, row in enumerate(lw):
        x = row - row.max()
        # the order statistic the reference takes from a full sort
        tail_start = np.partition(x, cutoff_ind)[cutoff_ind]
        tail_ids = np.where(x > tail_start)[0]
        if len(tail_ids) <= 4:
            khats[i] = np.inf
            out[i] = x
        else:
            tail = np.exp(x[tail_ids]) - np.exp(tail_start)
            k, sigma = _gpdfit(np.sort(tail))
            khats[i] = k
            if np.isfinite(k):
                stail = _gpinv(
                    (np.arange(0.5, len(tail)) / len(tail)), k, sigma)
                smoothed = np.log(stail + np.exp(tail_start))
                x_new = np.copy(x)
                x_new[tail_ids[np.argsort(x[tail_ids])]] = smoothed
                out[i] = np.minimum(x_new, 0)
            else:
                out[i] = x
        out[i] -= _logsumexp(out[i])
    return out.T, khats


def _gpdfit(x):
    """Fit generalized Pareto to tail (Zhang & Stephens 2009).

    ``sigma`` comes from the estimate of k before the weakly informative
    prior shrinks it, as in ArviZ's ``_gpdfit``. The JAX package takes it
    after (``pymc3_tpu/stats/__init__.py:418-419``): where the prior moves
    k across zero its sigma turns negative and that observation's smoothed
    weights are NaN, which makes ``loo`` NaN."""
    prior_bs, prior_k = 3.0, 10.0
    n = len(x)
    m_est = 30 + int(np.sqrt(n))
    b_ary = 1 - np.sqrt(m_est / (np.arange(1, m_est + 1) - 0.5))
    b_ary /= prior_bs * x[int(n / 4 + 0.5) - 1]
    b_ary += 1 / x[-1]
    k_ary = np.mean(np.log1p(-b_ary[:, None] * x[None, :]), axis=1)
    len_scale = n * (np.log(-b_ary / k_ary) - k_ary - 1)
    weights = 1 / np.sum(np.exp(len_scale[None, :] - len_scale[:, None]),
                         axis=1)
    weights /= weights.sum()
    b_post = np.sum(b_ary * weights)
    k_post = np.mean(np.log1p(-b_post * x))
    sigma = -k_post / b_post
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return k_post, sigma


def _gpinv(probs, kappa, sigma):
    """Inverse generalized Pareto CDF."""
    x = np.full_like(probs, np.nan)
    if sigma <= 0:
        return x
    ok = (probs > 0) & (probs < 1)
    if np.abs(kappa) < 1e-15:
        x[ok] = -np.log1p(-probs[ok])
    else:
        x[ok] = np.expm1(-kappa * np.log1p(-probs[ok])) / kappa
    x *= sigma
    x[probs == 0] = 0
    x[probs == 1] = np.inf if kappa >= 0 else -sigma / kappa
    return x


def loo(trace, model=None, pointwise=False, reff=None, scale="deviance"):
    """PSIS leave-one-out cross-validation (cf. ArviZ ``loo``)."""
    ll = _log_likelihood_matrix(trace, model)
    S, n = ll.shape
    if reff is None:
        nchains = trace.nchains if hasattr(trace, "nchains") else 1
        if nchains == 1:
            reff = 1.0
        else:
            e = ess(trace)
            vals = np.concatenate([np.ravel(v) for v in e.values()])
            reff = np.nanmean(vals) / S if len(vals) else 1.0
    lw, ks = _psislw(-ll, reff)
    shape_warn = int((ks > 0.7).any())
    loo_lppd_i = _logsumexp(lw + ll, axis=0)
    lppd_i = _logsumexp(ll, axis=0) - np.log(S)
    p_loo = (lppd_i - loo_lppd_i).sum()
    out_i = _scaled(loo_lppd_i, scale)
    se = np.sqrt(n * np.var(out_i))
    if pointwise:
        LOOp = namedtuple("LOO_r", "loo, loo_se, p_loo, shape_warn, loo_i")
        return LOOp(out_i.sum(), se, p_loo, shape_warn, out_i)
    return LOO_r(out_i.sum(), se, p_loo, shape_warn)


def compare(model_dict, ic="loo", method="stacking", scale="deviance"):
    """Model comparison table (cf. ArviZ ``compare``): a pandas DataFrame,
    so pandas is imported here."""
    import pandas as pd
    names = list(model_dict.keys()) if isinstance(model_dict, dict) else \
        list(range(len(model_dict)))
    ics = []
    fn = loo if ic.lower() == "loo" else waic
    for name in names:
        tr = model_dict[name] if isinstance(model_dict, dict) else name
        if isinstance(tr, tuple):
            trace, model = tr
        else:
            trace, model = tr, None
        res = fn(trace, model=model, pointwise=True, scale=scale)
        ics.append((name, res))
    ascending = scale == "deviance" or scale == "negative_log"
    ics.sort(key=lambda x: x[1][0], reverse=not ascending)
    best = ics[0][1]
    rows = []
    for rank, (name, res) in enumerate(ics):
        d = res[0] - best[0]
        pointwise_i = res[-1]
        dse = np.sqrt(len(pointwise_i) *
                      np.var(pointwise_i - best[-1])) if rank else 0.0
        rows.append({
            "rank": rank, ic: res[0], f"p_{ic}": res[2],
            f"d_{ic}": d, "weight": 0.0, "se": res[1], "dse": dse,
            "warning": bool(res[3]),
        })
    df = pd.DataFrame(rows, index=[n if isinstance(n, str) else f"model_{i}"
                                   for i, (n, _) in enumerate(ics)])
    # pseudo-BMA weights
    elpds = np.array([-0.5 * r[ic] if scale == "deviance" else
                      (r[ic] if scale == "log" else -r[ic])
                      for r in rows])
    w = np.exp(elpds - elpds.max())
    df["weight"] = w / w.sum()
    return df


def _logsumexp(a, axis=None):
    if axis is None:
        return np.log(np.sum(np.exp(a - np.max(a)))) + np.max(a)
    amax = np.max(a, axis=axis, keepdims=True)
    return np.log(np.sum(np.exp(a - amax), axis=axis)) + \
        np.squeeze(amax, axis=axis)


def summary(trace, var_names=None, round_to=2, alpha=0.05, batches=None,
            include_transformed=False, stat_funcs=None, extend=False,
            credible_interval=0.94, **kwargs):
    """Summary DataFrame (cf. ArviZ ``summary`` delegation). Needs pandas,
    which the sampler itself does not."""
    import pandas as pd
    arrays = _trace_to_arrays(trace, var_names,
                              include_transformed=include_transformed)
    rows = []
    index = []
    for name, ary in arrays.items():
        c, n = ary.shape[:2]
        flat = ary.reshape(c, n, -1)
        k = flat.shape[2]
        for i in range(k):
            a = flat[:, :, i]
            combined = a.ravel()
            lo, hi = _hpd_1d(combined, 1 - credible_interval)
            e = _ess_single(a)
            r = _rhat_rank(a) if c > 1 else np.nan
            m = a.std(ddof=1) / np.sqrt(e) if np.isfinite(e) and e > 0 \
                else np.nan
            row = {
                "mean": combined.mean(),
                "sd": combined.std(ddof=1),
                f"hpd_{100 * (1 - credible_interval) / 2:.4g}%": lo,
                f"hpd_{100 * (1 - (1 - credible_interval) / 2):.4g}%": hi,
                "mcse_mean": m,
                "ess_mean": e,
                "r_hat": r,
            }
            if stat_funcs is not None:
                for f in (stat_funcs if isinstance(stat_funcs, (list, tuple))
                          else [stat_funcs]):
                    res = f(combined)
                    fname = getattr(f, "__name__", "stat")
                    row[fname] = np.asarray(res).item() if np.ndim(res) == 0 \
                        else res
            rows.append(row)
            if k == 1:
                index.append(name)
            else:
                idx = np.unravel_index(i, ary.shape[2:])
                index.append(f"{name}[{','.join(map(str, idx))}]")
    df = pd.DataFrame(rows, index=index)
    if round_to is not None:
        df = df.round(round_to)
    return df


def effective_n(*args, **kwargs):
    warnings.warn("effective_n has been deprecated. In future, use ess "
                  "instead.", DeprecationWarning)
    return ess(*args, **kwargs)


def gelman_rubin(*args, **kwargs):
    warnings.warn("gelman_rubin has been deprecated. In future, use rhat "
                  "instead.", DeprecationWarning)
    return rhat(*args, **kwargs)
