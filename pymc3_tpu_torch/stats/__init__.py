"""Convergence diagnostics (cf. ``pymc3_tpu/stats/__init__.py``).

Rank-normalized split R-hat, bulk ESS (FFT autocorrelation, Geyer's initial
monotone sequence) and the summary table, on the host in numpy. Inputs are
upcast to float64: a float32 reduction over millions of draws drifts by a
visible fraction of a posterior sd.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

__all__ = ["ess", "rhat", "mcse", "summary"]


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
    ``stats/__init__.py:43``)."""
    arrays = _trace_to_arrays(data, var_names)
    return _per_element(_rhat_rank, arrays)


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
