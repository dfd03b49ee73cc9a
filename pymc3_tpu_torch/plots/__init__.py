"""Plotting (cf. ``pymc3_tpu/plots/__init__.py``).

The plots keep the JAX package's matplotlib drawings and call signatures
(the reference's ArviZ plots). What each one draws is computed first by
one private data function, as batched tensor code on the configured
device: the Gaussian KDEs of every series in one pass, cut into chunks of
at most ``KDE_CHUNK_BYTES``; every chain's autocorrelation by one FFT;
every interval by one sort (``stats.hpd``). A data function returns numpy
arrays of exactly what is drawn, copied to the host once. matplotlib is
imported inside each plot, so the package imports where it is absent.

One fault of the JAX package is not copied: its ``energyplot`` takes
``np.diff`` over all chains joined, so each chain boundary adds a
difference between two chains. The port differences within each chain, as
ArviZ's ``plot_energy``, which the reference calls, does.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import default_device
from ..stats import hpd
from .posteriorplot import plot_posterior_predictive_glm

__all__ = [
    "traceplot", "plot_posterior", "forestplot", "energyplot",
    "autocorrplot", "densityplot", "pairplot", "compareplot", "kdeplot",
    "plot_posterior_predictive_glm",
]

#: Points of each KDE's grid, from the series' min to its max.
KDE_GRID = 200
#: The most bytes that one chunk's (series, grid, draws) float64 block of
#: the KDE takes on the device: radon's 358,400 series of 60 draws (175
#: scalars x 2048 chains) make 34 GB in all, so they go in chunks.
KDE_CHUNK_BYTES = 1 << 30
#: A series of integers with fewer distinct values than this is drawn as
#: a histogram, not a KDE (the JAX package's ``_is_discrete``).
MAX_DISCRETE = 30


def _get_axes(n, figsize=None, ncols=2):
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(n, ncols, figsize=figsize or (12, 2.2 * n),
                             squeeze=False)
    return fig, axes


def _extract(trace, var_names=None, include_transformed=False):
    """{name: (chains, draws, ...) array} (cf. ``plots/__init__.py:34``)."""
    if var_names is None:
        var_names = [v for v in trace.varnames
                     if include_transformed or not v.endswith("__")]
    return {name: np.stack(trace.get_values(name, combine=False,
                                            squeeze=False))
            for name in var_names}


def _flat_iter(data):
    """Yield (label, (chains, draws) array) per scalar element
    (cf. ``plots/__init__.py:45``)."""
    for name, ary in data.items():
        c, n = ary.shape[:2]
        flat = ary.reshape(c, n, -1)
        for i in range(flat.shape[2]):
            if flat.shape[2] == 1:
                yield name, flat[:, :, 0]
            else:
                idx = np.unravel_index(i, ary.shape[2:])
                yield f"{name}[{','.join(map(str, idx))}]", flat[:, :, i]


def _items(trace, var_names):
    """The scalars' labels and their draws as one ``(scalars, chains,
    draws)`` float array on the host."""
    items = list(_flat_iter(_extract(trace, var_names)))
    values = np.stack([ary for _, ary in items])
    if values.dtype.kind != "f":
        values = values.astype(np.float64)
    return [label for label, _ in items], values


def _on(values, device):
    """``values`` on ``device`` (the configured device if None), copied
    there once."""
    device = default_device() if device is None else torch.device(device)
    return torch.as_tensor(values).to(device)


def _to_host(*tensors):
    """The tensors as float64 numpy arrays, in one copy from the device."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    host = flat.cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(host[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


def _kde(series):
    """The Gaussian KDE of each row of ``series: (S, n)`` on its own grid of
    ``KDE_GRID`` points, as ``scipy.stats.gaussian_kde`` computes it in
    ``_kde`` (cf. ``plots/__init__.py:58``): bandwidth Scott's factor
    ``n**(-1/5)`` times the row's sd with ``ddof=1``; the grid is
    ``np.linspace(min, max)`` in the series' dtype, the density float64.
    Returns ``(x, y, constant)``: a constant row's line is the one point
    ``(x[0], y[0]) = (value, 1.0)``, as in the JAX package."""
    S, n = series.shape
    lo, hi = series.min(-1).values, series.max(-1).values
    # a tensor divisor: CUDA divides by a Python number as a product with
    # its reciprocal, which moves numpy's grid points by an ulp
    step = (hi - lo) / torch.full_like(hi, KDE_GRID - 1)
    x = torch.arange(KDE_GRID, dtype=series.dtype,
                     device=series.device) * step[:, None] + lo[:, None]
    x[:, -1] = hi
    x = x.to(torch.float64)
    data = series.to(torch.float64)
    sd = torch.sqrt(((data - data.mean(-1, keepdim=True)) ** 2).sum(-1)
                    / (n - 1)) * n ** -0.2
    norm = n * math.sqrt(2.0 * math.pi) * sd
    y = torch.empty_like(x)
    rows = max(1, KDE_CHUNK_BYTES // (8 * KDE_GRID * n))
    for s in range(0, S, rows):
        z = x[s:s + rows, :, None] - data[s:s + rows, None, :]
        z.div_(sd[s:s + rows, None, None]).square_().mul_(-0.5).exp_()
        y[s:s + rows] = z.sum(-1) / norm[s:s + rows, None]
    constant = lo == hi
    y.masked_fill_(constant[:, None], 0.0)
    y[:, 0] = torch.where(constant, 1.0, y[:, 0])
    return x, y, constant


def _line(x, y, constant):
    return (x[:1], y[:1]) if constant else (x, y)


def _pooled_kde(labels, v):
    """The KDE of each scalar's draws over all chains, on the host."""
    x, y, const = _to_host(*_kde(v.reshape(v.shape[0], -1)))
    return {"labels": labels, "x": x, "y": y, "constant": const.astype(bool)}


def _discrete(v):
    """For ``v: (K, C, N)``: which scalars are drawn as histograms (every
    draw close to an integer, fewer than ``MAX_DISCRETE`` distinct values);
    their distinct values ``(K, MAX_DISCRETE)``, ascending, and each
    chain's count of each ``(K, C, MAX_DISCRETE)``, zero elsewhere."""
    K, C, N = v.shape
    flat = v.reshape(K, C * N)
    r = torch.round(flat)
    close = (((flat - r).abs() <= 1e-8 + 1e-5 * r.abs()) & torch.isfinite(r)
             | (flat == r)).all(-1)
    srt, order = torch.sort(flat, dim=-1)
    new = torch.ones_like(srt, dtype=torch.bool)
    new[:, 1:] = srt[:, 1:] != srt[:, :-1]
    rank = torch.cumsum(new, -1) - 1
    discrete = close & (rank[:, -1] + 1 < MAX_DISCRETE)
    slot = rank.clamp(max=MAX_DISCRETE - 1)
    unique = torch.zeros((K, MAX_DISCRETE), dtype=flat.dtype,
                         device=flat.device).scatter_(1, slot, srt)
    keep = discrete[:, None] & (torch.arange(MAX_DISCRETE, device=flat.device)
                                <= rank[:, -1:])
    unique = torch.where(keep, unique, 0.0)
    per_draw = torch.empty_like(slot).scatter_(1, order, slot)
    counts = torch.zeros((K, C, MAX_DISCRETE), dtype=torch.float64,
                         device=flat.device).scatter_add_(
        2, per_draw.reshape(K, C, N),
        torch.ones((K, C, N), dtype=torch.float64, device=flat.device))
    counts = counts * discrete[:, None, None]
    return discrete, unique, counts


def _trace_data(trace, var_names=None, device=None):
    """What ``traceplot`` draws: each scalar's draws, and each chain's KDE
    or, for a discrete scalar, its distinct values and their counts."""
    labels, values = _items(trace, var_names)
    v = _on(values, device)
    K, C, N = v.shape
    x, y, const = _kde(v.reshape(K * C, N))
    x, y, const, disc, unique, counts = _to_host(x, y, const,
                                                 *_discrete(v))
    return {"labels": labels, "values": values,
            "x": x.reshape(K, C, -1), "y": y.reshape(K, C, -1),
            "constant": const.reshape(K, C).astype(bool),
            "discrete": disc.astype(bool), "unique": unique,
            "counts": counts}


def _interval_data(trace, var_names, credible_interval, device, kde):
    """Each scalar's HPD interval and mean over all chains, and with
    ``kde`` its pooled KDE."""
    labels, values = _items(trace, var_names)
    v = _on(values, device)
    pooled = v.reshape(v.shape[0], -1)
    parts = [hpd(pooled.T, alpha=1 - credible_interval),
             pooled.to(torch.float64).mean(-1)]
    if kde:
        parts += _kde(pooled)
    host = _to_host(*parts)
    out = {"labels": labels, "hpd": host[0], "mean": host[1]}
    if kde:
        out.update(x=host[2], y=host[3], constant=host[4].astype(bool))
    return out


def _posterior_data(trace, var_names=None, credible_interval=0.94,
                    device=None):
    """What ``plot_posterior`` draws."""
    return _interval_data(trace, var_names, credible_interval, device,
                          kde=True)


def _forest_data(trace, var_names=None, credible_interval=0.94,
                 device=None):
    """What ``forestplot`` draws."""
    return _interval_data(trace, var_names, credible_interval, device,
                          kde=False)


def _energy_data(trace, device=None):
    """What ``energyplot`` draws: the KDEs of the centred energies and of
    their differences within each chain (``transition``, chain by chain)."""
    e = _on(np.stack(trace.get_sampler_stats("energy", combine=False,
                                              squeeze=False)),
            device).to(torch.float64)
    marginal = (e - e.mean()).reshape(1, -1)
    transition = torch.diff(e, dim=-1).reshape(1, -1)
    host = _to_host(*_kde(marginal), *_kde(transition), transition[0])
    return {"marginal": (host[0][0], host[1][0], bool(host[2][0])),
            "transition": (host[3][0], host[4][0], bool(host[5][0])),
            "transition_values": host[6]}


def _autocorr_data(trace, var_names=None, max_lag=100, device=None):
    """What ``autocorrplot`` draws: each chain's autocorrelation of each
    scalar up to ``max_lag``, ``(K, C, lags)``, as ``np.correlate(x, x,
    "full")[n-1:]`` normalised by lag 0 (cf. ``plots/__init__.py:175``),
    by one zero-padded FFT in float64."""
    labels, values = _items(trace, var_names)
    v = _on(values, device).to(torch.float64)
    n = v.shape[-1]
    xc = v - v.mean(-1, keepdim=True)
    nfft = 1 << (2 * n - 2).bit_length()
    f = torch.fft.rfft(xc, n=nfft)
    acf = torch.fft.irfft(f.real ** 2 + f.imag ** 2, n=nfft)
    acf = acf[..., :min(max_lag, n)]
    acf, = _to_host(acf / acf[..., :1])
    return {"labels": labels, "acf": acf}


def _density_data(trace, var_names=None, device=None):
    """What ``densityplot`` draws: each scalar's KDE over all chains."""
    labels, values = _items(trace, var_names)
    return _pooled_kde(labels, _on(values, device))


def _pair_data(trace, var_names=None, divergences=False, device=None):
    """What ``pairplot`` draws: each scalar's pooled KDE on the diagonal,
    its draws (``(K, chains * draws)``) against the others', and the
    divergent draws' flags."""
    labels, values = _items(trace, var_names)
    out = _pooled_kde(labels, _on(values, device))
    out["values"] = values.reshape(values.shape[0], -1)
    out["diverging"] = None
    if divergences and "diverging" in trace.stat_names:
        out["diverging"] = np.asarray(
            trace.get_sampler_stats("diverging")).ravel()
    return out


def traceplot(trace, var_names=None, figsize=None, combined=False,
              **kwargs):
    """Marginal densities + sample traces per variable
    (cf. ArviZ ``plot_trace``)."""
    d = _trace_data(trace, var_names)
    n_draws = d["values"].shape[2]
    fig, axes = _get_axes(len(d["labels"]), figsize)
    for i, label in enumerate(d["labels"]):
        ax_kde, ax_trace = axes[i]
        for c in range(d["values"].shape[1]):
            if d["discrete"][i]:
                seen = d["counts"][i, c] > 0
                ax_kde.plot(d["unique"][i][seen],
                            d["counts"][i, c][seen] / n_draws,
                            drawstyle="steps")
            else:
                ax_kde.plot(*_line(d["x"][i, c], d["y"][i, c],
                                   d["constant"][i, c]), alpha=0.8)
            ax_trace.plot(d["values"][i, c], alpha=0.6, lw=0.5)
        ax_kde.set_title(label)
        ax_trace.set_title(label)
    fig.tight_layout()
    return axes


def plot_posterior(trace, var_names=None, figsize=None,
                   credible_interval=0.94, ref_val=None, **kwargs):
    """Posterior densities with HPD annotation (cf. ArviZ
    ``plot_posterior``)."""
    import matplotlib.pyplot as plt
    d = _posterior_data(trace, var_names, credible_interval)
    n = len(d["labels"])
    ncols = min(n, 3)
    nrows = int(np.ceil(n / ncols))
    fig, axes = plt.subplots(nrows, ncols,
                             figsize=figsize or (4 * ncols, 2.6 * nrows),
                             squeeze=False)
    for i, label in enumerate(d["labels"]):
        ax = axes[i // ncols][i % ncols]
        x, y = _line(d["x"][i], d["y"][i], d["constant"][i])
        ax.plot(x, y)
        lo, hi = d["hpd"][i]
        ax.hlines(0, lo, hi, lw=4)
        ax.text((lo + hi) / 2, 0.05 * y.max(),
                f"{100 * credible_interval:.0f}% HPD", ha="center")
        ax.set_title(f"{label}\nmean={d['mean'][i]:.3g}")
        if ref_val is not None:
            ax.axvline(ref_val, color="r", ls="--")
        ax.set_yticks([])
    fig.tight_layout()
    return axes


def forestplot(trace, var_names=None, credible_interval=0.94, figsize=None,
               r_hat=False, **kwargs):
    """Interval forest plot (cf. ArviZ ``plot_forest``)."""
    import matplotlib.pyplot as plt
    d = _forest_data(trace, var_names, credible_interval)
    n = len(d["labels"])
    fig, ax = plt.subplots(figsize=figsize or (6, 0.5 * n + 1))
    for i in range(n):
        lo, hi = d["hpd"][i]
        ax.plot([lo, hi], [n - i, n - i], "b-", lw=2)
        ax.plot(d["mean"][i], n - i, "bo")
    ax.set_yticks(range(n, 0, -1))
    ax.set_yticklabels(d["labels"])
    fig.tight_layout()
    return ax


def energyplot(trace, figsize=None, **kwargs):
    """Energy transition vs marginal (cf. ArviZ ``plot_energy``)."""
    import matplotlib.pyplot as plt
    d = _energy_data(trace)
    fig, ax = plt.subplots(figsize=figsize or (8, 4))
    for key, label in [("marginal", "energy marginal"),
                       ("transition", "energy transition")]:
        x, y = _line(*d[key])
        ax.plot(x, y, label=label)
        ax.fill_between(x, y, alpha=0.3)
    ax.legend()
    ax.set_yticks([])
    return ax


def autocorrplot(trace, var_names=None, max_lag=100, figsize=None,
                 **kwargs):
    """Autocorrelation per chain (cf. ArviZ ``plot_autocorr``)."""
    d = _autocorr_data(trace, var_names, max_lag)
    fig, axes = _get_axes(len(d["labels"]), figsize, ncols=1)
    for i, label in enumerate(d["labels"]):
        ax = axes[i][0]
        for acf in d["acf"][i]:
            ax.vlines(np.arange(len(acf)), 0, acf, alpha=0.5)
        ax.set_title(label)
        ax.axhline(0, color="k", lw=0.5)
    fig.tight_layout()
    return axes


def densityplot(trace, var_names=None, figsize=None, **kwargs):
    """cf. ArviZ ``plot_density``."""
    d = _density_data(trace, var_names)
    fig, axes = _get_axes(len(d["labels"]), figsize, ncols=1)
    for i, label in enumerate(d["labels"]):
        ax = axes[i][0]
        x, y = _line(d["x"][i], d["y"][i], d["constant"][i])
        ax.plot(x, y)
        ax.fill_between(x, y, alpha=0.3)
        ax.set_title(label)
        ax.set_yticks([])
    fig.tight_layout()
    return axes


kdeplot = densityplot


def pairplot(trace, var_names=None, figsize=None, divergences=False,
             **kwargs):
    """Pairwise scatter (cf. ArviZ ``plot_pair``)."""
    import matplotlib.pyplot as plt
    d = _pair_data(trace, var_names, divergences)
    labels, values, div = d["labels"], d["values"], d["diverging"]
    k = len(labels)
    fig, axes = plt.subplots(k, k, figsize=figsize or (2.2 * k, 2.2 * k),
                             squeeze=False)
    for i in range(k):
        for j in range(k):
            ax = axes[i][j]
            if i == j:
                ax.plot(*_line(d["x"][i], d["y"][i], d["constant"][i]))
            else:
                xi, xj = values[j], values[i]
                ax.scatter(xi, xj, s=2, alpha=0.3)
                if div is not None and div.shape == xi.shape:
                    ax.scatter(xi[div], xj[div], s=6, c="r")
            if i == k - 1:
                ax.set_xlabel(labels[j])
            if j == 0:
                ax.set_ylabel(labels[i])
    fig.tight_layout()
    return axes


def compareplot(comp_df, figsize=None, **kwargs):
    """Model-comparison plot (cf. ``plots/compareplot.py``)."""
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=figsize or (6, 0.5 * len(comp_df) + 1))
    ic = [c for c in comp_df.columns if c in ("loo", "waic")][0]
    yticks = np.arange(len(comp_df))[::-1]
    ax.errorbar(comp_df[ic], yticks, xerr=comp_df["se"], fmt="ko",
                mfc="None")
    ax.set_yticks(yticks)
    ax.set_yticklabels(comp_df.index)
    ax.set_xlabel(ic.upper())
    return ax
