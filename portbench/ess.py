"""Rank-normalised split bulk effective sample size, in NumPy.

Vehtari, Gelman, Simpson, Carpenter and Buerkner (2021), "Rank-normalization,
folding, and localization: an improved R-hat", Bayesian Analysis 16(2),
with Geyer's initial monotone sequence, as ArviZ and the port compute it;
written again here so that the yardstick does not move with the program.
"""
from __future__ import annotations

import numpy as np
from scipy.special import ndtri


def _rank_normal(x):
    """Normal scores of the ranks of every value of ``x`` (ties, which
    continuous draws almost never have, take distinct ranks)."""
    flat = x.ravel()
    ranks = np.empty(flat.size, dtype=np.float64)
    ranks[np.argsort(flat, kind="stable")] = np.arange(1, flat.size + 1)
    return ndtri((ranks - 0.375) / (flat.size + 0.25)).reshape(x.shape)


def _split(x):
    half = x.shape[1] // 2
    return np.concatenate([x[:, :half], x[:, x.shape[1] - half:]], axis=0)


def _autocov(x):
    n = x.shape[1]
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    c = x - x.mean(axis=1, keepdims=True)
    f = np.fft.rfft(c, m, axis=1)
    return np.fft.irfft(f * np.conj(f), m, axis=1)[:, :n] / n


def bulk_ess(draws):
    """Bulk ESS of ``draws (chains, n)``; NaN below four draws a chain."""
    x = _split(_rank_normal(np.asarray(draws, dtype=np.float64)))
    m, n = x.shape
    if n < 4:
        return float("nan")
    acov = _autocov(x).mean(axis=0)
    mean_var = acov[0] * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n + x.mean(axis=1).var(ddof=1)
    rho = 1.0 - (mean_var - acov) / var_plus
    rho[0] = 1.0
    # Geyer's initial positive sequence over pairs, then made monotone
    pairs = rho[:n - n % 2].reshape(-1, 2).sum(axis=1)
    positive = np.nonzero(pairs <= 0.0)[0]
    k = positive[0] if positive.size else pairs.size
    pairs = np.minimum.accumulate(pairs[:k])
    tau = -1.0 + 2.0 * pairs.sum()
    tau = max(tau, 1.0 / np.log10(m * n))
    return float(m * n / tau)
