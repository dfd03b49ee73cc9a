"""Convergence diagnostics on the device (cf. ``pymc3_tpu/stats/device.py``).

Split R-hat and bulk ESS of every parameter at once over a ``(chains,
draws, dim)`` block of draws, on the card: the host diagnostics of
``stats/__init__.py`` loop over parameters in numpy and rank-normalise,
which took most of a phase's wall at a thousand chains. These are the plain
(not rank-normalised) estimators, the variant that vectorises exactly.

Every reduction runs in float64. The JAX package casts the block to
float32, so the two agree to float32 rounding only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_device

__all__ = ["rhat_device", "ess_device", "rhat_split", "ess_bulk"]


def _split(x):
    """(chains, draws, dim) -> (2*chains, draws//2, dim)."""
    half = x.shape[1] // 2
    return torch.cat([x[:, :half], x[:, half:2 * half]], dim=0)


def rhat_split(x):
    """Split R-hat per parameter; x is (chains, draws, dim) -> (dim,)."""
    x = _split(x.double())
    n = x.shape[1]
    chain_mean = x.mean(dim=1)                                # (m, dim)
    chain_var = x.var(dim=1, correction=1)                    # (m, dim)
    between = n * chain_mean.var(dim=0, correction=1)         # (dim,)
    within = chain_var.mean(dim=0)                            # (dim,)
    vhat = (n - 1.0) / n * within + between / n
    return torch.sqrt(vhat / within)


def _autocov_fft(x, n):
    """Per-chain autocovariance via rFFT; x (m, n, dim) -> (m, n, dim)."""
    mpad = 2 ** int(np.ceil(np.log2(2 * n)))
    centered = x - x.mean(dim=1, keepdim=True)
    f = torch.fft.rfft(centered, mpad, dim=1)
    acov = torch.fft.irfft(f * torch.conj(f), mpad, dim=1)[:, :n]
    return acov / n


def ess_bulk(x):
    """Bulk ESS per parameter; x is (chains, draws, dim) -> (dim,).

    Geyer's initial positive sequence over pairs of lags, made monotone by
    a running minimum over the kept prefix (``torch.cummin`` where the JAX
    package has an associative scan of ``jnp.minimum``)."""
    x = _split(x.double())
    m, n, dim = x.shape
    acov = _autocov_fft(x, n)
    chain_mean = x.mean(dim=1)
    mean_var = acov[:, 0].mean(dim=0) * n / (n - 1.0)
    var_plus = mean_var * (n - 1.0) / n + chain_mean.var(dim=0, correction=1)

    rho = 1.0 - (mean_var[None] - acov.mean(dim=0)) / var_plus[None]
    rho = torch.cat([torch.ones_like(rho[:1]), rho[1:]])      # (n, dim)

    n_pairs = n // 2
    pair = rho[:2 * n_pairs].reshape(n_pairs, 2, dim).sum(dim=1)
    keep = torch.cummin((pair > 0).to(torch.int8), dim=0).values.bool()
    mono = torch.cummin(torch.where(keep, pair, torch.inf), dim=0).values
    pair = torch.where(keep, mono, 0.0)
    tau = torch.clamp(-1.0 + 2.0 * pair.sum(dim=0), min=1.0)
    return (m * n) / tau


def _flat(samples, device):
    """``(chains, draws, ...)`` draws as a ``(chains, draws, dim)`` tensor
    on ``device`` (a tensor's own device, else the configured one), and
    the trailing shape."""
    if isinstance(samples, torch.Tensor):
        x = samples if device is None else samples.to(device)
    else:
        x = torch.as_tensor(np.asarray(samples), device=(
            default_device() if device is None else device))
    return x.reshape(x.shape[0], x.shape[1], -1), tuple(x.shape[2:])


def rhat_device(samples, device=None) -> np.ndarray:
    """Split R-hat of every element of ``(chains, draws, ...)`` draws,
    numpy or a tensor; returns numpy of shape ``...``."""
    x, shape = _flat(samples, device)
    return rhat_split(x).cpu().numpy().reshape(shape)


def ess_device(samples, device=None) -> np.ndarray:
    """Bulk ESS of every element, as :func:`rhat_device`."""
    x, shape = _flat(samples, device)
    return ess_bulk(x).cpu().numpy().reshape(shape)
