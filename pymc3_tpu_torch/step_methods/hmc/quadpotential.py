"""Adaptive diagonal mass matrix (cf. ``pymc3_tpu/step_methods/hmc/quadpotential.py``).

Two Welford variance estimators (foreground / background) per chain, the
foreground refreshed from the background every ``adaptation_window`` tuning
draws. Pooled adaptation merges the per-chain ``(w, mean, M2)`` triples
exactly; where the JAX package used ``psum`` over the vmapped chain axis,
here the chains are dim 0 and the merge is a sum over it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import floatX, torch_floatX

__all__ = ["WelfordState", "welford_add", "welford_merge_pooled",
           "DiagAdaptState", "diag_adapt_init", "diag_adapt_update",
           "mass_velocity", "QuadPotentialDiagAdapt"]


class WelfordState(NamedTuple):
    w: torch.Tensor      # total weight (chains,)
    mean: torch.Tensor   # running mean (chains, n)
    m2: torch.Tensor     # sum of squared deviations (chains, n)


def welford_zeros(chains, n, device):
    z = torch.zeros((chains, n), dtype=torch_floatX(), device=device)
    return WelfordState(torch.zeros(chains, dtype=z.dtype, device=device),
                        z, z.clone())


def welford_add(state: WelfordState, x, weight=1.0) -> WelfordState:
    """cf. ``_WeightedVariance.add_sample`` (``quadpotential.py:336-342``)."""
    w = state.w + weight
    prop = (weight / w)[:, None]
    delta = x - state.mean
    mean = state.mean + prop * delta
    m2 = state.m2 + weight * delta * (x - mean)
    return WelfordState(w, mean, m2)


def welford_merge_pooled(state: WelfordState) -> WelfordState:
    """Exact pooled merge over all chains (dim 0), broadcast back to every
    chain (cf. ``welford_merge_psum``, quadpotential.py:93)."""
    w_tot = state.w.sum(0)
    mean_tot = (state.w[:, None] * state.mean).sum(0) / w_tot
    m2_tot = (state.m2 + state.w[:, None]
              * (state.mean - mean_tot) ** 2).sum(0)
    return WelfordState(w_tot.expand_as(state.w),
                        mean_tot.expand_as(state.mean),
                        m2_tot.expand_as(state.m2))


class DiagAdaptState(NamedTuple):
    """QuadPotentialDiagAdapt state, one row per chain."""

    var: torch.Tensor        # current M^{-1} diagonal (chains, n)
    inv_stds: torch.Tensor   # 1/sqrt(var), for momentum draws
    fg: WelfordState
    bg: WelfordState
    n_samples: torch.Tensor  # tuning draws seen (chains,) int32


def diag_adapt_init(initial_mean, initial_diag, initial_weight,
                    chains) -> DiagAdaptState:
    """cf. ``QuadPotentialDiagAdapt.__init__`` (``quadpotential.py:140``);
    ``initial_mean``/``initial_diag``: ``(n,)`` tensors."""
    n = initial_mean.shape[-1]
    device = initial_mean.device
    mean = initial_mean.expand(chains, n).clone()
    m2 = (initial_diag * initial_weight).expand(chains, n).clone()
    w = torch.full((chains,), float(initial_weight), dtype=mean.dtype,
                   device=device)
    var = m2 / w[:, None]
    return DiagAdaptState(
        var=var, inv_stds=1.0 / torch.sqrt(var),
        fg=WelfordState(w, mean, m2), bg=welford_zeros(chains, n, device),
        n_samples=torch.zeros(chains, dtype=torch.int32, device=device))


def diag_adapt_update(state: DiagAdaptState, sample, tune: bool,
                      adaptation_window=101,
                      pooled: bool = False) -> DiagAdaptState:
    """One adaptation step (cf. ``diag_adapt_update``, quadpotential.py:136):
    add the sample to both estimators, refresh ``var`` from the foreground
    (pooled over chains with ``pooled``), and at window ends promote the
    background to the foreground."""
    if not tune:
        return state
    fg = welford_add(state.fg, sample)
    bg = welford_add(state.bg, sample)
    fg_for_var = welford_merge_pooled(fg) if pooled else fg
    var = fg_for_var.m2 / fg_for_var.w[:, None]

    n = state.n_samples + 1
    window_end = (n % adaptation_window) == 0
    if pooled:
        # early promotions at n = 3/10/25 once the pooled sample count
        # clears 1024 (as in the JAX package)
        chains = sample.shape[0]
        early = (n == 3) | (n == 10) | (n == 25)
        window_end = window_end | (early & (chains * n.to(var.dtype) >= 1024.0))
    zero = welford_zeros(*sample.shape, sample.device)

    def promote(a, b):
        we = window_end if a.ndim == 1 else window_end[:, None]
        return torch.where(we, a, b)

    fg_new = WelfordState(*map(promote, bg, fg))
    bg_new = WelfordState(*map(promote, zero, bg))
    return DiagAdaptState(var=var, inv_stds=1.0 / torch.sqrt(var),
                          fg=fg_new, bg=bg_new, n_samples=n)


def mass_velocity(var, p):
    """v = M^{-1} p for the diagonal inverse mass ``var``."""
    return p * var


class QuadPotentialDiagAdapt:
    """Adaptive diagonal potential (cf. ``quadpotential.py:443``)."""

    adapts = True

    def __init__(self, n, initial_mean, initial_diag=None, initial_weight=0,
                 adaptation_window=101, dtype=None):
        if initial_diag is not None and np.ndim(initial_diag) != 1:
            raise ValueError("Initial diagonal must be one-dimensional.")
        if np.ndim(initial_mean) != 1:
            raise ValueError("Initial mean must be one-dimensional.")
        if initial_diag is not None and len(initial_diag) != n:
            raise ValueError(f"Wrong shape for initial_diag: expected {n} got "
                             f"{len(initial_diag)}")
        if len(initial_mean) != n:
            raise ValueError(f"Wrong shape for initial_mean: expected {n} got "
                             f"{len(initial_mean)}")
        self.dtype = dtype or floatX()
        self.n = n
        self.adaptation_window = int(adaptation_window)
        self._initial_mean = np.asarray(initial_mean, dtype=self.dtype)
        if initial_diag is None:
            self._initial_diag = np.ones(n, dtype=self.dtype)
            self._initial_weight = 1.0
        else:
            self._initial_diag = np.asarray(initial_diag, dtype=self.dtype)
            self._initial_weight = float(initial_weight)

    def init_kernel_state(self, chains, device) -> DiagAdaptState:
        return diag_adapt_init(
            torch.as_tensor(self._initial_mean, device=device),
            torch.as_tensor(self._initial_diag, device=device),
            self._initial_weight, chains)
