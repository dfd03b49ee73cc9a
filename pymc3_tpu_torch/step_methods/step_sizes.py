"""Step-size adaptation (cf. ``pymc3_tpu/step_methods/step_sizes.py``).

Nesterov dual averaging as a NamedTuple of ``(chains,)`` tensors, one value
per chain, updated in place of the JAX package's per-chain pytree.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

__all__ = ["DAState", "da_init", "da_update", "da_current"]


class DAState(NamedTuple):
    """Dual-averaging state, each field ``(chains,)``."""

    log_step: torch.Tensor       # current log step size
    log_bar_step: torch.Tensor   # averaged log step size
    hbar: torch.Tensor           # running average of (target - accept)
    count: torch.Tensor          # t
    mu: torch.Tensor             # shrinkage target log(mu_scale * eps0)
    tuned_accept_sum: torch.Tensor
    tuned_count: torch.Tensor


def da_init(initial_step, mu_scale=10.0) -> DAState:
    """``initial_step``: ``(chains,)`` tensor of starting step sizes."""
    z = torch.zeros_like(initial_step)
    log_step = torch.log(initial_step)
    return DAState(log_step=log_step, log_bar_step=log_step.clone(), hbar=z,
                   count=torch.ones_like(initial_step),
                   mu=math.log(mu_scale) + log_step,
                   tuned_accept_sum=z.clone(), tuned_count=z.clone())


def da_update(state: DAState, accept_stat, tune: bool, target=0.8,
              gamma=0.05, k=0.75, t0=10.0) -> DAState:
    """One dual-averaging update (cf. ``step_sizes.py:40-66``). Off tune the
    step size stays at its averaged value and only the acceptance
    bookkeeping advances."""
    if not tune:
        return state._replace(
            tuned_accept_sum=state.tuned_accept_sum + accept_stat,
            tuned_count=state.tuned_count + 1)
    count = state.count
    w = 1.0 / (count + t0)
    hbar = (1.0 - w) * state.hbar + w * (target - accept_stat)
    log_step = state.mu - hbar * torch.sqrt(count) / gamma
    mk = count ** -k
    log_bar = mk * log_step + (1.0 - mk) * state.log_bar_step
    return state._replace(log_step=log_step, log_bar_step=log_bar, hbar=hbar,
                          count=count + 1)


def da_current(state: DAState, tune: bool):
    """Step size of this draw: the adapting value while tuning, then the
    dual-averaged one (cf. ``step_sizes.py:34-38``)."""
    return torch.exp(state.log_step if tune else state.log_bar_step)
