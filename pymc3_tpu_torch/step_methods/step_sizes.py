"""Step-size adaptation (cf. ``pymc3_tpu/step_methods/step_sizes.py``).

Nesterov dual averaging as a NamedTuple of ``(chains,)`` tensors, one value
per chain, updated in place of the JAX package's per-chain pytree;
``DualAverageAdaptation`` keeps the reference's class API for one chain.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import torch_floatX

__all__ = ["DAState", "da_init", "da_update", "da_current",
           "DualAverageAdaptation"]


class DAState(NamedTuple):
    """Dual-averaging state, each field ``(chains,)``."""

    log_step: torch.Tensor       # current log step size
    log_bar_step: torch.Tensor   # averaged log step size
    hbar: torch.Tensor           # running average of (target - accept)
    count: torch.Tensor          # t
    mu: torch.Tensor             # shrinkage target log(mu_scale * eps0)
    tuned_accept_sum: torch.Tensor
    tuned_count: torch.Tensor


def da_init(initial_step, target=0.8, mu_scale=10.0) -> DAState:
    """``initial_step``: starting step sizes, a ``(chains,)`` tensor (or a
    number). ``target`` is accepted and unused, as in the JAX package:
    :func:`da_update` takes the target."""
    if not isinstance(initial_step, torch.Tensor):
        initial_step = torch.as_tensor(initial_step, dtype=torch_floatX())
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


class DualAverageAdaptation:
    """Dual averaging of one chain's step size with the reference's class
    API (cf. ``step_sizes.py:91``), over :func:`da_init`,
    :func:`da_update` and :func:`da_current`; ``warnings()`` reports an
    acceptance rate after tuning that misses ``target``."""

    def __init__(self, initial_step, target, gamma=0.05, k=0.75, t0=10):
        self._target = float(target)
        self._gamma = gamma
        self._k = k
        self._t0 = t0
        self.reset(initial_step)

    def reset(self, initial_step):
        self._state = da_init(torch.as_tensor(initial_step,
                                              dtype=torch_floatX()))
        self._tuned_accepts = []

    def current(self, tune):
        return float(da_current(self._state, tune))

    def update(self, accept_stat, tune):
        self._state = da_update(
            self._state, torch.as_tensor(accept_stat, dtype=torch_floatX()),
            tune, target=self._target, gamma=self._gamma, k=self._k,
            t0=self._t0)
        if not tune:
            self._tuned_accepts.append(float(accept_stat))

    def stats(self):
        return {"step_size": float(torch.exp(self._state.log_step)),
                "step_size_bar": float(torch.exp(self._state.log_bar_step))}

    def warnings(self):
        from scipy import stats as st
        from ..backends.report import SamplerWarning, WarningType
        accept = np.asarray(self._tuned_accepts)
        if len(accept) == 0:
            return []
        mean_accept = accept.mean()
        target_accept = self._target
        # a reasonable interval of acceptance rates, from the reference
        # (found mostly by trial and error)
        n_bound = min(100, len(accept))
        n_good, n_bad = mean_accept * n_bound, (1 - mean_accept) * n_bound
        lower, upper = st.beta(n_good + 1, n_bad + 1).interval(0.95)
        if target_accept < lower or target_accept > upper:
            msg = (
                f"The acceptance probability does not match the target. It is "
                f"{mean_accept:g}, but should be close to {target_accept:g}. "
                "Try to increase the number of tuning steps."
            )
            info = {"target": target_accept, "actual": mean_accept,
                    "lower": lower, "upper": upper}
            return [SamplerWarning(WarningType.BAD_ACCEPTANCE, msg, "warn",
                                   None, None, info)]
        return []
