"""Leapfrog integration (cf. ``pymc3_tpu/step_methods/hmc/integration.py``).

One step for a whole batch of chains: ``q, p, v, q_grad`` are ``(chains,
n)``, ``energy, model_logp`` and the step size ``(chains,)``.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .quadpotential import mass_velocity

__all__ = ["IntegrationState", "leapfrog", "compute_state"]


class IntegrationState(NamedTuple):
    """cf. the ``State`` namedtuple (``integration.py:16``)."""

    q: torch.Tensor       # position
    p: torch.Tensor       # momentum
    v: torch.Tensor       # velocity M^{-1} p
    q_grad: torch.Tensor  # dlogp/dq
    energy: torch.Tensor  # H = kinetic - logp
    model_logp: torch.Tensor


def _kinetic(p, v):
    return 0.5 * torch.sum(p * v, dim=-1)


def compute_state(logp_dlogp_fn: Callable, var, q, p) -> IntegrationState:
    """Hamiltonian state at (q, p) (cf. ``integration.py:39``)."""
    logp, grad = logp_dlogp_fn(q)
    v = mass_velocity(var, p)
    return IntegrationState(q=q, p=p, v=v, q_grad=grad,
                            energy=_kinetic(p, v) - logp, model_logp=logp)


def leapfrog(logp_dlogp_fn: Callable, var, epsilon,
             state: IntegrationState) -> IntegrationState:
    """Half kick, drift, half kick (cf. ``integration.py:81-109``).
    ``epsilon`` is ``(chains,)`` and may be negative (backwards)."""
    half = (0.5 * epsilon)[:, None]
    p_half = state.p + half * state.q_grad
    q_new = state.q + epsilon[:, None] * mass_velocity(var, p_half)
    logp, q_grad_new = logp_dlogp_fn(q_new)
    p_new = p_half + half * q_grad_new
    v_new = mass_velocity(var, p_new)
    return IntegrationState(q=q_new, p=p_new, v=v_new, q_grad=q_grad_new,
                            energy=_kinetic(p_new, v_new) - logp,
                            model_logp=logp)
