"""Leapfrog integration (cf. ``pymc3_tpu/step_methods/hmc/integration.py``).

One step for a whole batch of chains: ``q, p, v, q_grad`` are ``(chains,
n)``, ``energy, model_logp`` and the step size ``(chains,)``.
``CpuLeapfrogIntegrator`` keeps the reference's class API for one chain.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ...config import default_device, torch_floatX
from .quadpotential import kernel_mass, mass_velocity

__all__ = ["IntegrationState", "leapfrog", "compute_state",
           "IntegrationError", "CpuLeapfrogIntegrator"]


class IntegrationError(RuntimeError):
    pass


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


class CpuLeapfrogIntegrator:
    """The reference's integrator API for one chain (cf.
    ``integration.py:69``) over :func:`leapfrog`: ``potential`` is a
    quadpotential, ``logp_dlogp_func`` maps one flat point ``q: (n,)`` to
    ``(logp, dlogp)`` (``Model.make_logp_dlogp_fn()``). States hold one
    chain's ``(n,)`` tensors."""

    def __init__(self, potential, logp_dlogp_func):
        self._potential = potential
        self._logp_dlogp_func = logp_dlogp_func

    def _batched(self, q):
        logp, grad = self._logp_dlogp_func(q[0])
        return logp[None], grad[None]

    def _var(self, device):
        # an adaptive diagonal potential's host state holds its adapted
        # mass; the JAX package's init_kernel_state returns that state
        state = getattr(self._potential, "_state", None)
        if state is None:
            state = self._potential.init_kernel_state(1, device)
        return kernel_mass(state).to(device)

    def _one_chain(self, state):
        return IntegrationState(*(t[0] for t in state))

    def compute_state(self, q, p):
        device = q.device if torch.is_tensor(q) else default_device()
        q, p = (torch.as_tensor(a, dtype=torch_floatX(),
                                device=device)[None] for a in (q, p))
        return self._one_chain(compute_state(self._batched,
                                             self._var(device), q, p))

    def step(self, epsilon, state):
        """One leapfrog step of size ``epsilon``; raises
        :class:`IntegrationError` when the energy is not finite."""
        device = state.q.device
        eps = torch.as_tensor(epsilon, dtype=state.q.dtype,
                              device=device).reshape(1)
        batched = IntegrationState(*(t[None] for t in state))
        out = self._one_chain(leapfrog(self._batched, self._var(device),
                                       eps, batched))
        if not bool(torch.isfinite(out.energy)):
            raise IntegrationError(
                f"Energy is not finite after leapfrog: {out.energy}")
        return out
