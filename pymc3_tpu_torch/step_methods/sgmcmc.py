"""Stochastic-gradient MCMC (cf. ``pymc3_tpu/step_methods/sgmcmc.py``).

``BaseStochasticGradient`` and ``SGLD``: each chain's gradient is that of
the model's logp over its own minibatch (the minibatch draw comes from
``noise``, one per chain), an unbiased estimate of the full-data gradient
when the likelihood carries ``total_size``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..data import minibatch_nodes
from ..model import modelcontext
from .arraystep import ArrayStepShared, Competence, TuneContext

__all__ = ["BaseStochasticGradient", "SGLD"]


class SGState(NamedTuple):
    step_count: int     # draws taken (a host integer: the same in every chain)


class BaseStochasticGradient(ArrayStepShared):
    """Base of the stochastic-gradient steppers (cf. ``sgmcmc.py:29``).
    Subclasses implement ``_delta(grad, step_size, noise)``."""

    generates_stats = False

    def __init__(self, vars=None, batch_size=None, total_size=None,
                 step_size=1.0, model=None, random_seed=None, minibatches=None,
                 minibatch_tensors=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self.step_size_base = float(step_size)
        self._minibatches = minibatch_nodes(model)
        logp = model.logp_point_fn()
        self._batched_logp = torch.func.vmap(logp)
        mask = torch.zeros(model.ordering.size, device=model.device)
        self._mask = mask.index_fill(0, self._sub_idx, 1.0)

    def kernel_init(self, q0):
        return SGState(step_count=0)

    def _delta(self, grad, step_size, noise):
        raise NotImplementedError

    def _step_size(self, t):
        """The Robbins-Monro schedule ``a (b + t)^-gamma``."""
        a, b, gamma = self.step_size_base, 10.0, 0.55
        return a * (b + t) ** (-gamma)

    def _grad(self, q, draw):
        with torch.enable_grad():
            q = q.detach().requires_grad_()
            grad, = torch.autograd.grad(self._batched_logp(q, draw).sum(), q)
        return grad

    def kernel_step(self, q, state: SGState, tctx: TuneContext, noise):
        grad = self._grad(q, noise.minibatch(self._minibatches))
        eps = self._step_size(state.step_count)
        q_new = q + self._delta(grad, eps, noise) * self._mask.to(q.dtype)
        return q_new, SGState(state.step_count + 1), {}

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.INCOMPATIBLE  # must be assigned explicitly


class SGLD(BaseStochasticGradient):
    """Stochastic gradient Langevin dynamics (Welling & Teh 2011),
    cf. ``sgmcmc.py:77``."""

    name = "sgld"

    def _delta(self, grad, step_size, noise):
        return 0.5 * step_size * grad + step_size ** 0.5 * \
            noise.normal(grad.shape[1])
