"""Elliptical slice sampling (cf. ``pymc3_tpu/step_methods/elliptical_slice.py``).

For models with a multivariate-normal prior: propose on the ellipse through
the current state and an auxiliary draw from the prior, shrinking the angle
bracket until the likelihood clears the slice level (Murray, Adams & MacKay
2010). All chains at once: the shrink loop runs to the slowest lane, a lane
that has found its point is frozen by a mask, and the loop ends when no lane
is searching (one ``.any()`` sync per turn, beside that turn's one
likelihood call) or after ``max_steps`` turns, where a lane still searching
keeps its point, as in the JAX package.

The random numbers come from ``noise`` in the JAX kernel's order: the
prior draw ``nu`` (a standard normal times the prior's cholesky factor),
the slice level's uniform, the first angle's uniform, then one uniform per
turn.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import torch_floatX
from ..model import modelcontext
from ..node import Node
from .arraystep import ArrayStepShared, Competence, TuneContext

__all__ = ["EllipticalSlice", "ESState"]


class ESState(NamedTuple):
    loglik: torch.Tensor  # (chains,)


def _matrix(x, device):
    if isinstance(x, Node):
        x = x.test_value
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float64)
    return torch.as_tensor(np.asarray(x, dtype=np.float64), device=device)


class EllipticalSlice(ArrayStepShared):
    """cf. ``elliptical_slice.py:28``. ``prior_cov`` (or ``prior_chol``)
    gives the Gaussian-prior covariance of the selected variables, as an
    array or a tensor (a covariance built on the card stays there); the
    likelihood is the model's observed terms and potentials
    (``Model.datalogpt_fn``)."""

    name = "elliptical_slice"
    default_blocked = True
    generates_stats = False

    def __init__(self, vars=None, prior_cov=None, prior_chol=None,
                 model=None, max_steps=64, **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        if prior_chol is None:
            if prior_cov is None:
                raise ValueError("Must provide prior_cov or prior_chol")
            chol = torch.linalg.cholesky(_matrix(prior_cov, model.device))
        else:
            chol = _matrix(prior_chol, model.device)
        self.prior_chol = chol.to(torch_floatX())
        self.max_steps = int(max_steps)
        self._loglik_fn = model.datalogpt_fn()

    def kernel_init(self, q0):
        return ESState(loglik=self._loglik_fn(q0))

    def kernel_step(self, q, state: ESState, tctx: TuneContext, noise):
        # another stepper may have moved q since our last call
        loglik = self._loglik_fn(q) if self.is_partial else state.loglik
        x0 = self._sub(q)
        nu = noise.normal(self.dim) @ self.prior_chol.T
        y = loglik + torch.log(noise.uniform())
        theta = 2.0 * math.pi * noise.uniform()
        lo, hi = theta - 2.0 * math.pi, theta

        def propose(theta):
            return x0 * torch.cos(theta)[:, None] \
                + nu * torch.sin(theta)[:, None]

        done = torch.zeros_like(y, dtype=torch.bool)
        new_loglik = loglik
        for _ in range(self.max_steps):
            active = ~done
            if not bool(active.any()):
                break
            ll = self._loglik_fn(self._scatter(q, propose(theta)))
            ok = active & (ll > y)
            miss = active & ~(ll > y)
            lo = torch.where(miss & (theta < 0), theta, lo)
            hi = torch.where(miss & (theta >= 0), theta, hi)
            u = noise.uniform()
            theta = torch.where(miss, lo + (hi - lo) * u, theta)
            new_loglik = torch.where(ok, ll, new_loglik)
            done = done | ok
        x_new = torch.where(done[:, None], propose(theta), x0)
        return self._scatter(q, x_new), ESState(loglik=new_loglik), {}

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.INCOMPATIBLE  # must be assigned explicitly
