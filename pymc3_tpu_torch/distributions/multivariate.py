"""Multivariate distributions (cf. ``pymc3_tpu/distributions/multivariate.py``).

Ported so far: ``MvNormal`` with the ``cov`` parametrisation, the GP
marginal likelihood. A covariance that is not positive definite gives a logp
of ``-inf`` through an ok-flag, as in the JAX package: ``cholesky_ex`` with
``check_errors=False`` neither raises nor synchronises with the host, so a
bad leapfrog during warmup is rejected instead of ending the run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import floatX
from ..node import Node, as_node, evaluate
from .distribution import Continuous

__all__ = ["MvNormal"]


def _an(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


class _QuadFormBase(Continuous):
    """Shared cholesky/quadratic-form machinery (cf. ``multivariate.py:49``)."""

    def __init__(self, mu=None, cov=None, **kwargs):
        if cov is None:
            raise ValueError("Only the `cov` parametrisation is ported; "
                             "pass cov=...")
        self.mu = _an(mu if mu is not None else 0.0)
        self.cov = _an(cov)
        super().__init__(**kwargs)

    def _chol(self, env, memo):
        """Lower cholesky of the covariance + ok flag (cf. ``:70-89``)."""
        cov = evaluate(self.cov, env, memo)
        chol, info = torch.linalg.cholesky_ex(cov, check_errors=False)
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        ok = (info == 0) & torch.isfinite(diag).all() & (diag > 0).all()
        eye = torch.eye(chol.shape[-1], dtype=chol.dtype, device=chol.device)
        return torch.where(ok, chol, eye), ok

    def _quaddist(self, value, env, memo):
        """(squared Mahalanobis distance, logdet, ok) (cf. ``:91-106``)."""
        mu = evaluate(self.mu, env, memo)
        chol, ok = self._chol(env, memo)
        delta = value - mu
        squeeze = delta.ndim == 1
        if squeeze:
            delta = delta[None, :]
        sol = torch.linalg.solve_triangular(chol, delta.transpose(-1, -2),
                                            upper=False).transpose(-1, -2)
        quaddist = torch.sum(sol ** 2, dim=-1)
        logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)))
        if squeeze:
            quaddist = quaddist[0]
        return quaddist, logdet, ok


class MvNormal(_QuadFormBase):
    r"""Multivariate normal (cf. ``multivariate.py:167``)."""

    def __init__(self, mu, cov=None, **kwargs):
        if kwargs.get("shape") is None:
            kwargs.pop("shape", None)
            kwargs["shape"] = np.shape(mu.test_value if isinstance(mu, Node)
                                       else np.asarray(mu))
        super().__init__(mu=mu, cov=cov, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env = env or {}
        memo = {} if memo is None else memo
        quaddist, logdet, ok = self._quaddist(value, env, memo)
        k = value.shape[-1]
        out = -0.5 * (k * math.log(2.0 * np.pi) + quaddist) - logdet
        return torch.where(ok, out, -torch.inf)
