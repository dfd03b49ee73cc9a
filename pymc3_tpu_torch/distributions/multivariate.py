"""Multivariate distributions (cf. ``pymc3_tpu/distributions/multivariate.py``).

Ported so far: ``MvNormal`` with the ``cov`` parametrisation (the GP
marginal likelihood) and ``Dirichlet`` with its stick-breaking default. A
covariance that is not positive definite gives a logp of ``-inf`` through an
ok-flag, as in the JAX package: ``cholesky_ex`` with ``check_errors=False``
neither raises nor synchronises with the host, so a bad leapfrog during
warmup is rejected instead of ending the run.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import floatX
from ..node import Node, as_node, apply, evaluate
from . import transforms
from .dist_math import bound, logpow
from .distribution import (
    Continuous, draw_values, point_lead, rand_normal, _align,
)
from .shape_utils import to_tuple

__all__ = ["MvNormal", "Dirichlet"]


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

    def random(self, point=None, size=None, gen=None):
        """``mu + L z`` with ``L`` the cholesky factor of the covariance at
        each sample (cf. ``multivariate.py:140``)."""
        gen = self._generator(gen)
        mu, cov = draw_values([self.mu, self.cov], point=point, size=size,
                              gen=gen)
        lead = point_lead(point)
        size_t = to_tuple(size)
        shape = size_t + tuple(self.shape)
        n_batch = len(shape) - 1
        chol = torch.linalg.cholesky(cov)
        # the factor's batch axes line up with the draw's batch axes
        chol = chol.reshape(tuple(chol.shape[:lead])
                            + (1,) * (n_batch - chol.ndim + 2)
                            + tuple(chol.shape[lead:]))
        z = rand_normal(gen, shape)
        mu = _align(mu, lead, len(size_t), len(self.shape))
        return mu + (chol @ z[..., None])[..., 0]


class Dirichlet(Continuous):
    r"""Dirichlet over the simplex (cf. ``multivariate.py:206``); its default
    transform is the JAX package's Stan stick breaking."""

    def __init__(self, a, transform=transforms.stick_breaking, *args,
                 **kwargs):
        self.a = _an(a)
        if kwargs.get("shape") is None:
            kwargs["shape"] = tuple(np.shape(self.a.test_value))
        self.mean = apply(lambda a: a / torch.sum(a, dim=-1, keepdim=True),
                          self.a)
        self.mode = apply(
            lambda a: torch.where(torch.all(a > 1),
                                  (a - 1.0) / torch.sum(a - 1.0, dim=-1,
                                                        keepdim=True),
                                  torch.nan), self.a)
        kwargs.setdefault("transform", transform)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        a, = self._ev_params(("a",), env, memo)
        gl = torch.special.gammaln
        lp = torch.sum(logpow(value, a - 1.0) - gl(a), dim=-1) \
            + gl(torch.sum(a, dim=-1))
        return bound(lp,
                     torch.all(value >= 0, dim=-1),
                     torch.all(value <= 1, dim=-1),
                     torch.all(a > 0, dim=-1),
                     broadcast_conditions=False)

    def random(self, point=None, size=None, gen=None):
        """Normalized float64 gamma draws (``torch._sample_dirichlet``)
        (cf. ``multivariate.py:237``)."""
        gen = self._generator(gen)
        a, = draw_values([self.a], point=point, size=size, gen=gen)
        size_t = to_tuple(size)
        shape = size_t + tuple(self.shape)
        a = _align(a, point_lead(point), len(size_t), len(self.shape))
        a = torch.broadcast_to(a.double(), shape).contiguous()
        return torch._sample_dirichlet(a, generator=gen).to(
            getattr(torch, str(self.dtype)))
