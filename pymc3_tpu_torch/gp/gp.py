"""Gaussian process implementations (cf. ``pymc3_tpu/gp/gp.py``).

Ported so far: ``Marginal``, conjugate GP regression: its
``marginal_likelihood`` (an observed MvNormal over K(X) + noise) and the
prediction at new inputs (``conditional``, ``predict``, ``predictt``). The
conditional algebra is symbolic node math over ``torch.linalg`` Cholesky and
triangular solves; the covariances ``K(X, Xnew)`` and ``K(Xnew)`` run through
the fused stationary-covariance kernel at their full width.
"""
from __future__ import annotations

import torch

from ..math import solve_lower
from ..node import Node, apply as node_apply, as_node
from .cov import Constant, Covariance, WhiteNoise
from .mean import Zero
from .util import cholesky, conditioned_vars, infer_shape, stabilize

__all__ = ["Marginal"]


class Base:
    """Base class for GP objects (cf. ``gp.py:34``)."""

    def __init__(self, mean_func=None, cov_func=None):
        self.mean_func = mean_func if mean_func is not None else Zero()
        self.cov_func = cov_func if cov_func is not None else Constant(0.0)

    def conditional(self, name, Xnew, *args, **kwargs):
        raise NotImplementedError

    def predict(self, Xnew, point=None, given=None, diag=False):
        raise NotImplementedError


def _as_noise(noise):
    return noise if isinstance(noise, Covariance) else WhiteNoise(noise)


@conditioned_vars(["X", "y", "noise"])
class Marginal(Base):
    r"""Conjugate marginal GP regression (cf. ``gp.py:344``)."""

    def _build_marginal_likelihood(self, X, noise):
        mu = self.mean_func(X)
        cov = self.cov_func(X) + noise(X)
        return mu, cov

    def marginal_likelihood(self, name, X, y, noise, is_observed=True,
                            **kwargs):
        """MvNormal with K(X) + Σ_noise, observed at ``y``
        (cf. ``gp/gp.py:197-223``)."""
        from .. import distributions as dist
        X = as_node(X)
        noise = _as_noise(noise)
        mu, cov = self._build_marginal_likelihood(X, noise)
        self.X = X
        self.y = y if isinstance(y, Node) else as_node(y)
        self.noise = noise
        if is_observed:
            return dist.MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)
        shape = infer_shape(X, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def _get_given_vals(self, given):
        """The data and the total covariance to condition on: this GP's own,
        or those handed over in ``given`` (``gp`` for the sum this GP is a
        term of; ``X``, ``y`` and ``noise`` together)."""
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "y", "noise"]):
            X, y = as_node(given["X"]), as_node(given["y"])
            noise = _as_noise(given["noise"])
        else:
            X, y, noise = self.X, self.y, self.noise
        return X, y, noise, cov_total, mean_total

    def _build_conditional(self, Xnew, pred_noise, diag, X, y, noise,
                           cov_total, mean_total):
        """The conditional mean and (co)variance at ``Xnew``
        (cf. ``gp.py:243``)."""
        Kxx = cov_total(X)
        Kxs = self.cov_func(X, Xnew)
        Knx = noise(X)
        rxx = y - mean_total(X)
        L = cholesky(stabilize(Kxx) + Knx)
        A = solve_lower(L, Kxs)
        v = solve_lower(L, rxx)
        mu = self.mean_func(Xnew) + node_apply(
            lambda A_, v_: A_.T @ v_, A, v)
        if diag:
            Kss = self.cov_func(Xnew, diag=True)
            var = node_apply(
                lambda Kss_, A_: Kss_ - torch.sum(A_ ** 2, dim=0), Kss, A)
            if pred_noise:
                var = var + noise(Xnew, diag=True)
            return mu, var
        Kss = self.cov_func(Xnew)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        if pred_noise:
            cov = cov + noise(Xnew)
        return mu, cov if pred_noise else stabilize(cov)

    def conditional(self, name, Xnew, pred_noise=False, given=None,
                    **kwargs):
        """The GP at new inputs, given the observations, as an MvNormal
        random variable of the model (cf. ``gp.py:268``)."""
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, False,
                                          *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def predict(self, Xnew, point=None, diag=False, pred_noise=False,
                given=None):
        """Predictive mean and covariance (variance with ``diag``) at a
        point, or at the model's test point, as numpy arrays
        (cf. ``gp.py:277``). The arithmetic runs on the model's device; the
        two results are copied to the host once, at the end."""
        from ..model import modelcontext
        mu, cov = self.predictt(Xnew, diag, pred_noise, given)
        model = modelcontext(None)
        fn = model.makefn([mu, cov])
        m, c = fn(point if point is not None else model.test_point)
        return m, c

    def predictt(self, Xnew, diag=False, pred_noise=False, given=None):
        """Symbolic predictive mean and covariance (cf. ``gp.py:289``)."""
        givens = self._get_given_vals(given)
        return self._build_conditional(as_node(Xnew), pred_noise, diag,
                                       *givens)
