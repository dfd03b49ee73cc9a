"""Gaussian process implementations (cf. ``pymc3_tpu/gp/gp.py``).

Ported so far: ``Marginal.marginal_likelihood``, conjugate GP regression
with an observed MvNormal over K(X) + noise.
"""
from __future__ import annotations

from ..node import Node, as_node
from .cov import Constant, Covariance, WhiteNoise
from .mean import Zero
from .util import conditioned_vars, infer_shape

__all__ = ["Marginal"]


class Base:
    """Base class for GP objects (cf. ``gp.py:34``)."""

    def __init__(self, mean_func=None, cov_func=None):
        self.mean_func = mean_func if mean_func is not None else Zero()
        self.cov_func = cov_func if cov_func is not None else Constant(0.0)


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
        if not isinstance(noise, Covariance):
            noise = WhiteNoise(noise)
        mu, cov = self._build_marginal_likelihood(X, noise)
        self.X = X
        self.y = y if isinstance(y, Node) else as_node(y)
        self.noise = noise
        if is_observed:
            return dist.MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)
        shape = infer_shape(X, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)
