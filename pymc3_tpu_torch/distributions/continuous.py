"""Univariate continuous distributions (cf. ``pymc3_tpu/distributions/continuous.py``).

Ported so far: Normal, HalfNormal, HalfCauchy and Gamma, the priors and
likelihoods of the radon and GP-regression models. Each stores its
parameters as symbolic nodes and exposes an elementwise tensor ``logp``
(``-inf`` outside the support via ``bound``) with the same formula as the
JAX package, and the same default transform (log for positive support).
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..config import floatX
from ..node import Node, as_node, apply
from . import transforms
from .dist_math import bound, logpow
from .distribution import Continuous

__all__ = ["Normal", "HalfNormal", "HalfCauchy", "Gamma"]


def _param(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


class PositiveContinuous(Continuous):
    """Positive support; default log transform (cf. ``continuous.py:61``)."""

    def __init__(self, transform=transforms.log, **kwargs):
        if transform == "auto" or transform is True:
            transform = transforms.log
        super().__init__(transform=transform, **kwargs)


def assert_negative_support(var, label, distname, value=-1e-6):
    """Warn when a parameter's test value is not positive
    (cf. ``continuous.py:91``)."""
    if np.any(np.asarray(as_node(var).test_value) <= value):
        warnings.warn(
            f"The variable specified for {label} has negative support for "
            f"{distname}, likely making it unsuitable for this parameter.",
            UserWarning)


def get_tau_sigma(tau=None, sigma=None):
    """Precision/stddev pair from whichever was given
    (cf. ``continuous.py:108``)."""
    if tau is None:
        if sigma is None:
            return as_node(floatX(1.0)), as_node(floatX(1.0))
        sigma = _param(sigma)
        return apply(lambda s: s ** -2.0, sigma), sigma
    if sigma is not None:
        raise ValueError("Can't pass both tau and sigma")
    tau = _param(tau)
    return tau, apply(lambda t: t ** -0.5, tau)


class Normal(Continuous):
    r"""Univariate normal (cf. ``continuous.py:413``)."""

    def __init__(self, mu=0, sigma=None, tau=None, sd=None, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mean = self.median = self.mode = self.mu = _param(mu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma)
        assert_negative_support(self.sigma, "sigma", "Normal")
        super().__init__(**kwargs)

    def logp(self, value, env=None, memo=None):
        mu, tau = self._ev_params(("mu", "tau"), env, memo)
        return bound((-tau * (value - mu) ** 2
                      + torch.log(tau / np.pi / 2.0)) / 2.0,
                     tau > 0)


class HalfNormal(PositiveContinuous):
    r"""Half-normal (cf. ``continuous.py:784``)."""

    def __init__(self, sigma=None, tau=None, sd=None, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mode = as_node(floatX(np.broadcast_to(
            1.0, np.shape(self.sigma.test_value))))
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.sigma)
        assert_negative_support(self.sigma, "sigma", "HalfNormal")
        super().__init__(defaults=("mode",), **kwargs)

    def logp(self, value, env=None, memo=None):
        tau, sigma = self._ev_params(("tau", "sigma"), env, memo)
        return bound(-0.5 * tau * value ** 2
                     + 0.5 * torch.log(tau * 2.0 / np.pi),
                     value >= 0, tau > 0, sigma > 0)


class HalfCauchy(PositiveContinuous):
    r"""Half-Cauchy (cf. ``continuous.py:2361``)."""

    def __init__(self, beta, **kwargs):
        self.median = self.beta = _param(beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.beta)
        assert_negative_support(self.beta, "beta", "HalfCauchy")
        super().__init__(defaults=("median",), **kwargs)

    def logp(self, value, env=None, memo=None):
        beta, = self._ev_params(("beta",), env, memo)
        return bound(math.log(2.0) - math.log(np.pi) - torch.log(beta)
                     - torch.log1p((value / beta) ** 2),
                     value >= 0, beta > 0)


class Gamma(PositiveContinuous):
    r"""Gamma (cf. ``continuous.py:2482``)."""

    def __init__(self, alpha=None, beta=None, mu=None, sigma=None, sd=None,
                 **kwargs):
        if sd is not None:
            sigma = sd
        alpha, beta = self.get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        self.mean = apply(lambda a, b: a / b, self.alpha, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.alpha, "alpha", "Gamma")
        assert_negative_support(self.beta, "beta", "Gamma")
        super().__init__(defaults=("mean",), **kwargs)

    @staticmethod
    def get_alpha_beta(alpha=None, beta=None, mu=None, sigma=None):
        """cf. ``continuous.py:2560``."""
        if alpha is not None and beta is not None:
            return alpha, beta
        if mu is not None and sigma is not None:
            return (mu / sigma) ** 2, mu / sigma ** 2
        raise ValueError(
            "Incompatible parameterization. Either use alpha and beta, or mu "
            "and sigma to specify distribution.")

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        logp = (-torch.special.gammaln(alpha) + logpow(beta, alpha)
                - beta * value + logpow(value, alpha - 1.0))
        return bound(logp, value >= 0, alpha > 0, beta > 0)
