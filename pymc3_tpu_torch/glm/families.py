"""GLM families and links (cf. ``pymc3_tpu/glm/families.py``).

A family's default priors are built when a model asks for them, on that
model's device: a distribution made when this module is imported would sit
on whatever device was configured then. So ``priors`` holds numbers,
distributions (a caller's, made inside their model) or zero-argument
functions that make one.
"""
from __future__ import annotations

import numbers

import numpy as np
import torch

from .. import distributions as dist
from ..distributions.distribution import Distribution
from ..model import modelcontext
from ..node import Node, apply as node_apply

__all__ = ["Normal", "StudentT", "Binomial", "Poisson", "NegativeBinomial",
           "Family"]


class _Identity:
    name = "identity"

    def __call__(self, x):
        return x


class _Logit:
    name = "logit-inverse"

    def __call__(self, x):
        return node_apply(lambda v: 1.0 / (1.0 + torch.exp(-v)), x) \
            if isinstance(x, Node) else 1.0 / (1.0 + np.exp(-x))


class _Exp:
    name = "exp"

    def __call__(self, x):
        return node_apply(torch.exp, x) if isinstance(x, Node) else np.exp(x)


identity = _Identity()
logit_inv = _Logit()
exp = _Exp()


def _half_cauchy_10():
    return dist.HalfCauchy.dist(beta=10, testval=1.0)


class Family:
    """Base class for GLM families (cf. ``families.py:42``)."""

    priors = {}
    link = None

    def __init__(self, **kwargs):
        fams = dict(self.priors)
        fams.update(kwargs.get("priors", {}))
        self.priors = fams
        if "link" in kwargs:
            self.link = kwargs["link"]

    def _get_priors(self, model=None, name=""):
        """Instantiate the prior distributions on the model
        (cf. ``families.py:53``)."""
        if name:
            name = f"{name}_"
        model = modelcontext(model)
        priors = {}
        for key, val in self.priors.items():
            if isinstance(val, (numbers.Number, np.ndarray, np.generic)):
                priors[key] = val
                continue
            if not isinstance(val, Distribution):
                with model:
                    val = val()
            priors[key] = model.Var(f"{name}{key}", val)
        return priors

    def create_likelihood(self, name, y_est, y_data, model=None):
        """Create the likelihood variable (cf. ``families.py:67``)."""
        priors = self._get_priors(model=model, name=name)
        priors[self.parent] = self.link(y_est)
        if name:
            name = f"{name}_"
        return self.likelihood(f"{name}y", observed=y_data, **priors)

    def __repr__(self):
        return f"Family {self.__class__.__name__}"


class StudentT(Family):
    """cf. ``families.py:95``."""

    link = identity
    likelihood = dist.StudentT
    parent = "mu"
    priors = {"lam": _half_cauchy_10, "nu": 1}

    def create_likelihood(self, name, y_est, y_data, model=None):
        priors = self._get_priors(model=model, name=name)
        priors[self.parent] = self.link(y_est)
        if name:
            name = f"{name}_"
        lam = priors.pop("lam")
        nu = priors.pop("nu")
        return dist.StudentT(f"{name}y", nu=nu, mu=priors["mu"], lam=lam,
                             observed=y_data)


class Normal(Family):
    """cf. ``families.py:105``."""

    link = identity
    likelihood = dist.Normal
    parent = "mu"
    priors = {"sd": _half_cauchy_10}

    def create_likelihood(self, name, y_est, y_data, model=None):
        priors = self._get_priors(model=model, name=name)
        mu = self.link(y_est)
        if name:
            name = f"{name}_"
        return dist.Normal(f"{name}y", mu=mu, sigma=priors["sd"],
                           observed=y_data)


class Binomial(Family):
    """cf. ``families.py:113``."""

    link = logit_inv
    likelihood = dist.Binomial
    parent = "p"
    priors = {"n": 1}

    def create_likelihood(self, name, y_est, y_data, model=None):
        priors = self._get_priors(model=model, name=name)
        p = self.link(y_est)
        if name:
            name = f"{name}_"
        return dist.Binomial(f"{name}y", n=priors["n"], p=p,
                             observed=np.asarray(y_data, dtype="int32"))


class Poisson(Family):
    """cf. ``families.py:121``."""

    link = exp
    likelihood = dist.Poisson
    parent = "mu"
    priors = {}

    def create_likelihood(self, name, y_est, y_data, model=None):
        mu = self.link(y_est)
        if name:
            name = f"{name}_"
        return dist.Poisson(f"{name}y", mu=mu,
                            observed=np.asarray(y_data, dtype="int32"))


class NegativeBinomial(Family):
    """cf. ``families.py:129``."""

    link = exp
    likelihood = dist.NegativeBinomial
    parent = "mu"
    priors = {"alpha": _half_cauchy_10}

    def create_likelihood(self, name, y_est, y_data, model=None):
        priors = self._get_priors(model=model, name=name)
        mu = self.link(y_est)
        if name:
            name = f"{name}_"
        return dist.NegativeBinomial(f"{name}y", mu=mu,
                                     alpha=priors["alpha"],
                                     observed=np.asarray(y_data,
                                                         dtype="int32"))
