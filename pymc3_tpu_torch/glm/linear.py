"""Linear model components (cf. ``pymc3_tpu/glm/linear.py``)."""
from __future__ import annotations

import numpy as np

from .. import distributions as dist
from ..model import Deterministic, Model, ScalarStack
from ..node import apply as node_apply
from . import families
from .utils import any_to_tensor_and_labels, design_matrices

__all__ = ["LinearComponent", "GLM"]


class LinearComponent(Model):
    """Creates linear component: y_est = X β (cf. ``linear.py:29``).

    Parameters
    ----------
    x : matrix, dict of columns or DataFrame
    y : vector
    intercept : bool - add constant term
    labels : list of column names
    priors : dict of {name: distribution} overrides; 'Intercept' and
        'Regressor' keys set defaults. The defaults, a flat intercept and
        Normal(0, tau=1e-6) coefficients, are made on the model's device.
    """

    def __init__(self, x, y, intercept=True, labels=None, priors=None,
                 vars=None, name="", model=None, offset=0.0):
        super().__init__(name, model)
        if len(y.shape) > 1:
            err_msg = ("Only one-dimensional observed variable objects (i.e."
                       " of shape `(n, )`) are supported")
            raise TypeError(err_msg)
        if priors is None:
            priors = {}
        if vars is None:
            vars = {}
        x, labels = any_to_tensor_and_labels(x, labels)
        if intercept:
            x = np.concatenate([np.ones((x.shape[0], 1)), x], axis=1)
            labels = ["Intercept"] + labels
        self.x = x
        with self:
            default_regressor = dist.Normal.dist(mu=0, tau=1.0e-6)
            default_intercept = dist.Flat.dist()
        coeffs = []
        for name_ in labels:
            if name_ in vars:
                coeffs.append(vars[name_])
            elif name_ == "Intercept":
                coeffs.append(self.Var(name_, priors.get(
                    name_, default_intercept)))
            else:
                coeffs.append(self.Var(name_, priors.get(
                    name_, priors.get("Regressor", default_regressor))))
        self.coeffs = coeffs

        def linear(x_const, b):
            return x_const @ b + offset
        self.y_est = node_apply(linear, x, ScalarStack(coeffs))

    @classmethod
    def from_formula(cls, formula, data, priors=None, vars=None, name="",
                     model=None, offset=0.0):
        """cf. ``linear.py:109`` (native formula parser instead of patsy)."""
        y, x, labels = design_matrices(formula, data)
        return cls(x, y, intercept=False, labels=labels, priors=priors,
                   vars=vars, name=name, model=model, offset=offset)


class GLM(LinearComponent):
    """Creates GLM: linear component + family likelihood
    (cf. ``linear.py:127``)."""

    def __init__(self, x, y, intercept=True, labels=None, priors=None,
                 vars=None, family="normal", name="", model=None,
                 offset=0.0):
        super().__init__(x, y, intercept=intercept, labels=labels,
                         priors=priors, vars=vars, name=name, model=model,
                         offset=offset)
        _families = dict(
            normal=families.Normal,
            student=families.StudentT,
            binomial=families.Binomial,
            poisson=families.Poisson,
            negative_binomial=families.NegativeBinomial,
        )
        if isinstance(family, str):
            family = _families[family]()
        self.y_est_name = "y_est"
        Deterministic("mu", family.link(self.y_est), model=self)
        family.create_likelihood(name, self.y_est, y, model=self)

    @classmethod
    def from_formula(cls, formula, data, priors=None, vars=None,
                     family="normal", name="", model=None, offset=0.0):
        """cf. ``linear.py:164``."""
        y, x, labels = design_matrices(formula, data)
        return cls(x, y, intercept=False, labels=labels, priors=priors,
                   vars=vars, family=family, name=name, model=model,
                   offset=offset)
