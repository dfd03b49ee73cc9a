"""GP mean functions (cf. ``pymc3_tpu/gp/mean.py``)."""
from __future__ import annotations

import torch

from ..config import torch_floatX
from ..node import apply as node_apply, as_node

__all__ = ["Zero", "Constant", "Linear", "Mean"]


def _rows(X):
    return X.shape[0] if X.ndim else 1


class Mean:
    """Base mean class (cf. ``mean.py:22``)."""

    def __call__(self, X):
        raise NotImplementedError

    def __add__(self, other):
        return Add(self, other)

    def __mul__(self, other):
        return Prod(self, other)


class Zero(Mean):
    """cf. ``mean.py:42``."""

    def __call__(self, X):
        return node_apply(
            lambda X_: torch.zeros(_rows(X_), dtype=torch_floatX(),
                                   device=X_.device), as_node(X))


class Constant(Mean):
    """cf. ``mean.py:51``."""

    def __init__(self, c=0):
        self.c = c

    def __call__(self, X):
        return node_apply(
            lambda X_, c: torch.ones(_rows(X_), dtype=torch_floatX(),
                                     device=X_.device) * c,
            as_node(X), self.c)


class Linear(Mean):
    """m(X) = X @ coeffs + intercept (cf. ``mean.py:69``)."""

    def __init__(self, coeffs, intercept=0):
        self.b = intercept
        self.A = coeffs

    def __call__(self, X):
        def m(X_, A, b):
            X_ = X_.to(torch_floatX())
            X_ = X_.reshape(1, -1) if X_.ndim < 2 else X_
            return torch.squeeze(X_ @ A.to(torch_floatX())) + b
        return node_apply(m, as_node(X), as_node(self.A), self.b)


class Add(Mean):
    def __init__(self, first_mean, second_mean):
        self.m1 = first_mean
        self.m2 = second_mean

    def __call__(self, X):
        return self.m1(X) + self.m2(X)


class Prod(Mean):
    def __init__(self, first_mean, second_mean):
        self.m1 = first_mean
        self.m2 = second_mean

    def __call__(self, X):
        return self.m1(X) * self.m2(X)
