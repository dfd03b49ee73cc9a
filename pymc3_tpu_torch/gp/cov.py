"""GP covariance kernels (cf. ``pymc3_tpu/gp/cov.py``).

Each kernel is callable as ``K(X)`` / ``K(X, Xs)`` / ``K(X, diag=True)`` and
returns a symbolic node when any operand (inputs or a hyperparameter such as
the lengthscale RV) is symbolic. Ported so far: the ``Add``/``Prod`` algebra
(``eta**2 * ExpQuad(...)`` goes through ``__rmul__``), ``Constant``,
``WhiteNoise``, and the five stationary kernels whose ``full`` runs through
the fused covariance kernel (``ops/gp_cov.py``).
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ..config import torch_floatX
from ..node import Node, apply as node_apply, as_node

__all__ = ["Constant", "WhiteNoise", "ExpQuad", "Exponential", "Matern52",
           "Matern32", "Matern12", "Covariance", "Combination", "Add", "Prod",
           "Stationary"]


class Covariance:
    """Base class for kernels (cf. ``cov.py:34``)."""

    def __init__(self, input_dim, active_dims=None):
        self.input_dim = int(input_dim)
        if active_dims is None:
            self.active_dims = np.arange(input_dim)
        else:
            self.active_dims = np.asarray(active_dims, int)

    def __call__(self, X, Xs=None, diag=False):
        if diag:
            return self.diag(X)
        return self.full(X, Xs)

    def diag(self, X):
        return node_apply(torch.diagonal, self.full(X, None))

    def full(self, X, Xs=None):
        raise NotImplementedError

    def _slice(self, X, Xs=None):
        """Active columns of X (and Xs) as floatX nodes on the model's
        device."""
        idx = self.active_dims.tolist()

        def slc(M):
            M = M.to(torch_floatX())
            if M.ndim == 1:
                M = M[:, None]
            return M[:, idx]
        X = node_apply(slc, as_node(X))
        if Xs is not None:
            Xs = node_apply(slc, as_node(Xs))
        return X, Xs

    # combination algebra (cf. cov.py:96-119)
    def __add__(self, other):
        return Add([self, other])

    def __radd__(self, other):
        return Add([other, self])

    def __mul__(self, other):
        return Prod([self, other])

    def __rmul__(self, other):
        return Prod([other, self])


class Combination(Covariance):
    """cf. ``cov.py:120``."""

    def __init__(self, factor_list):
        input_dim = max(factor.input_dim for factor in factor_list
                        if isinstance(factor, Covariance))
        super().__init__(input_dim=input_dim)
        self.factor_list = []
        for factor in factor_list:
            if isinstance(factor, self.__class__):
                self.factor_list.extend(factor.factor_list)
            else:
                self.factor_list.append(factor)

    def merge_factors(self, X, Xs=None, diag=False):
        return [factor(X, Xs, diag) if isinstance(factor, Covariance)
                else factor for factor in self.factor_list]


class Add(Combination):
    def __call__(self, X, Xs=None, diag=False):
        return functools.reduce(operator.add, self.merge_factors(X, Xs, diag))

    full = __call__


class Prod(Combination):
    def __call__(self, X, Xs=None, diag=False):
        return functools.reduce(operator.mul, self.merge_factors(X, Xs, diag))

    full = __call__


def _n_rows(X):
    return X.shape[0]


class Constant(Covariance):
    """cf. ``cov.py:214``."""

    def __init__(self, c):
        super().__init__(1, None)
        self.c = c

    def diag(self, X):
        return node_apply(
            lambda X_, c: torch.full((_n_rows(X_),), 1.0, dtype=X_.dtype,
                                     device=X_.device) * c,
            as_node(X), self.c)

    def full(self, X, Xs=None):
        Xs = X if Xs is None else Xs
        return node_apply(
            lambda X_, Xs_, c: torch.full((_n_rows(X_), _n_rows(Xs_)), 1.0,
                                          dtype=X_.dtype,
                                          device=X_.device) * c,
            as_node(X), as_node(Xs), self.c)


class WhiteNoise(Covariance):
    """cf. ``cov.py:237``."""

    def __init__(self, sigma):
        super().__init__(1, None)
        self.sigma = sigma

    def diag(self, X):
        return node_apply(
            lambda X_, s: torch.ones(_n_rows(X_), dtype=torch_floatX(),
                                     device=X_.device) * s ** 2,
            as_node(X), self.sigma)

    def full(self, X, Xs=None):
        if Xs is None:
            return node_apply(
                lambda X_, s: torch.eye(_n_rows(X_), dtype=torch_floatX(),
                                        device=X_.device) * s ** 2,
                as_node(X), self.sigma)
        return node_apply(
            lambda X_, Xs_: torch.zeros((_n_rows(X_), _n_rows(Xs_)),
                                        dtype=torch_floatX(),
                                        device=X_.device),
            as_node(X), as_node(Xs))


class Stationary(Covariance):
    """Base for stationary kernels (cf. ``cov.py:262``): ``ls`` or
    ``ls_inv``. ``full`` is K = f(d^2) through the fused kernel."""

    _fused_kind = None

    def __init__(self, input_dim, ls=None, ls_inv=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        if (ls is None) == (ls_inv is None):
            raise ValueError("Specify one of ls or ls_inv")
        if ls_inv is not None:
            if isinstance(ls_inv, Node):
                ls = node_apply(lambda v: 1.0 / v, ls_inv)
            else:
                ls = 1.0 / np.asarray(ls_inv, dtype=float)
        if isinstance(ls, (list, tuple)):
            ls = np.asarray(ls)
        self.ls = ls

    def diag(self, X):
        return node_apply(
            lambda X_: torch.ones(_n_rows(X_), dtype=torch_floatX(),
                                  device=X_.device), as_node(X))

    def full(self, X, Xs=None):
        """K via the fused distance+covariance kernel
        (cf. ``Stationary._fused_full``, gp/cov.py:301-318)."""
        from ..ops.gp_cov import stationary_cov
        kind = self._fused_kind

        def f(X_, Xs_, ls):
            Xl = X_ / ls
            Xsl = Xl if Xs_ is None else Xs_ / ls
            # mean-centring: distance-invariant, keeps float32 magnitudes
            # small (as in the JAX package)
            c = torch.mean(Xl, dim=0)
            return stationary_cov(Xl - c, Xsl - c, kind=kind)

        X, Xs = self._slice(X, Xs)
        if Xs is None:
            return node_apply(lambda X_, ls: f(X_, None, ls), X, self.ls)
        return node_apply(f, X, Xs, self.ls)


class ExpQuad(Stationary):
    r"""k(x,x') = exp(-|x-x'|^2 / (2 l^2)) (cf. ``cov.py:331``)."""

    _fused_kind = "expquad"


class Matern52(Stationary):
    r"""cf. ``cov.py:367``."""

    _fused_kind = "matern52"


class Matern32(Stationary):
    r"""cf. ``cov.py:386``."""

    _fused_kind = "matern32"


class Matern12(Stationary):
    r"""k = exp(-|x-x'| / l)."""

    _fused_kind = "matern12"


class Exponential(Stationary):
    r"""k = exp(-|x-x'| / (2l)) (cf. ``cov.py:415``)."""

    _fused_kind = "exponential"
