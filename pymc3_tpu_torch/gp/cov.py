"""GP covariance kernels (cf. ``pymc3_tpu/gp/cov.py``).

Each kernel is callable as ``K(X)`` / ``K(X, Xs)`` / ``K(X, diag=True)`` and
returns a symbolic node when any operand (inputs or a hyperparameter such as
the lengthscale RV) is symbolic. The ``Add``/``Prod``/``**`` algebra
(``eta**2 * ExpQuad(...)`` goes through ``__rmul__``), ``Kron``,
``Constant``, ``WhiteNoise``, the stationary family and the non-stationary
kernels (``Linear``, ``Polynomial``, ``WarpedInput``, ``Gibbs``,
``ScaledCov``, ``Coregion``). Only the five stationary kinds that set
``_fused_kind`` run their ``full`` through the fused covariance kernel
(``ops/gp_cov.py``); ``RatQuad``, ``Cosine`` and ``Periodic`` are plain
PyTorch over :meth:`Stationary._sqdist`, as in the JAX package.
"""
from __future__ import annotations

import functools
import operator

import numpy as np
import torch

from ..config import torch_floatX
from ..node import Node, apply as node_apply, as_node

__all__ = [
    "Constant", "WhiteNoise", "ExpQuad", "RatQuad", "Exponential",
    "Matern52", "Matern32", "Matern12", "Linear", "Polynomial", "Cosine",
    "Periodic", "WarpedInput", "Gibbs", "Coregion", "ScaledCov", "Kron",
    "Covariance", "Combination", "Add", "Prod", "Exponentiated",
    "Stationary",
]


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

    def __pow__(self, other):
        return Exponentiated(self, other)

    def __array_wrap__(self, result):
        # keep numpy scalars from consuming `np_scalar * cov`
        return result


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


class Exponentiated(Covariance):
    """``kernel ** power`` (cf. ``cov.py:142``)."""

    def __init__(self, kernel, power):
        self.kernel = kernel
        self.power = power
        super().__init__(input_dim=kernel.input_dim,
                         active_dims=kernel.active_dims)

    def __call__(self, X, Xs=None, diag=False):
        return self.kernel(X, Xs, diag) ** self.power

    full = __call__


class Kron(Covariance):
    """Kronecker product of kernels over column blocks (cf. ``cov.py:175``).
    Each row of X concatenates one coordinate per factor, so on a product
    grid the Kronecker structure is the elementwise product of the blocks'
    kernels (cf. ``cov.py:202-212``)."""

    def __init__(self, factor_list):
        self.input_dims = [factor.input_dim for factor in factor_list]
        super().__init__(input_dim=sum(self.input_dims))
        self.factor_list = factor_list

    def _split(self, X, Xs):
        starts = np.concatenate([[0], np.cumsum(self.input_dims)[:-1]])
        Xp, Xsp = [], []
        for s, d in zip(starts.tolist(), self.input_dims):
            def slc(M, s=s, d=d):
                return M.to(torch_floatX())[:, s:s + d]
            Xp.append(node_apply(slc, as_node(X)))
            Xsp.append(None if Xs is None else node_apply(slc, as_node(Xs)))
        return Xp, Xsp

    def full(self, X, Xs=None):
        Xp, Xsp = self._split(X, Xs)
        return functools.reduce(operator.mul, [
            f.full(xp, xsp)
            for f, xp, xsp in zip(self.factor_list, Xp, Xsp)])


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
    ``ls_inv``. The five kinds with a fused kernel set ``_fused_kind`` and
    take :meth:`_fused_full` as their ``full``; the others build on
    :meth:`square_dist`."""

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

    @staticmethod
    def _sqdist(X, Xs, ls):
        """Squared distance of lengthscale-scaled, mean-centred inputs
        (cf. ``cov.py:257``): exact pairwise differences up to 32 features
        (the matmul form cancels in float32 on close points), the matmul
        form above."""
        X = X.to(torch_floatX()) / ls
        Xs = X if Xs is None else Xs.to(torch_floatX()) / ls
        c = torch.mean(X, dim=0)
        X = X - c
        Xs = Xs - c
        if X.shape[-1] <= 32:
            d2 = torch.sum((X[:, None, :] - Xs[None, :, :]) ** 2, dim=-1)
        else:
            X2 = torch.sum(X ** 2, dim=-1)
            Xs2 = torch.sum(Xs ** 2, dim=-1)
            d2 = X2[:, None] + Xs2[None, :] - 2 * X @ Xs.T
        return torch.clamp(d2, min=0.0)

    def square_dist(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        if Xs is None:
            return node_apply(lambda X_, ls: self._sqdist(X_, None, ls),
                              X, self.ls)
        return node_apply(self._sqdist, X, Xs, self.ls)

    def euclidean_dist(self, X, Xs=None):
        return node_apply(lambda d2: torch.sqrt(d2 + 1e-12),
                          self.square_dist(X, Xs))

    def diag(self, X):
        return node_apply(
            lambda X_: torch.ones(_n_rows(X_), dtype=torch_floatX(),
                                  device=X_.device), as_node(X))

    def full(self, X, Xs=None):
        raise NotImplementedError

    def _fused_full(self, X, Xs=None):
        """K via the fused distance+covariance kernel
        (cf. ``Stationary._fused_full``, gp/cov.py:301-318)."""
        from ..ops.gp_cov import stationary_cov
        kind = self._fused_kind

        def f(X_, Xs_, ls):
            # both inputs in floatX, so K comes out of the kernel of the
            # configured width (float32 or float64)
            Xl = X_.to(torch_floatX()) / ls
            Xsl = Xl if Xs_ is None else Xs_.to(torch_floatX()) / ls
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
    full = Stationary._fused_full


class RatQuad(Stationary):
    r"""Rational quadratic (cf. ``cov.py:346``)."""

    def __init__(self, input_dim, alpha, ls=None, ls_inv=None,
                 active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.alpha = alpha

    def full(self, X, Xs=None):
        return node_apply(lambda d2, a: torch.pow(1.0 + 0.5 * d2 / a, -a),
                          self.square_dist(X, Xs), self.alpha)


class Matern52(Stationary):
    r"""cf. ``cov.py:367``."""

    _fused_kind = "matern52"
    full = Stationary._fused_full


class Matern32(Stationary):
    r"""cf. ``cov.py:386``."""

    _fused_kind = "matern32"
    full = Stationary._fused_full


class Matern12(Stationary):
    r"""k = exp(-|x-x'| / l)."""

    _fused_kind = "matern12"
    full = Stationary._fused_full


class Exponential(Stationary):
    r"""k = exp(-|x-x'| / (2l)) (cf. ``cov.py:415``)."""

    _fused_kind = "exponential"
    full = Stationary._fused_full


class Cosine(Stationary):
    r"""k = cos(2 pi |x-x'| / l) (cf. ``cov.py:429``)."""

    def full(self, X, Xs=None):
        return node_apply(lambda r: torch.cos(2 * np.pi * r),
                          self.euclidean_dist(X, Xs))


class Periodic(Stationary):
    r"""Periodic kernel (cf. ``cov.py:308``)."""

    def __init__(self, input_dim, period, ls=None, ls_inv=None,
                 active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.period = period

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(X_, Xs_, per, ls):
            Xs_ = X_ if Xs_ is None else Xs_
            d = X_[:, None, :] - Xs_[None, :, :]
            s = torch.sin(np.pi * d / per) / ls
            return torch.exp(-2.0 * torch.sum(s ** 2, dim=-1))
        if Xs is None:
            return node_apply(lambda X_, p, l: k(X_, None, p, l),
                              X, self.period, self.ls)
        return node_apply(k, X, Xs, self.period, self.ls)


class Linear(Covariance):
    r"""k = (x-c)(x'-c) (cf. ``cov.py:442``)."""

    def __init__(self, input_dim, c, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.c = c

    def _common(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(X_, Xs_, c):
            Xc = X_ - c
            Xsc = Xc if Xs_ is None else Xs_ - c
            return Xc @ Xsc.T
        if Xs is None:
            return node_apply(lambda X_, c: k(X_, None, c), X, self.c)
        return node_apply(k, X, Xs, self.c)

    def full(self, X, Xs=None):
        return self._common(X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(lambda X_, c: torch.sum((X_ - c) ** 2, dim=-1),
                          X, self.c)


class Polynomial(Linear):
    r"""k = ((x-c)(x'-c) + offset)^d (cf. ``cov.py:472``)."""

    def __init__(self, input_dim, c, d, offset, active_dims=None):
        super().__init__(input_dim, c, active_dims)
        self.d = d
        self.offset = offset

    def full(self, X, Xs=None):
        return node_apply(lambda L, o, d: torch.pow(L + o, d),
                          self._common(X, Xs), self.offset, self.d)

    def diag(self, X):
        return node_apply(lambda L, o, d: torch.pow(L + o, d),
                          super().diag(X), self.offset, self.d)


class WarpedInput(Covariance):
    r"""A kernel on warped inputs, k(w(x), w(x')) (cf. ``cov.py:494``).
    ``warp_func`` takes and returns tensors."""

    def __init__(self, input_dim, cov_func, warp_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if not callable(warp_func):
            raise TypeError("warp_func must be callable")
        if not isinstance(cov_func, Covariance):
            raise TypeError("Must be or inherit from the Covariance class")
        self.w = warp_func
        self.args = args
        self.cov_func = cov_func

    def _warp(self, X):
        args = () if self.args is None else tuple(self.args)
        return node_apply(lambda x, *a: self.w(x, *a), X, *args)

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        return self.cov_func.full(self._warp(X),
                                  None if Xs is None else self._warp(Xs))

    def diag(self, X):
        X, _ = self._slice(X, None)
        return self.cov_func.diag(self._warp(X))


class Gibbs(Covariance):
    r"""Non-stationary Gibbs kernel with an input-dependent lengthscale
    (cf. ``cov.py:533``); ``lengthscale_func`` takes and returns tensors."""

    def __init__(self, input_dim, lengthscale_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if active_dims is not None and len(np.atleast_1d(active_dims)) > 1:
            raise NotImplementedError("Higher dimensional inputs are "
                                      "untested")
        if not callable(lengthscale_func):
            raise TypeError("lengthscale_func must be callable")
        self.lfunc = lengthscale_func
        self.args = args

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        args = () if self.args is None else tuple(self.args)

        def k(X_, Xs_, *a):
            x = X_.reshape(-1)
            z = x if Xs_ is None else Xs_.reshape(-1)
            rx = self.lfunc(x, *a)
            rz = self.lfunc(z, *a)
            d2 = (x[:, None] - z[None, :]) ** 2
            denom = rx[:, None] ** 2 + rz[None, :] ** 2
            return torch.sqrt(2.0 * torch.outer(rx, rz) / denom) * \
                torch.exp(-d2 / denom)
        if Xs is None:
            return node_apply(lambda X_, *a: k(X_, None, *a), X, *args)
        return node_apply(k, X, Xs, *args)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(
            lambda X_: torch.ones(_n_rows(X_), dtype=torch_floatX(),
                                  device=X_.device), X)


class ScaledCov(Covariance):
    r"""A kernel scaled by an input-dependent function, s(x) k(x, x') s(x')
    (cf. ``cov.py:600``); ``scaling_func`` takes and returns tensors."""

    def __init__(self, input_dim, cov_func, scaling_func, args=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if not callable(scaling_func):
            raise TypeError("scaling_func must be callable")
        if not isinstance(cov_func, Covariance):
            raise TypeError("Must be or inherit from the Covariance class")
        self.cov_func = cov_func
        self.scaling_func = scaling_func
        self.args = args

    def _scf(self, X):
        args = () if self.args is None else tuple(self.args)
        return node_apply(lambda x, *a: self.scaling_func(x, *a).reshape(-1),
                          X, *args)

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)
        K = self.cov_func.full(X, Xs)
        sx = self._scf(X)
        sz = sx if Xs is None else self._scf(Xs)
        return node_apply(lambda K_, a, b: torch.outer(a, b) * K_, K, sx, sz)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(lambda d, s: s ** 2 * d, self.cov_func.diag(X),
                          self._scf(X))


class Coregion(Covariance):
    r"""Coregionalization kernel B[i, j] over integer task indices
    (cf. ``cov.py:645``): B = W Wᵀ + diag(kappa), or B given."""

    def __init__(self, input_dim, W=None, kappa=None, B=None,
                 active_dims=None):
        super().__init__(input_dim, active_dims)
        if len(np.atleast_1d(self.active_dims)) != 1:
            raise ValueError("Coregion requires exactly one dimension to be "
                             "active")
        make_B = W is not None or kappa is not None
        if make_B and B is not None:
            raise ValueError("Exactly one of (W, kappa) and B must be "
                             "provided to Coregion")
        if make_B:
            self.W = W
            self.kappa = kappa
            self.B = node_apply(
                lambda W_, k_: W_.to(torch_floatX()) @ W_.to(
                    torch_floatX()).T + torch.diag(k_.to(torch_floatX())),
                W, kappa)
        elif B is not None:
            self.B = as_node(B)
        else:
            raise ValueError("Exactly one of (W, kappa) and B must be "
                             "provided to Coregion")

    def full(self, X, Xs=None):
        X, Xs = self._slice(X, Xs)

        def k(B, X_, Xs_):
            ix = X_.reshape(-1).to(torch.int64)
            iz = ix if Xs_ is None else Xs_.reshape(-1).to(torch.int64)
            return B[ix][:, iz]
        if Xs is None:
            return node_apply(lambda B, X_: k(B, X_, None), self.B, X)
        return node_apply(k, self.B, X, Xs)

    def diag(self, X):
        X, _ = self._slice(X, None)
        return node_apply(
            lambda B, X_: torch.diagonal(B)[X_.reshape(-1).to(torch.int64)],
            self.B, X)
