"""GP utilities (cf. ``pymc3_tpu/gp/util.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import floatX, torch_floatX
from ..node import Node, apply as node_apply

__all__ = ["stabilize", "cholesky", "infer_shape", "conditioned_vars",
           "solve_lower", "solve_upper", "kmeans_inducing_points"]

JITTER_DEFAULT = 1e-6


def _default_jitter():
    """float32 needs a larger diagonal jitter than the reference's float64
    1e-6 (as in the JAX package)."""
    return 5e-4 if floatX() == "float32" else JITTER_DEFAULT


def infer_shape(X, n_points=None):
    """cf. ``gp/util.py:26``."""
    if n_points is None:
        try:
            n_points = int(np.shape(X.test_value if isinstance(X, Node)
                                    else X)[0])
        except (TypeError, IndexError):
            raise TypeError("Cannot infer 'shape', provide as an argument")
    return n_points


def stabilize(K, jitter=None):
    """K + jitter*I (cf. ``gp/util.py:34``)."""
    jitter = _default_jitter() if jitter is None else jitter
    return node_apply(
        lambda K_: K_.to(torch_floatX()) + jitter * torch.eye(
            K_.shape[0], dtype=torch_floatX(), device=K_.device), K)


def cholesky(K):
    """Lower cholesky factor as a node (NaN-free: see MvNormal for the
    checked version the likelihood uses)."""
    return node_apply(lambda K_: torch.linalg.cholesky_ex(
        K_.to(torch_floatX()), check_errors=False)[0], K)


def _solve_triangular(L, b, upper):
    b = b.to(torch_floatX())
    vec = b.ndim == L.ndim - 1
    out = torch.linalg.solve_triangular(L, b[..., None] if vec else b,
                                        upper=upper)
    return out[..., 0] if vec else out


def solve_lower(L, b):
    """x with L x = b, for a lower-triangular L (cf. ``gp/util.py``)."""
    return node_apply(lambda L_, b_: _solve_triangular(L_, b_, False), L, b)


def solve_upper(L, b):
    """x with Lᵀ x = b, for the lower-triangular L (the JAX package's
    ``solve_upper`` takes the lower factor and solves with its
    transpose)."""
    return node_apply(
        lambda L_, b_: _solve_triangular(L_.transpose(-1, -2), b_, True),
        L, b)


def kmeans_inducing_points(num_inducing, X):
    """Inducing-point locations by k-means on the host (scipy), on inputs
    scaled by their standard deviation (cf. ``gp/util.py:39``)."""
    from scipy.cluster.vq import kmeans
    if isinstance(X, Node):
        X = X.test_value
    X = np.asarray(X, dtype=np.float64)
    scaling = np.std(X, 0)
    scaling[scaling == 0] = 1.0
    Xu, _ = kmeans(X / scaling, int(num_inducing))
    return Xu * scaling


def conditioned_vars(varnames):
    """Decorator lending the given/conditioning-variable protocol to GP
    implementations (cf. ``gp/util.py:58``)."""
    def gp_wrapper(cls):
        def make_getter(name):
            def getter(self):
                value = getattr(self, name, None)
                if value is None:
                    raise AttributeError(
                        f"'{name}' not set.  Provide as argument to "
                        "conditional, or call 'prior' first")
                return value
            getter.__doc__ = f"The instance variable {name}"
            return getter

        def make_setter(name):
            def setter(self, val):
                setattr(self, name, val)
            return setter

        for name in varnames:
            setattr(cls, name, property(make_getter("_" + name),
                                        make_setter("_" + name)))
        return cls
    return gp_wrapper
