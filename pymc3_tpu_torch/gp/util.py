"""GP utilities (cf. ``pymc3_tpu/gp/util.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import default_device, floatX, torch_floatX
from ..node import Node, apply as node_apply

__all__ = ["stabilize", "cholesky", "infer_shape", "conditioned_vars",
           "solve_lower", "solve_upper", "kmeans_inducing_points",
           "plot_gp_dist"]

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


#: The percentiles of ``plot_gp_dist``'s ribbons' upper edges.
GP_DIST_PERCENTILES = np.linspace(51, 99, 40)


def _gp_dist_data(samples, device=None):
    """The ribbons ``plot_gp_dist`` fills, widest first: ``(upper,
    lower)``, each ``(40, points)`` float64, the percentiles ``p`` and ``100
    - p`` of ``samples: (draws, points)`` over the draws at each point, by
    ``np.percentile``'s linear rule, from one sort on ``device`` (the
    configured device if None)."""
    device = default_device() if device is None else torch.device(device)
    s = torch.sort(torch.as_tensor(samples).to(device), dim=0).values
    n = s.shape[0]
    percs = GP_DIST_PERCENTILES[::-1]
    q = np.concatenate([np.true_divide(percs, 100),
                        np.true_divide(100 - percs, 100)])
    virtual = (n - 1) * q
    below = np.floor(virtual).astype(np.int64)
    above = np.minimum(below + 1, n - 1)
    gamma = torch.as_tensor(virtual - below, device=device)[:, None]
    a, b = s[below], s[above]
    # numpy's _lerp: the difference in the samples' dtype, then float64
    diff = (b - a).to(torch.float64)
    a, b = a.to(torch.float64), b.to(torch.float64)
    out = torch.where(gamma >= 0.5, b - diff * (1 - gamma), a + diff * gamma)
    out = out.cpu().numpy()
    return out[:len(percs)], out[len(percs):]


def plot_gp_dist(ax, samples, x, plot_samples=True, palette="Reds",
                 fill_alpha=0.8, samples_alpha=0.1, fill_kwargs=None,
                 samples_kwargs=None):
    """Plot percentile ribbons of GP samples (cf. ``gp/util.py:103``).
    ``samples: (draws, points)``, numpy or a tensor. The ribbons are
    computed on the configured device; the 30 draws drawn as lines are
    picked by numpy's global generator, as in the JAX package."""
    import matplotlib.pyplot as plt
    if fill_kwargs is None:
        fill_kwargs = {}
    if samples_kwargs is None:
        samples_kwargs = {}

    cmap = plt.get_cmap(palette)
    percs = GP_DIST_PERCENTILES
    colors = (percs - np.min(percs)) / (np.max(percs) - np.min(percs))
    upper, lower = _gp_dist_data(samples)
    x = np.asarray(x).flatten()
    for i in range(len(percs)):
        ax.fill_between(x, upper[i], lower[i], color=cmap(colors[i]),
                        alpha=fill_alpha, **fill_kwargs)
    if plot_samples:
        samples = (samples.cpu().numpy() if torch.is_tensor(samples)
                   else np.asarray(samples)).T
        idx = np.random.permutation(samples.shape[1])[:30]
        ax.plot(x, samples[:, idx], color=cmap(0.9), lw=1,
                alpha=samples_alpha, **samples_kwargs)
    return ax
