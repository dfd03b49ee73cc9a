"""Kernels for SVGD (cf. ``pymc3_tpu/variational/test_functions.py``)."""
from __future__ import annotations

import math

import torch

from .opvi import TestFunction

__all__ = ["Kernel", "RBF"]


class Kernel(TestFunction):
    """A kernel ``K(x, y)`` returning ``(kxy, dxkxy)``
    (cf. ``test_functions.py:12``)."""


class RBF(Kernel):
    """The RBF kernel with the median heuristic bandwidth
    (cf. ``test_functions.py:17``). The median of an even number of
    squared distances is the mean of the two middle ones, as
    ``jnp.median`` takes it (``torch.median`` would take the lower)."""

    def __call__(self, X):
        XY = X @ X.T
        x2 = torch.sum(X ** 2, dim=1)
        pdist2 = x2[:, None] - 2 * XY + x2[None, :]
        n = X.shape[0]
        med2 = torch.quantile(pdist2.reshape(-1), 0.5)
        h = torch.sqrt(0.5 * med2 / math.log(n + 1.0) + 1e-12)
        kxy = torch.exp(-pdist2 / (h ** 2) / 2.0)
        sumkxy = torch.sum(kxy, dim=1, keepdim=True)
        dxkxy = (X * sumkxy - kxy @ X) / (h ** 2)
        return kxy, dxkxy
