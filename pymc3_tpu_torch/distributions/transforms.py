"""Bijective reparameterizations (cf. ``pymc3_tpu/distributions/transforms.py``).

Conventions as in the JAX package: ``forward(x) -> z`` maps the constrained
value to the unconstrained space the samplers see, ``backward(z) -> x``
inverts it, and ``jacobian_det(z)`` is log|d backward / dz|. Only ``Log``
is ported so far.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["Transform", "Log", "log"]


def _host(x):
    return torch.as_tensor(np.asarray(x), device="cpu")


class Transform:
    """Base transform class (cf. ``transforms.py:46``)."""

    name = ""

    def forward(self, x):
        raise NotImplementedError

    def backward(self, z):
        raise NotImplementedError

    def jacobian_det(self, z):
        raise NotImplementedError

    def forward_val(self, x):
        """numpy -> numpy."""
        return self.forward(_host(x)).numpy()

    def backward_val(self, z):
        """numpy -> numpy."""
        return self.backward(_host(z)).numpy()

    def __str__(self):
        return self.name + " transform"


class Log(Transform):
    """Positive support: z = log(x) (cf. ``transforms.py:203``)."""

    name = "log"

    def forward(self, x):
        return torch.log(x)

    def backward(self, z):
        return torch.exp(z)

    def jacobian_det(self, z):
        return z


log = Log()
