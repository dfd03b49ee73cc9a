"""Normalizing flows (cf. ``pymc3_tpu/variational/flows.py``).

The formula parser (``'scale-loc'``, ``'planar*4'``) and the flows: planar,
radial, loc, scale and householder. Each is a pure parametric bijection
``forward(params, z) -> (z', logdet)`` batched over the sample axis; its
``init_params`` returns numpy arrays, which the group moves to its device.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from ..config import floatX

__all__ = ["Formula", "AbstractFlow", "PlanarFlow", "RadialFlow", "LocFlow",
           "ScaleFlow", "HouseholderFlow", "flow_for_short_name"]


class AbstractFlow:
    """cf. ``flows.py:23``."""

    short_name = ""

    def __init__(self, dim):
        self.dim = dim

    def init_params(self) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def forward(self, params, z):
        """``(params, z (..., dim)) -> (z', logdet (...,))``."""
        raise NotImplementedError


class PlanarFlow(AbstractFlow):
    """``f(z) = z + u_hat tanh(w.z + b)`` with ``u_hat`` keeping it
    invertible (cf. ``flows.py:39``)."""

    short_name = "planar"

    def init_params(self):
        rng = np.random.default_rng()
        return {"u": (rng.normal(size=self.dim) * 0.01).astype(floatX()),
                "w": (rng.normal(size=self.dim) * 0.01).astype(floatX()),
                "b": np.asarray(0.0, floatX())}

    def forward(self, params, z):
        u, w, b = params["u"], params["w"], params["b"]
        wu = torch.dot(w, u)
        m_wu = -1.0 + F.softplus(wu)
        u_hat = u + (m_wu - wu) * w / (torch.dot(w, w) + 1e-10)
        h = torch.tanh(z @ w + b)
        z_new = z + u_hat * h[..., None]
        psi = (1 - h ** 2)[..., None] * w
        logdet = torch.log(torch.abs(1 + psi @ u_hat) + 1e-10)
        return z_new, logdet


class RadialFlow(AbstractFlow):
    """``f(z) = z + beta h(alpha, r)(z - z0)`` (cf. ``flows.py:67``)."""

    short_name = "radial"

    def init_params(self):
        rng = np.random.default_rng()
        return {"z0": (rng.normal(size=self.dim) * 0.01).astype(floatX()),
                "a_": np.asarray(0.0, floatX()),
                "b_": np.asarray(0.0, floatX())}

    def forward(self, params, z):
        z0, a_, b_ = params["z0"], params["a_"], params["b_"]
        alpha = F.softplus(a_)
        beta = -alpha + F.softplus(b_)
        diff = z - z0
        r = torch.sqrt(torch.sum(diff ** 2, dim=-1) + 1e-10)
        h = 1.0 / (alpha + r)
        z_new = z + (beta * h)[..., None] * diff
        hprime = -1.0 / (alpha + r) ** 2
        logdet = (self.dim - 1) * torch.log(torch.abs(1 + beta * h)
                                            + 1e-10) + \
            torch.log(torch.abs(1 + beta * h + beta * hprime * r) + 1e-10)
        return z_new, logdet


class LocFlow(AbstractFlow):
    """``f(z) = z + loc`` (cf. ``flows.py:96``)."""

    short_name = "loc"

    def init_params(self):
        return {"loc": np.zeros(self.dim, floatX())}

    def forward(self, params, z):
        return z + params["loc"], z.new_zeros(z.shape[:-1])


class ScaleFlow(AbstractFlow):
    """``f(z) = exp(log_scale) z`` (cf. ``flows.py:108``)."""

    short_name = "scale"

    def init_params(self):
        return {"log_scale": np.zeros(self.dim, floatX())}

    def forward(self, params, z):
        ls = params["log_scale"]
        return z * torch.exp(ls), torch.sum(ls).expand(z.shape[:-1])


class HouseholderFlow(AbstractFlow):
    """``f(z) = (I - 2 v v^T / |v|^2) z`` (cf. ``flows.py:122``)."""

    short_name = "hh"

    def init_params(self):
        rng = np.random.default_rng()
        return {"v": rng.normal(size=self.dim).astype(floatX())}

    def forward(self, params, z):
        v = params["v"]
        proj = (z @ v)[..., None] * v
        return z - 2 * proj / (torch.dot(v, v) + 1e-10), \
            z.new_zeros(z.shape[:-1])


_FLOWS = {f.short_name: f for f in
          (PlanarFlow, RadialFlow, LocFlow, ScaleFlow, HouseholderFlow)}


def flow_for_short_name(name):
    return _FLOWS[name]


class Formula:
    """A chain of flows from a formula (cf. ``flows.py:147``):
    ``'planar*4-loc'`` is four planar flows and then a loc flow, applied
    from the base towards the posterior."""

    def __init__(self, formula: str):
        self.formula = formula = formula.lower().replace(" ", "")
        specs = []
        for part in formula.split("-"):
            name, count = part.split("*") if "*" in part else (part, 1)
            if name not in _FLOWS:
                raise ValueError(
                    f"Unknown flow {name!r}; known: {sorted(_FLOWS)}")
            specs.extend([name] * int(count))
        self.specs = specs

    def build(self, dim) -> List[AbstractFlow]:
        return [_FLOWS[name](dim) for name in self.specs]

    def __call__(self, dim):
        return self.build(dim)

    def __repr__(self):
        return f"Formula({self.formula!r})"
