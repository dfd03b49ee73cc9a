"""Plain PyTorch reference of the radon hierarchical regression.

The model (``bench.py:build_model``; PyMC3's ``glm_hierarchical``
benchmark), non-centred county effects, in its unconstrained coordinates
(the three scales on the log scale, Jacobian included)::

    mu_a, mu_b ~ Normal(0, 100**2)
    sigma_a, sigma_b, eps ~ HalfCauchy(5)
    a_raw, b_raw ~ Normal(0, 1), 85 counties each
    y_i ~ Normal(mu_a + sigma_a a_raw[c_i] + (mu_b + sigma_b b_raw[c_i]) f_i, eps)

Every function works in the dtype of its inputs: float64 for the
reference, bfloat16 for the control. Nothing here imports the program;
the data are the frozen rows in ``portbench/data/radon.csv``.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

DATA = Path(__file__).resolve().parents[1] / "data" / "radon.csv"
PRIOR_SD = 100.0 ** 2
CAUCHY_BETA = 5.0
FREE = ("mu_a", "sigma_a_log__", "mu_b", "sigma_b_log__", "a", "b",
        "eps_log__")
SCALES = (("sigma_a", "sigma_a_log__"), ("sigma_b", "sigma_b_log__"),
          ("eps", "eps_log__"))
_LOG_2PI = math.log(2.0 * math.pi)


def load_data():
    """``county (919,) int64``, ``floor (919,)``, ``log_radon (919,)``
    (float32 values, as the benchmark of record casts them) as numpy."""
    raw = np.loadtxt(DATA, delimiter=",", skiprows=1)
    return (raw[:, 0].astype(np.int64), raw[:, 1],
            raw[:, 2].astype(np.float32).astype(np.float64))


class Data:
    """The rows as tensors of one dtype on one device, and the per-county
    sufficient statistics the conditional posterior needs."""

    def __init__(self, dtype=torch.float64, device="cpu", rows=None):
        county, floor, y = rows if rows is not None else load_data()
        self.n_counties = int(county.max()) + 1
        self.county = torch.as_tensor(county, device=device)
        self.floor = torch.as_tensor(floor, dtype=dtype, device=device)
        self.y = torch.as_tensor(y, dtype=dtype, device=device)
        k = self.n_counties

        def per_county(v):
            return torch.zeros(k, dtype=dtype, device=device).index_add_(
                0, self.county, v)
        one = torch.ones_like(self.y)
        self.n = per_county(one)
        self.F = per_county(self.floor)
        self.F2 = per_county(self.floor * self.floor)
        self.Y = per_county(self.y)
        self.YF = per_county(self.y * self.floor)


def _halfcauchy_log(u):
    """log HalfCauchy(5) density of exp(u), plus the Jacobian u."""
    s = torch.exp(u)
    return (math.log(2.0 / (math.pi * CAUCHY_BETA))
            - torch.log1p((s / CAUCHY_BETA) ** 2) + u)


def _normal(x, sd):
    return -0.5 * (x / sd) ** 2 - math.log(sd) - 0.5 * _LOG_2PI


def _residual(p, data):
    """(y - mean) for every row, ``(B, 919)``, and the county effects."""
    sa, sb = torch.exp(p["sigma_a_log__"]), torch.exp(p["sigma_b_log__"])
    a = p["mu_a"][:, None] + sa[:, None] * p["a"]
    b = p["mu_b"][:, None] + sb[:, None] * p["b"]
    mean = a[:, data.county] + b[:, data.county] * data.floor
    return data.y - mean


def logp(p, data):
    """Log density ``(B,)`` at the points ``p``, a dict of ``(B,)`` and
    ``(B, 85)`` tensors in the unconstrained coordinates."""
    eps = torch.exp(p["eps_log__"])
    r = _residual(p, data)
    like = (-0.5 * (r / eps[:, None]) ** 2).sum(1) \
        - r.shape[1] * (p["eps_log__"] + 0.5 * _LOG_2PI)
    prior = (_normal(p["mu_a"], PRIOR_SD) + _normal(p["mu_b"], PRIOR_SD)
             + _normal(p["a"], 1.0).sum(1) + _normal(p["b"], 1.0).sum(1)
             + _halfcauchy_log(p["sigma_a_log__"])
             + _halfcauchy_log(p["sigma_b_log__"])
             + _halfcauchy_log(p["eps_log__"]))
    return like + prior


def grad(p, data):
    """The gradient of :func:`logp` in closed form, a dict of the shapes
    of ``p``."""
    sa, sb = torch.exp(p["sigma_a_log__"]), torch.exp(p["sigma_b_log__"])
    eps = torch.exp(p["eps_log__"])
    r = _residual(p, data)
    w = r / (eps * eps)[:, None]                      # d like / d mean
    k = data.n_counties
    zeros = torch.zeros((r.shape[0], k), dtype=r.dtype, device=r.device)
    sum_w = zeros.index_add(1, data.county, w)
    sum_wf = zeros.index_add(1, data.county, w * data.floor)

    def cauchy(s):
        return 1.0 - 2.0 * s * s / (CAUCHY_BETA ** 2 + s * s)
    return {
        "mu_a": sum_w.sum(1) - p["mu_a"] / PRIOR_SD ** 2,
        "mu_b": sum_wf.sum(1) - p["mu_b"] / PRIOR_SD ** 2,
        "a": sa[:, None] * sum_w - p["a"],
        "b": sb[:, None] * sum_wf - p["b"],
        "sigma_a_log__": sa * (sum_w * p["a"]).sum(1) + cauchy(sa),
        "sigma_b_log__": sb * (sum_wf * p["b"]).sum(1) + cauchy(sb),
        "eps_log__": (-1.0 + (r / eps[:, None]) ** 2).sum(1) + cauchy(eps),
    }


def conditional(p, data):
    """The posterior of each county's ``(a_raw, b_raw)`` given the
    hyperparameters of ``p``: a two-dimensional normal with mean
    ``(m_a, m_b)``, each ``(B, 85)``, and covariance entries ``(caa, cab,
    cbb)``. With ``z = y - mu_a - mu_b f`` and rows ``x = (sigma_a,
    sigma_b f)``, the precision is ``I + X'X / eps^2`` and the mean its
    inverse times ``X'z / eps^2``."""
    sa = torch.exp(p["sigma_a_log__"])[:, None]
    sb = torch.exp(p["sigma_b_log__"])[:, None]
    inv_e2 = torch.exp(-2.0 * p["eps_log__"])[:, None]
    mu_a, mu_b = p["mu_a"][:, None], p["mu_b"][:, None]
    sz = data.Y - data.n * mu_a - data.F * mu_b
    szf = data.YF - data.F * mu_a - data.F2 * mu_b
    paa = 1.0 + sa * sa * data.n * inv_e2
    pab = sa * sb * data.F * inv_e2
    pbb = 1.0 + sb * sb * data.F2 * inv_e2
    det = paa * pbb - pab * pab
    caa, cab, cbb = pbb / det, -pab / det, paa / det
    ra, rb = sa * sz * inv_e2, sb * szf * inv_e2
    return caa * ra + cab * rb, cab * ra + cbb * rb, (caa, cab, cbb)


def conditional_z(p, data):
    """Each county coordinate of ``p`` standardised by its conditional
    posterior: ``(z_a, z_b)``, each ``(B, 85)``, standard normal where
    the draws follow the posterior."""
    m_a, m_b, (caa, _, cbb) = conditional(p, data)
    return (p["a"] - m_a) / torch.sqrt(caa), (p["b"] - m_b) / torch.sqrt(cbb)


def conditional_draw(p, data, gen):
    """Draws of every county's ``(a_raw, b_raw)`` from the conditional
    posterior given ``p``'s hyperparameters, computed in ``p``'s dtype:
    the control puts these in the program's place."""
    m_a, m_b, (caa, cab, cbb) = conditional(p, data)
    e1 = torch.randn(m_a.shape, generator=gen, dtype=torch.float32,
                     device=m_a.device).to(m_a.dtype)
    e2 = torch.randn(m_a.shape, generator=gen, dtype=torch.float32,
                     device=m_a.device).to(m_a.dtype)
    l11 = torch.sqrt(caa)
    l21 = cab / l11
    l22 = torch.sqrt(cbb - l21 * l21)
    return m_a + l11 * e1, m_b + l21 * e1 + l22 * e2
