"""ARMA(1,1) (cf. ``pymc3_tpu/examples/arma_example.py``), its innovations
as one lower-triangular Toeplitz product instead of a scan.

The innovations ``err_t = y_t - (mu + phi y_{t-1} + theta err_{t-1})``,
with ``err_0 = y_0 - (mu + phi mu)``, are the linear recurrence
``err_t = c_t - theta err_{t-1}`` over ``c_t = y_t - mu - phi y_{t-1}``
(``y_{-1} = mu``), so ``err = P c`` with ``P[t, k] = (-theta)^(t - k)`` for
``k <= t``: one product of O(n²) per point where a loop would cost n steps
of a few launches each under ``vmap``."""
import numpy as np
import torch

import pymc3_tpu_torch as pm
from pymc3_tpu_torch.node import apply as node_apply, as_node

np.random.seed(0)
n = 100
y_data = np.cumsum(np.random.normal(0, 1, n)).astype(np.float32) * 0.1


def _toeplitz_exponents(n):
    """``(t - k)`` on and below the diagonal, 0 above, and the mask of the
    lower triangle, as float32 (n, n) arrays."""
    t = np.arange(n)[:, None]
    k = np.arange(n)[None, :]
    lower = k <= t
    return (np.where(lower, t - k, 0).astype(np.float32),
            lower.astype(np.float32))


def err_seq(mu_, phi_, theta_, y_, exponents, lower):
    """The innovations of ``y_`` as ``P c`` (module docstring)."""
    y_lag = torch.cat([mu_.reshape(1).to(y_.dtype), y_[:-1]])
    c = y_ - mu_ - phi_ * y_lag
    powers = lower * torch.pow(-theta_, exponents)
    return powers @ c


def build_model(y=y_data):
    exponents, lower = _toeplitz_exponents(len(y))
    with pm.Model() as arma_model:
        sigma = pm.HalfNormal("sigma", 5.0)
        theta = pm.Normal("theta", 0.0, 1.0)
        phi = pm.Normal("phi", 0.0, 2.0)
        mu = pm.Normal("mu", 0.0, 10.0)
        err = node_apply(err_seq, mu, phi, theta, as_node(y),
                         as_node(exponents), as_node(lower))
        pm.Potential("like", pm.Normal.dist(0.0, sigma=sigma).logp_sum(err))
    return arma_model


def run(n_draws=500):
    model = build_model()
    with model:
        trace = pm.sample(draws=n_draws, tune=1000, chains=2,
                          progressbar=False, nuts={"target_accept": 0.9})
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
