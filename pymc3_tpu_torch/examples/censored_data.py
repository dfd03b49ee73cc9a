"""Censored data through ``Potential`` terms of the normal's log cdf
(cf. ``pymc3_tpu/examples/censored_data.py``): 500 draws of N(1, 1.5²)
clipped to [-1, 3]; the clipped ones enter as the mass of each tail."""
import numpy as np

import pymc3_tpu_torch as pm
from pymc3_tpu_torch.node import apply as node_apply

np.random.seed(123)
high = 3.0
low = -1.0
samples = np.random.normal(1.0, 1.5, 500).astype(np.float32)
censored = np.clip(samples, low, high)
uncensored = censored[(censored > low) & (censored < high)]
n_left = int((censored <= low).sum())
n_right = int((censored >= high).sum())


def build_model():
    from pymc3_tpu_torch.distributions.dist_math import (normal_lccdf,
                                                         normal_lcdf)

    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        sigma = pm.HalfNormal("sigma", 5.0)
        pm.Normal("obs", mu=mu, sigma=sigma, observed=uncensored)
        # the tail-stable lcdf and lccdf, not log1p(-exp(logcdf)), which
        # is log(0) once the cdf rounds to 1 in float32
        left = node_apply(
            lambda m, s: n_left * normal_lcdf(m, s, np.float32(low)),
            mu, sigma)
        pm.Potential("left_censored", left)
        right = node_apply(
            lambda m, s: n_right * normal_lccdf(m, s, np.float32(high)),
            mu, sigma)
        pm.Potential("right_censored", right)
    return model


def run(n=500):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=500, chains=2, progressbar=False)
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
