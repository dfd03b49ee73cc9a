"""Custom densities through ``DensityDist`` (cf.
``pymc3_tpu/examples/custom_dists.py``): Jake Vanderplas's linear-regression
comparison, with Jeffreys priors written as raw log-density functions."""
import numpy as np
import torch

import pymc3_tpu_torch as pm

np.random.seed(42)
theta_true = (25, 0.5)
xdata = 100 * np.random.random(20)
ydata = theta_true[0] + theta_true[1] * xdata
# add scatter to points
xdata = np.random.normal(xdata, 10)
ydata = np.random.normal(ydata, 10)


def loglike_slope(value):
    # p(m) ∝ (1 + m²)^(-3/2): uniform over angles
    return -1.5 * torch.log(1 + value ** 2)


def loglike_sigma(value):
    # Jeffreys scale prior p(σ) ∝ 1/σ
    return -torch.log(torch.abs(value))


def build_model():
    with pm.Model() as model:
        alpha = pm.Normal("intercept", mu=0, sigma=100)
        beta = pm.DensityDist("slope", loglike_slope, testval=0)
        sigma = pm.DensityDist("sigma", loglike_sigma, testval=1)
        pm.Normal("y_est", mu=alpha + beta * xdata, sigma=sigma,
                  observed=ydata)
    return model


def run(n=2000):
    if n == "short":
        n = 50
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False)
    print(pm.summary(trace, var_names=["intercept", "slope"]))
    return trace


if __name__ == "__main__":
    run()
