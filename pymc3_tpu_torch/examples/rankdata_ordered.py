"""Thurstonian ranking model through the ordered transform (cf.
``pymc3_tpu/examples/rankdata_ordered.py``): latent utilities constrained to
respect each rater's observed ordering."""
import numpy as np
import torch

import pymc3_tpu_torch as pm
from pymc3_tpu_torch.node import apply as node_apply, as_node

np.random.seed(1)

K = 5    # number of items being ranked
J = 100  # number of raters
yreal = np.argsort(np.random.randn(1, K), axis=-1)
y = np.argsort(yreal + np.random.randn(J, K), axis=-1)
y_argsort = np.argsort(y, axis=-1)


def build_model():
    with pm.Model() as model:
        mu_hat = pm.Normal("mu_hat", 0, 1, shape=K - 1)
        # pin the first item's mean at 0 for identifiability
        mu = node_apply(lambda m: torch.cat([m.new_zeros(1), m]), mu_hat)
        mu_obs = node_apply(lambda m, i: m[i], mu, as_node(y_argsort))
        pm.Normal("latent", mu=mu_obs, sigma=1.0,
                  transform=pm.distributions.transforms.ordered,
                  shape=y_argsort.shape,
                  testval=np.repeat(np.arange(K, dtype="float64")[None, :],
                                    J, axis=0))
    return model


def run(n=1500):
    if n == "short":
        n = 50
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False)
    latentmu = np.hstack(
        [[0], np.asarray(trace["mu_hat"]).reshape(-1, K - 1).mean(0)])
    print("true ranking: ", yreal.flatten())
    print("latent means: ", np.round(latentmu, 2))
    print("estimated ranking: ", np.argsort(latentmu))
    return trace


if __name__ == "__main__":
    run()
