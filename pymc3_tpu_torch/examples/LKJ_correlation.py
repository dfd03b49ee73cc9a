"""LKJ prior over correlation matrices (cf.
``pymc3_tpu/examples/LKJ_correlation.py``): the mean and the cholesky factor
of the covariance of 200 three-variate normal rows, the factor with an
LKJ(eta=2) prior on its correlations and HalfCauchy(2.5) standard
deviations. The same data, seed and widths as the JAX package's example."""
import numpy as np

import pymc3_tpu_torch as pm

n_obs = 200
n_var = 3
np.random.seed(42)
mu_actual = np.array([1.0, -2.0, 0.5])
chol_actual = np.array([[1.0, 0, 0], [0.5, 1.2, 0], [-0.3, 0.2, 0.8]])
dataset = (mu_actual + np.random.randn(n_obs, n_var) @ chol_actual.T).astype(
    np.float32)


def build_model():
    with pm.Model() as model:
        mu = pm.Normal("mu", mu=0, sigma=10, shape=n_var)
        packed_L = pm.LKJCholeskyCov(
            "packed_L", n=n_var, eta=2.0,
            sd_dist=pm.HalfCauchy.dist(2.5))
        L = pm.Deterministic(
            "L", pm.expand_packed_triangular(n_var, packed_L))
        pm.MvNormal("obs", mu=mu, chol=L, observed=dataset)
    return model


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False,
                          nuts={"target_accept": 0.9})
    print(pm.summary(trace, var_names=["mu"]))
    return trace


if __name__ == "__main__":
    run()
