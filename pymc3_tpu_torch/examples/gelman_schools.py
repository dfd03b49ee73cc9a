"""Eight-schools hierarchical model (cf.
``pymc3_tpu/examples/gelman_schools.py``), non-centred."""
import numpy as np

import pymc3_tpu_torch as pm

J = 8
y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])


def build_model():
    """Non-centered parameterization."""
    with pm.Model() as schools:
        eta = pm.Normal("eta", 0, 1, shape=J)
        mu = pm.Normal("mu", 0, sigma=1e6)
        tau = pm.HalfCauchy("tau", 25)
        pm.Deterministic("theta", mu + tau * eta)
        pm.Normal("obs", mu=mu + tau * eta, sigma=sigma, observed=y)
    return schools


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=4, progressbar=False)
    print(pm.summary(trace, var_names=["mu", "tau"]))
    return trace


if __name__ == "__main__":
    run()
