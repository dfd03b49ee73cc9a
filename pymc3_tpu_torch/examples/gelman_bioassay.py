"""Gelman bioassay dose-response model (cf.
``pymc3_tpu/examples/gelman_bioassay.py``): logit-linear death probability
with a Deterministic tracking the per-dose rates."""
import numpy as np

import pymc3_tpu_torch as pm

# samples per dose level / log-dose / observed deaths
n = 5 * np.ones(4, dtype=np.int32)
dose = np.array([-0.86, -0.3, -0.05, 0.73])
deaths = np.array([0, 1, 3, 5], dtype=np.int32)


def build_model():
    with pm.Model() as model:
        alpha = pm.Normal("alpha", 0.0, sigma=100.0)
        beta = pm.Normal("beta", 0.0, sigma=1.0)
        theta = pm.Deterministic(
            "theta", pm.math.invlogit(alpha + beta * dose))
        pm.Binomial("deaths", n=n, p=theta, observed=deaths)
    return model


def run(n_draws=1000):
    if n_draws == "short":
        n_draws = 50
    model = build_model()
    with model:
        trace = pm.sample(draws=n_draws, tune=1000, chains=2,
                          progressbar=False)
    print(pm.summary(trace, var_names=["alpha", "beta"]))
    return trace


if __name__ == "__main__":
    run()
