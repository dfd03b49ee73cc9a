"""The radon hierarchical model, centred (cf.
``pymc3_tpu/examples/glm_hierarchical.py``), with the data read by
``radon.py``'s csv reader instead of pandas."""
import numpy as np

import pymc3_tpu_torch as pm
from pymc3_tpu_torch.examples.radon import load_radon


def build_model():
    floor, county_idx, n_counties, log_radon = load_radon()
    with pm.Model() as model:
        mu_a = pm.Normal("mu_a", mu=0.0, sigma=100.0 ** 2)
        sigma_a = pm.HalfCauchy("sigma_a", 5)
        mu_b = pm.Normal("mu_b", mu=0.0, sigma=100.0 ** 2)
        sigma_b = pm.HalfCauchy("sigma_b", 5)
        a = pm.Normal("a", mu=mu_a, sigma=sigma_a, shape=n_counties)
        b = pm.Normal("b", mu=mu_b, sigma=sigma_b, shape=n_counties)
        eps = pm.HalfCauchy("eps", 5)
        radon_est = a[county_idx] + b[county_idx] * floor
        pm.Normal("radon_like", mu=radon_est, sigma=eps,
                  observed=log_radon.astype(np.float32))
    return model


def run(n=2000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=500, chains=4, progressbar=False)
    print(pm.summary(trace, var_names=["mu_a", "mu_b", "eps"]))
    return trace


if __name__ == "__main__":
    run()
