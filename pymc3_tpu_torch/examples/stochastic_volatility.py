"""Stochastic volatility (cf. ``pymc3_tpu/examples/stochastic_volatility.py``):
a Gaussian random walk of 400 latent log-volatilities under StudentT
returns. The same synthetic returns, seed and widths as the JAX package's
example."""
import numpy as np

import pymc3_tpu_torch as pm


def returns_data(n_obs=400):
    """Synthetic returns with time-varying volatility (``default_rng(42)``)."""
    rng = np.random.default_rng(42)
    s = np.cumsum(rng.normal(0, 0.1, n_obs))
    return (rng.normal(0, 1, n_obs) * np.exp(s / 2) * 0.01).astype(np.float32)


def build_model(n_obs=400):
    returns = returns_data(n_obs)
    with pm.Model() as model:
        step_size = pm.Exponential("sigma", 50.0)
        s = pm.GaussianRandomWalk("s", sigma=step_size, shape=n_obs)
        nu = pm.Exponential("nu", 0.1)
        pm.StudentT("r", nu=nu, sigma=pm.math.exp(s / 2) * 0.01,
                    observed=returns)
    return model


def run(n=500):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=500, chains=2, progressbar=False,
                          nuts={"target_accept": 0.9})
    print(pm.summary(trace, var_names=["sigma", "nu"]))
    return trace


if __name__ == "__main__":
    run()
