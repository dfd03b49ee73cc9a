"""GARCH(1,1) volatility model (cf. ``pymc3_tpu/examples/garch_example.py``):
100 returns, three Uniform priors. The same data and seed as the JAX
package's example."""
import numpy as np

import pymc3_tpu_torch as pm

np.random.seed(1)
n = 100
returns = np.random.normal(0, 1, n).astype(np.float32)


def build_model():
    with pm.Model() as model:
        alpha1 = pm.Uniform("alpha1", 0.0, 1.0)
        beta1 = pm.Uniform("beta1", 0.0, 1.0 - 0.01)
        omega = pm.Uniform("omega", 0.0, 10.0)
        pm.GARCH11("r", omega=omega, alpha_1=alpha1, beta_1=beta1,
                   initial_vol=1.0, shape=n, observed=returns)
    return model


def run(n_draws=500):
    model = build_model()
    with model:
        trace = pm.sample(draws=n_draws, tune=500, chains=2,
                          progressbar=False)
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
