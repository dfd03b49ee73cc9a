"""A density given as a function (cf.
``pymc3_tpu/examples/arbitrary_stochastic.py``): ``DensityDist`` with
log-density ``-(|x| + x²/2)``."""
import torch

import pymc3_tpu_torch as pm


def build_model():
    with pm.Model() as model:
        def logp(value):
            return -(torch.abs(value) + value ** 2 / 2)
        pm.DensityDist("custom", logp, testval=0.0)
    return model


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=500, chains=2, progressbar=False)
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
