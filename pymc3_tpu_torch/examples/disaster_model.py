"""Coal-mining disasters changepoint model (cf.
``pymc3_tpu/examples/disaster_model.py``): a discrete switchpoint sampled by
Metropolis compounds with NUTS on the two rates."""
import numpy as np
import torch

import pymc3_tpu_torch as pm

# fmt: off
disasters_data = np.array(
    [4, 5, 4, 0, 1, 4, 3, 4, 0, 6, 3, 3, 4, 0, 2, 6, 3, 3, 5, 4, 5, 3, 1,
     4, 4, 1, 5, 5, 3, 4, 2, 5, 2, 2, 3, 4, 2, 1, 3, 2, 2, 1, 1, 1, 1, 3,
     0, 0, 1, 0, 1, 1, 0, 0, 3, 1, 0, 3, 2, 2, 0, 1, 1, 1, 0, 1, 0, 1, 0,
     0, 0, 2, 1, 0, 0, 0, 1, 1, 0, 2, 3, 3, 1, 1, 2, 1, 1, 1, 1, 2, 4, 2,
     0, 0, 1, 4, 0, 0, 0, 1, 0, 0, 0, 0, 0, 1, 0, 0, 1, 0, 1], dtype=np.int32)
# fmt: on
years = len(disasters_data)


def build_model():
    with pm.Model() as model:
        switchpoint = pm.DiscreteUniform("switchpoint", lower=0,
                                         upper=years - 1)
        early_mean = pm.Exponential("early_mean", lam=1.0)
        late_mean = pm.Exponential("late_mean", lam=1.0)
        idx = pm.node.as_node(np.arange(years))
        rate = pm.node.apply(
            lambda i, s, e, l: torch.where(i < s, e, l),
            idx, switchpoint, early_mean, late_mean)
        pm.Poisson("disasters", rate, observed=disasters_data)
    return model


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False)
    print(pm.summary(trace, var_names=["early_mean", "late_mean"]))
    return trace


if __name__ == "__main__":
    run()
