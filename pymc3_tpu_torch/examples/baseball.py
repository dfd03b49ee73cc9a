"""Efron-Morris baseball batting averages, a hierarchical Beta-Binomial
(cf. ``pymc3_tpu/examples/baseball.py``)."""
import numpy as np

import pymc3_tpu_torch as pm

# at-bats and hits for 18 players (Efron & Morris 1975)
at_bats = np.full(18, 45, dtype=np.int32)
hits = np.array([18, 17, 16, 15, 14, 14, 13, 12, 11, 11, 10, 10, 10, 10,
                 10, 9, 8, 7], dtype=np.int32)


def build_model():
    with pm.Model() as model:
        phi = pm.Uniform("phi", lower=0.0, upper=1.0)
        kappa_log = pm.Exponential("kappa_log", lam=1.5)
        kappa = pm.Deterministic("kappa", pm.math.exp(kappa_log))
        thetas = pm.Beta("thetas", alpha=phi * kappa,
                         beta=(1.0 - phi) * kappa, shape=len(hits))
        pm.Binomial("ys", n=at_bats, p=thetas, observed=hits)
    return model


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False,
                          nuts={"target_accept": 0.9})
    print(pm.summary(trace, var_names=["phi", "kappa"]))
    return trace


if __name__ == "__main__":
    run()
