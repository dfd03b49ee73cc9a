"""Sampler comparison on a correlated MvNormal target
(cf. ``pymc3_tpu/examples/samplers_mvnormal.py``)."""
import time

import numpy as np

import pymc3_tpu_torch as pm


def build_model(d=4):
    np.random.seed(0)
    A = np.random.randn(d, d)
    cov = (A @ A.T + d * np.eye(d)).astype(np.float32)
    with pm.Model() as model:
        pm.MvNormal("x", mu=np.zeros(d, dtype=np.float32), cov=cov, shape=d)
    return model, cov


STEPPERS = {
    "nuts": lambda m: pm.NUTS(model=m),
    "hmc": lambda m: pm.HamiltonianMC(model=m),
    "metropolis": lambda m: pm.Metropolis(model=m, vars=m.free_RVs,
                                          blocked=True),
    "slice": lambda m: pm.Slice(model=m, vars=m.free_RVs, blocked=True),
    "demcmc-z": lambda m: pm.DEMetropolisZ(model=m),
}


def run(draws=2000):
    results = {}
    for name, make_step in STEPPERS.items():
        model, cov = build_model()
        with model:
            t0 = time.time()
            trace = pm.sample(draws=draws, tune=1000, chains=4,
                              step=make_step(model), progressbar=False,
                              compute_convergence_checks=False)
            wall = time.time() - t0
        ess = pm.ess(trace, var_names=["x"])["x"]
        results[name] = {"ess/s": float(np.min(ess) / wall),
                         "wall_s": wall}
        print(name, results[name])
    return results


if __name__ == "__main__":
    run()
