"""Small models shared by the port's parity tests, built with either
package passed as ``pm``.

Importing this module asks the port for the CPU: its models build on the
card by default, and these tests run where there is none. Every
``tests/test_torch_*.py`` imports it.
"""
import numpy as np

import pymc3_tpu_torch

pymc3_tpu_torch.set_config(device="cpu")


def gp_model(pm, n=30, seed=21):
    """scripts/bench_suite.py::gp_model at a smaller n."""
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(0, 4, n))[:, None].astype(np.float32)
    f_true = np.sin(2 * X[:, 0]) + 0.5 * np.cos(5 * X[:, 0])
    y = (f_true + 0.3 * rng.randn(n)).astype(np.float32)
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=2)
        eta = pm.HalfNormal("eta", sigma=2)
        cov = (eta ** 2) * pm.gp.cov.ExpQuad(1, ls)
        gp = pm.gp.Marginal(cov_func=cov)
        sigma = pm.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    return model
