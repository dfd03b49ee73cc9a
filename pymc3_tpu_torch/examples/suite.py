"""Models of the JAX package's bench suite (``scripts/bench_suite.py``) that
need a port-side copy.

BEST needs none: ``scripts/bench_suite.py::best_model(pm)`` runs unchanged
with ``pm = pymc3_tpu_torch``. The mixture builder there writes its ordering
``Potential`` with ``jax.numpy``; :func:`mixture_model` is the same model
with the potential in ``torch.where``.
"""
import numpy as np
import torch


def mixture_data():
    """The bench suite's 1000 rows from 3 components (``RandomState(1234)``)."""
    rng = np.random.RandomState(1234)
    size = 1000
    w_true = np.array([0.35, 0.4, 0.25])
    mu_true = np.array([0.0, 2.0, 5.0])
    sigma = np.array([0.5, 0.5, 1.0])
    component = rng.choice(mu_true.size, size=size, p=w_true)
    x = rng.normal(mu_true[component], sigma[component], size=size)
    return x, w_true, mu_true, sigma


def mixture_model(pm):
    """3-component marginal NormalMixture with ordered means
    (``scripts/bench_suite.py:57-80``); returns the model and the gated
    variable names."""
    x, w_true, mu_true, sigma = mixture_data()
    with pm.Model() as model:
        w = pm.Dirichlet("w", a=np.ones_like(w_true))
        mu = pm.Normal("mu", mu=0.0, sigma=10.0, shape=3,
                       testval=mu_true.copy())
        pm.Potential("enforce_order", pm.node.apply(
            lambda m: torch.where(m[0] <= m[1], 0.0, -torch.inf)
            + torch.where(m[1] <= m[2], 0.0, -torch.inf), mu))
        tau = pm.Gamma("tau", alpha=1.0, beta=1.0, shape=3,
                       testval=1.0 / sigma ** 2)
        pm.NormalMixture("x_obs", w=w, mu=mu, tau=tau, observed=x)
    return model, ["mu"]
