"""GLM posterior-predictive plot (cf. ``pymc3_tpu/plots/posteriorplot.py``).

The lines to draw are picked on the host from numpy's global generator,
as in the JAX package: ``np.random.seed(s)`` gives the same figure in
both packages."""
from __future__ import annotations

import numpy as np

__all__ = ["plot_posterior_predictive_glm"]


def plot_posterior_predictive_glm(trace, eval=None, lm=None, samples=30,
                                  **kwargs):
    """Plot posterior predictive regression lines
    (cf. ``posteriorplot.py:25``)."""
    import matplotlib.pyplot as plt
    if lm is None:
        lm = lambda x, sample: sample["Intercept"] + sample["x"] * x
    if eval is None:
        eval = np.linspace(0, 1, 100)

    # Set default plotting arguments
    if "lw" not in kwargs and "linewidth" not in kwargs:
        kwargs["lw"] = 0.2
    if "c" not in kwargs and "color" not in kwargs:
        kwargs["c"] = "k"

    total = len(trace) * trace.nchains if hasattr(trace, "nchains") else \
        len(trace)
    for rand_loc in np.random.randint(0, total, samples):
        rand_sample = trace[int(rand_loc % len(trace))]
        plt.plot(eval, lm(eval, rand_sample), **kwargs)
    plt.title("Posterior predictive")
