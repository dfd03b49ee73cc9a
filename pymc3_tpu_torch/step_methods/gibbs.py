"""Categorical Gibbs (cf. ``pymc3_tpu/step_methods/gibbs.py``).

``ElemwiseCategorical`` resamples each categorical element from its full
conditional. For one coordinate the joint logp of all ``k`` categories of
every chain is one batched call over ``(chains * k, n)`` points; the
category is drawn by Gumbel-max (the argmax of the log-probabilities plus
``noise.gumbel(k)``), as ``jax.random.categorical`` draws it. A scan visits
the coordinates in order, one logp call each.
"""
from __future__ import annotations

import numpy as np
import torch

from ..model import modelcontext
from .arraystep import ArrayStepShared, Competence, TuneContext

__all__ = ["ElemwiseCategorical"]


class ElemwiseCategorical(ArrayStepShared):
    """Gibbs sampling for categorical variables (cf. ``gibbs.py:26``)."""

    name = "elemwise_categorical"
    generates_stats = False

    def __init__(self, vars, values=None, model=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        if values is None:
            ks = []
            for v in self.vars:
                k = getattr(v.distribution, "k", None)
                try:
                    k = int(np.asarray(k.test_value if hasattr(
                        k, "test_value") else k).item())
                except (TypeError, ValueError):
                    p = getattr(v.distribution, "p", None)
                    k = int(np.shape(p.test_value)[-1])
                ks.append(k)
            self.k = max(ks)
        else:
            self.k = len(values)
        self._logp_fn = model.make_logp_fn()

    def kernel_init(self, q0):
        return ()

    def kernel_step(self, q, state, tctx: TuneContext, noise):
        C, n = q.shape
        k = self.k
        cats = torch.arange(k, dtype=q.dtype, device=q.device)
        for col in self.q_indices.tolist():
            qk = q[:, None, :].repeat(1, k, 1)
            qk[:, :, col] = cats
            logps = self._logp_fn(qk.reshape(C * k, n)).reshape(C, k)
            logps = torch.where(torch.isnan(logps), -torch.inf, logps)
            new = torch.argmax(logps + noise.gumbel(k), dim=1)
            q = q.clone()
            q[:, col] = new.to(q.dtype)
        return q, state, {}

    @staticmethod
    def competence(var, has_grad=False):
        dist = getattr(var, "distribution", None)
        if type(dist).__name__ == "Categorical":
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE
