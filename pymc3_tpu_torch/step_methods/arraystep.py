"""Step-method framework (cf. ``pymc3_tpu/step_methods/arraystep.py``).

A stepper owns a slice of the flat unconstrained vector and exposes

    ``kernel_init(q0: (chains, n)) -> state``
    ``kernel_step(state, tctx, noise) -> (q, state, stats)``

over a batch of chains. Only full-model blocked stepping is ported.
"""
from __future__ import annotations

from enum import IntEnum, unique
from typing import Dict, List

import numpy as np

from ..blocking import ArrayOrdering
from ..model import modelcontext

__all__ = ["Competence", "TuneContext", "BlockedStep", "GradientSharedStep"]


@unique
class Competence(IntEnum):
    """Usability of a step method for a variable (cf. ``arraystep.py:28``)."""

    INCOMPATIBLE = 0
    COMPATIBLE = 1
    PREFERRED = 2
    IDEAL = 3


class TuneContext:
    """Per-draw context: ``tune`` (bool), ``step_idx`` (draw counter) and
    ``n_tune``. All host values: the draw loop runs on the host."""

    __slots__ = ("tune", "step_idx", "n_tune")

    def __init__(self, tune, step_idx, n_tune):
        self.tune = bool(tune)
        self.step_idx = int(step_idx)
        self.n_tune = int(n_tune)


class BlockedStep:
    """Base class of the steppers (cf. ``arraystep.py:42``)."""

    generates_stats = False
    stats_dtypes: List[Dict[str, type]] = []
    name = "blocked"

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.INCOMPATIBLE

    def _setup_vars(self, vars, model):
        """Resolve the stepper's variables; they must be the whole flat
        vector of the model."""
        self.model = model
        if vars is None:
            vars = model.cont_vars
        resolved = []
        for v in vars:
            v = model.named_vars.get(getattr(v, "name", v), v)
            tr = getattr(v, "transformed", None)
            resolved.append(tr if tr is not None else v)
        self.vars = resolved
        self.ordering = ArrayOrdering(resolved)
        self.dim = self.ordering.size
        if [vm.var for vm in self.ordering.vmap] != \
                [vm.var for vm in model.ordering.vmap]:
            raise NotImplementedError(
                "only steppers over all free variables, in model order, "
                "are ported")
        self.q_indices = np.arange(self.dim)

    def kernel_init(self, q0):
        raise NotImplementedError

    def kernel_step(self, state, tctx: TuneContext, noise):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}"


class GradientSharedStep(BlockedStep):
    """Stepper owning the batched logp+grad function
    (cf. ``arraystep.py:236``)."""

    def __init__(self, vars, model=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self._logp_dlogp_fn = model.logp_dlogp_function()
