"""Shared HMC machinery (cf. ``pymc3_tpu/step_methods/hmc/base_hmc.py``).

The momentum draw, state construction and divergence handling live in the
batched kernel (``nuts.py``); this module keeps the auxiliary types."""
from __future__ import annotations

from collections import namedtuple

from ..arraystep import GradientSharedStep

__all__ = ["BaseHMC", "HMCStepData", "DivergenceInfo"]

HMCStepData = namedtuple("HMCStepData",
                         "end, accept_stat, divergence_info, stats")

DivergenceInfo = namedtuple("DivergenceInfo", "message, exec_info, state")


class BaseHMC(GradientSharedStep):
    """Superclass of NUTS (cf. ``base_hmc.py:36``)."""

    #: The ranks that pooled statistics and the step-size probe reduce over
    #: besides the local chains (a ``parallel.ChainMesh``; ``sample(devices=
    #: ...)`` sets it, ``None`` for this process's chains alone).
    mesh = None
