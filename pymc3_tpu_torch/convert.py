"""Turn the JAX package's state, as numpy arrays, into the port's.

The parity tests use these so that both packages compute from the same
numbers: a point dict becomes the port's flat ``q``; the JAX sampler state
(``DAState``, ``DiagAdaptState``, ``NutsKernelState``, after
``jax.tree_util.tree_map(np.asarray, state)``) becomes the port's state
NamedTuples on a given device. Field names are the same in both packages;
each leaf keeps its leading chain dimension.

GP prediction carries nothing more: a GP has no parameters beyond the
model's free variables, so a point dict of the JAX model (transformed names,
numpy values) passes to the port's ``Marginal.predict(Xnew, point=...)``
unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .step_methods.hmc.nuts import NutsKernelState
from .step_methods.hmc.quadpotential import DiagAdaptState, WelfordState
from .step_methods.step_sizes import DAState

__all__ = ["point_to_q", "da_state", "welford_state", "diag_adapt_state",
           "nuts_kernel_state"]


def _t(x, device):
    return torch.as_tensor(np.array(x), device=device)


def point_to_q(model, point, device=None):
    """A point dict (numpy) -> flat ``q`` through the port's bijection."""
    device = model.device if device is None else device
    return _t(model.dict_to_array(point), device)


def _fields(cls, src, device, convert=None):
    convert = convert or {}
    return cls(*[convert[f](getattr(src, f), device) if f in convert
                 else _t(getattr(src, f), device) for f in cls._fields])


def da_state(src, device="cpu") -> DAState:
    return _fields(DAState, src, device)


def welford_state(src, device="cpu") -> WelfordState:
    return _fields(WelfordState, src, device)


def diag_adapt_state(src, device="cpu") -> DiagAdaptState:
    return _fields(DiagAdaptState, src, device,
                   {"fg": welford_state, "bg": welford_state})


def nuts_kernel_state(src, device="cpu") -> NutsKernelState:
    return _fields(NutsKernelState, src, device,
                   {"da": da_state, "pot": diag_adapt_state})
