"""Turn the JAX package's state, as numpy arrays, into the port's.

The parity tests use these so that both packages compute from the same
numbers: a point dict becomes the port's flat ``q``; the JAX sampler state
(``DAState``, ``DiagAdaptState``, ``NutsKernelState``, after
``jax.tree_util.tree_map(np.asarray, state)``) becomes the port's state
NamedTuples on a given device. Field names are the same in both packages;
each leaf keeps its leading chain dimension.

The gradient-free steppers' states come the same way (``metropolis_state``,
``binary_state``, ``dem_state``, ``demz_state``): proposal scales, lambda,
acceptance counts and the DEMetropolisZ history keep their values; what the
port holds as a host integer (``since_tune``, ``hist_len``: the same for
every chain, since they count draws) is read from the first chain, and the
history moves from the JAX layout ``(chains, capacity, n)`` to the port's
``(capacity, chains, n)``. A flat ``q`` with discrete coordinates goes back
to a point through ``q_to_point``, each variable in the dtype the model's
bijection gives it.

GP prediction carries nothing more: a GP has no parameters beyond the
model's free variables, so a point dict of the JAX model (transformed names,
numpy values) passes to the port's ``Marginal.predict(Xnew, point=...)``
unchanged.
"""
from __future__ import annotations

import numpy as np
import torch

from .step_methods.hmc.nuts import NutsKernelState
from .step_methods.metropolis import (
    BinaryState, DEMState, DEMZState, MetropolisState,
)
from .step_methods.hmc.quadpotential import DiagAdaptState, WelfordState
from .step_methods.step_sizes import DAState

__all__ = ["point_to_q", "q_to_point", "da_state", "welford_state",
           "diag_adapt_state", "nuts_kernel_state", "metropolis_state",
           "binary_state", "dem_state", "demz_state"]


def _t(x, device):
    return torch.as_tensor(np.array(x), device=device)


def point_to_q(model, point, device=None):
    """A point dict (numpy) -> flat ``q`` through the port's bijection."""
    device = model.device if device is None else device
    return _t(model.dict_to_array(point), device)


def q_to_point(model, q):
    """One flat ``q`` (numpy or tensor) -> a point dict of numpy values."""
    if isinstance(q, torch.Tensor):
        q = q.detach().cpu().numpy()
    return model.array_to_dict(np.asarray(q))


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


def _count(x, device):
    """A per-chain draw counter as the host integer the port keeps."""
    return int(np.asarray(x).ravel()[0])


def metropolis_state(src, device="cpu") -> MetropolisState:
    return _fields(MetropolisState, src, device, {"since_tune": _count})


def binary_state(src, device="cpu") -> BinaryState:
    return _fields(BinaryState, src, device)


def dem_state(src, device="cpu") -> DEMState:
    """The population's state: ``scaling`` and ``accept_sum`` are single
    values in both packages."""
    return _fields(DEMState, src, device, {"since_tune": _count})


def demz_state(src, device="cpu") -> DEMZState:
    return _fields(DEMZState, src, device, {
        "since_tune": _count, "hist_len": _count,
        "history": lambda h, dev: _t(np.swapaxes(np.asarray(h), 0, 1), dev)})
