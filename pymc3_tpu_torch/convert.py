"""Turn the JAX package's state, as numpy arrays, into the port's.

The parity tests use these so that both packages compute from the same
numbers: a point dict becomes the port's flat ``q``; the JAX sampler state
(``DAState``, ``DiagAdaptState``, the dense ``WelfordCovState``,
``DenseAdaptState`` and ``DenseState``, ``NutsKernelState``, after
``jax.tree_util.tree_map(np.asarray, state)``) becomes the port's state
NamedTuples on a given device. Field names are the same in both packages;
each leaf keeps its leading chain dimension. A ``NutsKernelState``'s
potential converts by the fields it has (dense adaptive, fixed dense or
diagonal). A fixed dense state of the JAX package holds one matrix (no chain
dimension); the port's holds it as ``(1, n, n)``.

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
from .step_methods.elliptical_slice import ESState
from .step_methods.hmc.quadpotential import (
    DenseAdaptState, DenseState, DiagAdaptState, WelfordCovState,
    WelfordState,
)
from .step_methods.step_sizes import DAState

__all__ = ["point_to_q", "q_to_point", "da_state", "welford_state",
           "diag_adapt_state", "welford_cov_state", "dense_adapt_state",
           "dense_state", "nuts_kernel_state", "metropolis_state",
           "binary_state", "dem_state", "demz_state", "es_state"]


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


def welford_cov_state(src, device="cpu") -> WelfordCovState:
    return _fields(WelfordCovState, src, device)


def dense_adapt_state(src, device="cpu") -> DenseAdaptState:
    return _fields(DenseAdaptState, src, device,
                   {"fg": welford_cov_state, "bg": welford_cov_state})


def dense_state(src, device="cpu") -> DenseState:
    def matrix(x, dev):
        x = np.asarray(x)
        return _t(x[None] if x.ndim == 2 else x, dev)
    return _fields(DenseState, src, device, {"cov": matrix, "chol": matrix})


def _potential_state(src, device="cpu"):
    fields = getattr(type(src), "_fields", ())
    if "window" in fields:
        return dense_adapt_state(src, device)
    if "chol" in fields:
        return dense_state(src, device)
    return diag_adapt_state(src, device)


def nuts_kernel_state(src, device="cpu") -> NutsKernelState:
    return _fields(NutsKernelState, src, device,
                   {"da": da_state, "pot": _potential_state})


def es_state(src, device="cpu") -> ESState:
    return _fields(ESState, src, device)


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
