"""Hessian-based scaling guesses (cf. ``pymc3_tpu/tuning/scaling.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import torch_floatX
from ..model import modelcontext
from ..torchf import flat_derivative

__all__ = ["find_hessian", "find_hessian_diag", "fixed_hessian",
           "guess_scaling", "adjust_scaling", "adjust_precision",
           "trace_cov"]


def fixed_hessian(point, vars=None, model=None):
    """A constant stand-in for the Hessian (cf. ``scaling.py:15``)."""
    model = modelcontext(model)
    return np.ones(model.ordering.size) / 10


def _neg_logp_at(point, model):
    """``-logp`` without jacobians as a function of the flat vector, and
    ``point`` as that vector on the model's device."""
    q = torch.as_tensor(model.dict_to_array(
        {k: point[k] for k in model.ordering.by_name}),
        dtype=torch_floatX(), device=model.device)
    logp = model.logp_point_fn(jacobian=False)
    return (lambda x: -logp(x)), q


def find_hessian(point, vars=None, model=None):
    """The Hessian of ``-logp`` at ``point`` (cf. ``scaling.py:23``), by
    ``torch.func.hessian``, on the host as numpy."""
    model = modelcontext(model)
    fn, q = _neg_logp_at(point, model)
    return flat_derivative(fn, q, "hess").detach().cpu().numpy()


def find_hessian_diag(point, vars=None, model=None):
    """The Hessian's diagonal (cf. ``scaling.py:34``)."""
    model = modelcontext(model)
    fn, q = _neg_logp_at(point, model)
    return flat_derivative(fn, q, "hess_diag").detach().cpu().numpy()


def guess_scaling(point, vars=None, model=None, scaling_bound=1e-8):
    """The Hessian's diagonal, clamped (cf. ``scaling.py:51``); the fixed
    guess where the diagonal cannot be computed."""
    model = modelcontext(model)
    try:
        h = find_hessian_diag(point, vars, model=model)
    except (RuntimeError, NotImplementedError):
        h = fixed_hessian(point, vars, model=model)
    return adjust_scaling(h, scaling_bound)


def adjust_scaling(s, scaling_bound):
    """Clamp a diagonal or full scaling into a sane precision range; a full
    matrix is clamped in its eigenbasis (cf. ``scaling.py:61``)."""
    if np.ndim(s) < 2:
        return adjust_precision(s, scaling_bound)
    val, vec = np.linalg.eigh(s)
    return (vec * adjust_precision(val, scaling_bound)) @ vec.T


def adjust_precision(tau, scaling_bound=1e-8):
    """Precision magnitudes clipped into ``[bound, 1/bound]``
    (cf. ``scaling.py:70``)."""
    mag = np.sqrt(np.abs(tau))
    return np.clip(mag, scaling_bound, 1.0 / scaling_bound) ** 2


def trace_cov(trace, vars=None, model=None):
    """The covariance of a trace's draws (cf. ``scaling.py:78``)."""
    model = modelcontext(model)
    if vars is None:
        vars = model.free_RVs if model is not None else trace.varnames

    def flat_t(var):
        x = trace[getattr(var, "name", var)]
        return x.reshape((x.shape[0], int(np.prod(x.shape[1:], dtype=int))))

    return np.cov(np.concatenate(list(map(flat_t, vars)), 1).T)
