"""MAP estimation (cf. ``pymc3_tpu/tuning/starting.py``).

``find_MAP`` maximizes the logp without jacobians with scipy's
``minimize`` on the host. Each evaluation is one logp (and gradient) of the
port on the model's device and one copy of the value back: one wait for
the device per evaluation, by design.
"""
from __future__ import annotations

import logging

import numpy as np
import torch
from scipy.optimize import minimize

from ..config import torch_floatX
from ..model import all_continuous, modelcontext
from ..node import _ev
from ..util import update_start_vals

_log = logging.getLogger("pymc3_tpu_torch")

__all__ = ["find_MAP", "allinmodel"]


def find_MAP(start=None, vars=None, method="L-BFGS-B", return_raw=False,
             include_transformed=True, progressbar=True, maxeval=5000,
             model=None, *args, **kwargs):
    """The local maximum a posteriori point of the model
    (cf. ``starting.py:28``). With a discrete variable in the model the
    search is gradient-free (Powell), as in the JAX package."""
    model = modelcontext(model)
    if start is None:
        start = model.test_point
    else:
        start_ = dict(model.test_point)
        update_start_vals(start_, start, model)
        names = model.ordering.by_name
        start_.update({k: v for k, v in start.items() if k in names})
        start = start_
    if vars is None:
        vars = model.cont_vars
    if not vars:
        raise ValueError("Model has no unobserved continuous variables.")
    allinmodel(vars, model)
    if set(model.free_RVs) - set(vars) or not all_continuous(vars):
        _log.warning("Warning: gradient not available. (E.g. vars contains "
                     "discrete variables). MAP estimates may not be accurate "
                     "for the default parameters. Defaulting to "
                     "non-gradient minimization 'Powell'.")
        method = "Powell"

    q0 = model.dict_to_array({k: start.get(k, model.test_point[k])
                              for k in model.ordering.by_name}
                             ).astype(np.float64)
    logp = model.logp_point_fn(jacobian=False)
    device = model.device

    def as_q(x):
        return torch.as_tensor(x, dtype=torch_floatX(), device=device)

    def neg_logp_grad(x):
        with torch.enable_grad():
            q = as_q(x).requires_grad_()
            v = logp(q)
            g, = torch.autograd.grad(v, q)
        v = float(v.detach())
        g = g.detach().cpu().numpy().astype(np.float64)
        if not np.isfinite(v):
            return np.inf, -np.where(np.isfinite(g), g, 0.0)
        return -v, -g

    def neg_logp(x):
        with torch.no_grad():
            v = float(logp(as_q(x)))
        return np.inf if not np.isfinite(v) else -v

    opt_result = None
    try:
        if method in ("Powell", "Nelder-Mead", "COBYLA"):
            opt_result = minimize(neg_logp, q0, method=method,
                                  options={"maxiter": maxeval}, *args,
                                  **kwargs)
        else:
            opt_result = minimize(neg_logp_grad, q0, jac=True,
                                  method=method,
                                  options={"maxiter": maxeval}, *args,
                                  **kwargs)
        mx0 = opt_result["x"]
    except (KeyboardInterrupt, StopIteration) as e:
        mx0 = q0
        if isinstance(e, StopIteration):
            _log.info(e)

    vars_dict = model.array_to_dict(mx0)
    mx = dict(vars_dict)
    env = model._point_to_env(vars_dict)
    memo = {}
    for rv in model.free_RVs:
        if rv.transform is not None:
            mx[rv.orig_name] = env[rv.orig_name].detach().cpu().numpy()
    for det in model.deterministics:
        mx[det.name] = _ev(det, env, memo).detach().cpu().numpy()
    if not include_transformed:
        mx = {k: v for k, v in mx.items() if not k.endswith("__")}
    if return_raw:
        return mx, opt_result
    return mx


def allinmodel(vars, model):
    """Raise unless every variable of ``vars`` is a free variable of
    ``model`` (cf. ``starting.py:120``)."""
    notin = [v for v in vars if v not in model.free_RVs]
    if notin:
        raise ValueError(f"Some variables not in the model: {notin}")
