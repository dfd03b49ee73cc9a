"""Variational operators (cf. ``pymc3_tpu/variational/operators.py``):
``KL``, whose objective is the negative ELBO, and ``KSD``, the kernelized
Stein discrepancy of SVGD."""
from __future__ import annotations

import torch

from .opvi import (ObjectiveFunction, Operator, _unflatten, mask_nonfinite,
                   tree_leaves, tree_map)
from .updates import adagrad_window, get_optimizer

__all__ = ["KL", "KSD", "KSDObjective"]


class KL(Operator):
    """Per-sample ``beta * logq - logp`` (cf. ``operators.py:17``); the
    model's logp sees the sample's minibatch draw."""

    def __init__(self, approx, beta=1.0):
        super().__init__(approx)
        self.beta = float(beta)

    def apply(self, f):
        logp = self.model.logp_point_fn()

        def per_sample(z, logq, draw):
            return self.beta * logq - logp(z, draw)
        return per_sample


class KSDObjective(ObjectiveFunction):
    """The SVGD update (cf. ``operators.py:33``). Not loss-based: the
    "gradient" is the Stein direction ``phi*``.

    - An empirical approximation (SVGD): the particles are the parameters,
      and the direction moves them.
    - A parametric sampler (ASVGD): the particles are ``obj_n_mc``
      reparameterized draws, and the parameters move along the sampler's
      vector-Jacobian product with the direction as cotangent (Wang & Liu
      2016, arXiv:1611.01722).
    """

    def stein_phi(self, x):
        """``phi*(x) = (K grad logp / T + sum_y dK) / N`` over the particle
        batch ``x`` (no minibatch draw: minibatch views read their leading
        rows, as in the JAX package)."""
        _, glogp = self._logp_grad(x)
        kxy, dxkxy = self.op.tf(x)
        return (kxy @ glogp / self.op.temperature + dxkxy) / x.shape[0]

    def step_function(self, obj_n_mc=100, obj_optimizer=None,
                      more_obj_params=None, total_grad_norm_constraint=None,
                      score=False, fn_kwargs=None):
        opt = get_optimizer(obj_optimizer if obj_optimizer is not None
                            else adagrad_window())
        approx = self.approx
        self._logp_grad = self.op.model.logp_dlogp_function()
        empirical = "particles" in approx.params[0]

        def step(params, opt_state, noise):
            if empirical:
                phi = self.stein_phi(params[0]["particles"])
                grads = {0: {"particles": -phi}}
            else:
                with torch.enable_grad():
                    req = tree_map(lambda p: p.detach().requires_grad_(),
                                   params)
                    x, _ = approx.sample_q(req, obj_n_mc, noise)
                    phi = self.stein_phi(x.detach())
                    leaves = tree_leaves(req)
                    g = torch.autograd.grad(x, leaves, grad_outputs=-phi,
                                            allow_unused=True)
                grads = mask_nonfinite(_unflatten(req, [
                    torch.zeros_like(p) if gi is None else gi
                    for p, gi in zip(leaves, g)]))
            with torch.no_grad():
                params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, phi.new_zeros(())
        return step, opt


class KSD(Operator):
    """Kernelized Stein discrepancy (cf. ``operators.py:97``)."""

    has_test_function = True
    returns_loss = False
    require_logq = False
    objective_class = KSDObjective

    def __init__(self, approx, temperature=1.0):
        super().__init__(approx)
        self.temperature = float(temperature)

    def __call__(self, f=None):
        if f is None:
            from .test_functions import RBF
            f = RBF()
        self.tf = f
        return self.objective_class(self, f)

    def apply(self, f):
        raise NotImplementedError("KSD uses a custom step function")
