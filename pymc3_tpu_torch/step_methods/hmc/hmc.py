"""Static Hamiltonian Monte Carlo (cf. ``pymc3_tpu/step_methods/hmc/hmc.py``).

One trajectory of ``path_length / step_size`` leapfrog steps per chain, then
a Metropolis accept. The chains' step sizes differ while they adapt, so
their step counts do too: the loop runs to the largest count over the batch
(one host sync per draw) and a mask freezes the chains that are done. Full
or over a subset of the flat vector, as NUTS.
"""
from __future__ import annotations

import numpy as np
import torch

from ...config import floatX
from ...model import modelcontext
from ...vartypes import continuous_types
from ..arraystep import Competence, TuneContext
from ..step_sizes import da_init, da_update, da_current
from .base_hmc import BaseHMC
from .integration import IntegrationState, leapfrog
from .nuts import NutsKernelState, _dot, _select, _where
from .quadpotential import (
    QuadPotentialDiagAdapt, kernel_mass, kernel_momentum, kernel_update,
    mass_velocity, quad_potential,
)

__all__ = ["HamiltonianMC"]


class HamiltonianMC(BaseHMC):
    """Static-trajectory HMC (cf. ``hmc.py:31``)."""

    name = "hmc"
    default_blocked = True
    generates_stats = True
    stats_dtypes = [{
        "step_size": np.float64,
        "n_steps": np.int64,
        "tune": bool,
        "step_size_bar": np.float64,
        "accept": np.float64,
        "diverging": bool,
        "energy_error": np.float64,
        "energy": np.float64,
        "path_length": np.float64,
        "accepted": bool,
        "model_logp": np.float64,
    }]

    def __init__(self, vars=None, path_length=2.0, max_steps=1024,
                 target_accept=0.65, step_scale=0.25, Emax=1000,
                 adapt_step_size=True, potential=None, model=None,
                 scaling=None, is_cov=False,
                 gamma=0.05, k=0.75, t0=10, axis_name=None, **kwargs):
        model = modelcontext(model)
        kwargs.pop("blocked", None)
        super().__init__(vars, model=model, blocked=True, **kwargs)
        self.path_length = float(path_length)
        self.max_steps = int(max_steps)
        self.target_accept = float(target_accept)
        self.Emax = float(Emax)
        self.adapt_step_size = bool(adapt_step_size)
        self.gamma, self.k, self.t0 = gamma, k, t0
        self.tune = True
        self.axis_name = axis_name
        self.step_size = float(step_scale) / (self.dim ** 0.25)
        if scaling is not None:
            potential = quad_potential(scaling, is_cov)
        if potential is None:
            mean = np.concatenate([np.ravel(v.test_value) for v in self.vars])
            potential = QuadPotentialDiagAdapt(self.dim, floatX(mean))
        self.potential = potential

    def kernel_init(self, q0) -> NutsKernelState:
        x0 = self._sub(q0)
        logp, grad = self._value_and_grad_at(q0)(x0)
        C = q0.shape[0]
        da = da_init(torch.full((C,), self.step_size, dtype=q0.dtype,
                                device=q0.device))
        return NutsKernelState(
            q=x0, logp=logp, grad=grad, da=da,
            pot=self.potential.init_kernel_state(C, q0.device),
            rescue_cnt=torch.zeros(C, dtype=torch.int32, device=q0.device),
            eps_scale=torch.ones_like(logp))

    def kernel_step(self, q, state: NutsKernelState, tctx: TuneContext,
                    noise):
        tune = tctx.tune
        eps = da_current(state.da, tune)
        var = kernel_mass(state.pot)
        p0 = kernel_momentum(state.pot, noise.normal(self.dim))
        lp_fn = self._value_and_grad_at(q)
        x0 = self._sub(q)
        if self.is_partial:
            # other steppers moved the rest of q since our last call
            logp0, grad0 = lp_fn(x0)
        else:
            logp0, grad0 = state.logp, state.grad
        v0 = mass_velocity(var, p0)
        h0 = 0.5 * _dot(p0, v0) - logp0
        end = IntegrationState(q=x0, p=p0, v=v0, q_grad=grad0, energy=h0,
                               model_logp=logp0)

        # leapfrog steps of this trajectory, per chain
        n_steps = torch.clamp(self.path_length / eps, 1,
                              self.max_steps).to(torch.int32)
        for i in range(int(n_steps.max())):
            end = _select(n_steps > i, leapfrog(lp_fn, var, eps, end), end)

        energy_error = end.energy - h0
        energy_error = torch.where(torch.isnan(energy_error), torch.inf,
                                   energy_error)
        accept_stat = torch.exp(torch.clamp(-energy_error, max=0.0))
        accepted = torch.log(noise.uniform()) < -energy_error

        x_new = _where(accepted, end.q, x0)
        logp_new = torch.where(accepted, end.model_logp, logp0)
        grad_new = _where(accepted, end.q_grad, grad0)

        da_new = da_update(state.da, accept_stat,
                           tune and self.adapt_step_size,
                           target=self.target_accept, gamma=self.gamma,
                           k=self.k, t0=self.t0)
        pot_new = kernel_update(self.potential, state.pot, x_new, tune,
                                self.axis_name is not None, self.mesh)

        new_state = NutsKernelState(q=x_new, logp=logp_new, grad=grad_new,
                                    da=da_new, pot=pot_new,
                                    rescue_cnt=state.rescue_cnt,
                                    eps_scale=state.eps_scale)
        stats = {
            "step_size": eps,
            "n_steps": n_steps,
            "tune": torch.full_like(accepted, tune),
            "step_size_bar": torch.exp(da_new.log_bar_step),
            "accept": accept_stat,
            "diverging": (energy_error > self.Emax) & (not tune),
            "energy_error": energy_error,
            "energy": end.energy,
            "path_length": torch.full_like(eps, self.path_length),
            "accepted": accepted,
            "model_logp": logp_new,
        }
        return self._scatter(q, x_new), new_state, stats

    @staticmethod
    def competence(var, has_grad=False):
        dist = getattr(var, "distribution", None)
        dtype = getattr(dist, "dtype", None) or getattr(var, "dtype", None)
        if str(np.dtype(dtype)) in continuous_types and has_grad:
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE

    def warnings(self):
        return []
