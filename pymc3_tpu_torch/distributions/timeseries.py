"""Time-series distributions (cf. ``pymc3_tpu/distributions/timeseries.py``).

The Markov-chain log-densities are shifted-difference terms over the whole
series. GARCH(1,1)'s volatility is a recursion, a ``lax.scan`` in the JAX
package; torch has no scan, and a Python loop over the series under
``vmap`` and autograd would dispatch several hundred ops per logp+grad.
The recursion is linear in the variance,

    v_t = β^t v_0 + Σ_{k<t} β^(t-1-k) (ω + α x_k²),

so here it is one product with a lower-triangular Toeplitz matrix of
powers of β (built from constant exponents; the masked cells have exponent
0, so the gradient at β = 0 stays finite).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..config import floatX
from ..node import Node, as_node, apply, evaluate
from .continuous import Flat, get_tau_sigma
from .distribution import (
    Continuous, draw_values, point_lead, rand_normal, _align,
)
from .multivariate import MvNormal, MvStudentT
from .shape_utils import to_tuple

__all__ = ["AR1", "AR", "GaussianRandomWalk", "GARCH11", "EulerMaruyama",
           "MvGaussianRandomWalk", "MvStudentTRandomWalk"]

_LOG_2PI = math.log(2.0 * math.pi)


def _an(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


class AR1(Continuous):
    r"""AR(1) with zero mean (cf. ``timeseries.py:33``)."""

    def __init__(self, k, tau_e, *args, **kwargs):
        self.k = _an(k)
        self.tau_e = _an(tau_e)
        self.tau = apply(lambda k, te: te * (1.0 - k ** 2), self.k, self.tau_e)
        self.mode = as_node(floatX(0.0))
        super().__init__(defaults=("mode",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        k, tau_e = self._ev_params(("k", "tau_e"), env, memo)
        tau = tau_e * (1.0 - k ** 2)
        boundary = -0.5 * tau * value[0] ** 2 \
            + 0.5 * torch.log(tau / (2.0 * np.pi))
        innov = -0.5 * tau_e * (value[1:] - k * value[:-1]) ** 2 \
            + 0.5 * torch.log(tau_e / (2.0 * np.pi))
        return torch.cat([boundary.reshape(1), innov])

    def _random(self, point=None, size=None, gen=None):
        """The stationary start, then the recursion over the series, on the
        device (cf. ``timeseries.py:60``)."""
        gen = self._generator(gen)
        k, tau_e = draw_values([self.k, self.tau_e], point=point, size=size,
                               gen=gen)
        size_t = to_tuple(size)
        n = self.shape[-1] if self.shape else 1
        lead = point_lead(point)
        k = _align(k, lead, len(size_t), 0)
        sigma_e = _align(tau_e, lead, len(size_t), 0) ** -0.5
        z = rand_normal(gen, (n,) + size_t)
        xs = [z[0] * sigma_e / torch.sqrt(1.0 - k ** 2)]
        for t in range(1, n):
            xs.append(k * xs[-1] + sigma_e * z[t])
        return torch.stack([torch.broadcast_to(x, size_t) for x in xs], -1)


class AR(Continuous):
    r"""AR(p) process (cf. ``timeseries.py:72``); ``rho`` has length p (or
    p + 1 with ``constant=True``)."""

    def __init__(self, rho, sigma=None, tau=None, constant=False, init=None,
                 sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        tau, sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sigma = self.sd = sigma
        self.tau = tau
        self.mean = as_node(floatX(0.0))
        if isinstance(rho, (list, tuple)):
            rho = np.asarray(rho, dtype=floatX())
        self.rho = _an(rho)
        self.constant = constant
        rho_len = int(np.atleast_1d(self.rho.test_value).shape[-1])
        self.p = rho_len - 1 if constant else rho_len
        self.init = init or Flat.dist()
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        rho = torch.atleast_1d(evaluate(self.rho, env, memo))
        sigma = evaluate(self.sigma, env, memo)
        p = self.p
        if self.constant:
            const, coefs = rho[..., 0], rho[..., 1:]
        else:
            const, coefs = 0.0, rho
        x = value
        n = x.shape[-1]
        # mean_t = const + sum_i coefs_i x_{t-i-1}, for t >= p
        mean = torch.zeros_like(x[..., p:]) + const
        for i in range(p):
            mean = mean + coefs[..., i] * x[..., p - (i + 1): n - (i + 1)]
        innov_logp = torch.sum(
            -0.5 * ((x[..., p:] - mean) / sigma) ** 2
            - torch.log(sigma) - 0.5 * _LOG_2PI, dim=-1)
        init_logp = torch.sum(self.init.logp(x[..., :p], env, memo))
        return innov_logp + init_logp

    def _random(self, point=None, size=None, gen=None):
        raise NotImplementedError(
            "AR.random is not implemented; sample the prior by ancestral "
            "simulation of the innovations")


def _r_grw(gen, shape, sigma, mu):
    return torch.cumsum(mu + sigma * rand_normal(gen, shape), dim=-1)


class GaussianRandomWalk(Continuous):
    r"""Gaussian random walk (cf. ``timeseries.py:126``)."""

    def __init__(self, tau=None, init=None, sigma=None, mu=0.0, sd=None,
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        kwargs.setdefault("shape", 1)
        tau, sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.tau = tau
        self.sigma = self.sd = sigma
        self.mu = _an(mu)
        self.init = init or Flat.dist()
        self.mean = as_node(floatX(0.0))
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        mu = evaluate(self.mu, env, memo)
        sigma = evaluate(self.sigma, env, memo)
        innov = (-0.5 * ((value[..., 1:] - (value[..., :-1] + mu))
                         / sigma) ** 2
                 - torch.log(sigma) - 0.5 * _LOG_2PI)
        init_lp = self.init.logp(value[..., 0], env, memo)
        return torch.sum(innov, dim=-1) + torch.sum(init_lp)

    def _random(self, point=None, size=None, gen=None):
        """Cumulative sums of normal steps (cf. ``timeseries.py:160``)."""
        return self._draw(_r_grw, ("sigma", "mu"), point, size, gen)


#: Steps a block of the blocked linear recursion behind GARCH11's
#: volatility (chosen on the H100: ``PERF.md`` section 5).
GARCH_BLOCK = 32


@functools.lru_cache(maxsize=32)
def _lower_exponents(size, device, dtype):
    """Exponents ``i - 1 - k`` of a strictly lower Toeplitz matrix of powers
    (0 where ``k >= i``), its mask and ``i``, as constants on the device."""
    i = np.arange(size)
    e = i[:, None] - 1 - i[None, :]
    mask = e >= 0

    def const(a):
        return torch.as_tensor(a, device=device).to(dtype)
    return const(np.where(mask, e, 0)), const(mask), const(i)


def _lower_powers(base, size, like):
    """``P[i, k] = base^(i - 1 - k)`` for ``k < i``, else 0, and
    ``base^i``."""
    e, mask, i = _lower_exponents(size, like.device, like.dtype)
    return mask * torch.pow(base, e), torch.pow(base, i)


def _linear_recursion(u, beta, v0):
    """``v_t = β v_{t-1} + u_{t-1}`` from ``v_0``, for ``t < n`` over the
    last axis of ``u``, with no loop over steps: ``v_t = β^t v_0 +
    Σ_{k<t} β^{t-1-k} u_k``. Up to ``L = GARCH_BLOCK`` steps that is one
    ``(n, n)`` Toeplitz product. Longer series go in blocks of ``L``: in a
    block starting at ``t0``, ``v_{t0+j} = β^j v_{t0} + Σ_{k<j}
    β^{j-1-k} u_{t0+k}``, one ``(L, L)`` product for every block at once;
    each block's sum carried to its end, ``c_b``, drives the block starts,
    ``s_{b+1} = β^L s_b + c_b``: the same recursion over ``ceil(n / L)``
    blocks with ``β^L``, solved by this function again. The depth is
    ``log_L(n)``, fixed by the shape, and a series holds ``O(n + L²)``
    numbers a level where one Toeplitz product over it held ``n²``."""
    n = u.shape[-1]
    L = GARCH_BLOCK
    if n <= L:
        powers, beta_t = _lower_powers(beta, n, u)
        return beta_t * v0 + u @ powers.transpose(-1, -2)
    nb = -(-n // L)
    u = torch.nn.functional.pad(u, (0, nb * L - n))
    u = u.reshape(*u.shape[:-1], nb, L)
    powers, beta_j = _lower_powers(beta, L, u)
    w = u @ powers.transpose(-1, -2)
    starts = _linear_recursion(beta * w[..., -1] + u[..., -1], beta ** L, v0)
    v = beta_j * starts[..., None] + w
    return v.reshape(*v.shape[:-2], nb * L)[..., :n]


class GARCH11(Continuous):
    r"""GARCH(1,1) volatility process (cf. ``timeseries.py:169``)."""

    def __init__(self, omega, alpha_1, beta_1, initial_vol, *args, **kwargs):
        self.omega = _an(omega)
        self.alpha_1 = _an(alpha_1)
        self.beta_1 = _an(beta_1)
        self.initial_vol = _an(initial_vol)
        self.mean = as_node(floatX(0.0))
        super().__init__(defaults=("mean",), *args, **kwargs)

    def _vol(self, x, omega, alpha_1, beta_1, initial_vol):
        """Volatilities of the series ``x: (..., n)``: the recursion
        ``v_t = ω + α x_{t-1}² + β v_{t-1}`` from ``v_0 = initial_vol²``
        (cf. ``timeseries.py:181``, a ``lax.scan``), blocked as
        :func:`_linear_recursion` says."""
        return torch.sqrt(_linear_recursion(
            omega + alpha_1 * x ** 2, beta_1, initial_vol * initial_vol))

    def logp(self, value, env=None, memo=None):
        omega, alpha_1, beta_1, initial_vol = self._ev_params(
            ("omega", "alpha_1", "beta_1", "initial_vol"), env, memo)
        vol = self._vol(value, omega, alpha_1, beta_1, initial_vol)
        return -0.5 * (value / vol) ** 2 - torch.log(vol) - 0.5 * _LOG_2PI

    def _random(self, point=None, size=None, gen=None):
        raise NotImplementedError("GARCH11.random is not implemented")


class EulerMaruyama(Continuous):
    r"""SDE by Euler-Maruyama discretization (cf. ``timeseries.py:195``);
    ``sde_fn(x, *sde_pars) -> (drift, diffusion)`` takes and returns
    tensors."""

    def __init__(self, dt, sde_fn, sde_pars, *args, **kwargs):
        self.dt = _an(dt)
        self.sde_fn = sde_fn
        self.sde_pars = [_an(p) for p in sde_pars]
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        dt = evaluate(self.dt, env, memo)
        pars = [evaluate(p, env, memo) for p in self.sde_pars]
        xt = value[..., :-1]
        f, g = self.sde_fn(xt, *pars)
        mu = xt + dt * f
        sigma = torch.sqrt(dt) * g
        return (-0.5 * ((value[..., 1:] - mu) / sigma) ** 2
                - torch.log(sigma) - 0.5 * _LOG_2PI)

    def _random(self, point=None, size=None, gen=None):
        raise NotImplementedError("EulerMaruyama.random is not implemented")


class MvGaussianRandomWalk(Continuous):
    r"""Multivariate Gaussian random walk (cf. ``timeseries.py:227``)."""

    def __init__(self, mu=0.0, cov=None, tau=None, chol=None, lower=True,
                 init=None, *args, **kwargs):
        self.init = init or Flat.dist()
        self.innov = MvNormal.dist(mu=mu, cov=cov, tau=tau, chol=chol,
                                   lower=lower,
                                   shape=kwargs.get("shape", ())[-1:] or None)
        self.mean = as_node(floatX(0.0))
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        innov_logp = self.innov.logp(value[..., 1:, :] - value[..., :-1, :],
                                     env, memo)
        init_logp = self.init.logp(value[..., 0, :], env, memo)
        return torch.sum(innov_logp) + torch.sum(init_logp)

    def _random(self, point=None, size=None, gen=None):
        raise NotImplementedError


class MvStudentTRandomWalk(MvGaussianRandomWalk):
    r"""Multivariate Student's t random walk (cf. ``timeseries.py:261``)."""

    def __init__(self, nu, *args, **kwargs):
        super().__init__(*args, **kwargs)
        inner = self.innov
        param = {"cov": "cov", "chol": "chol_cov", "tau": "tau"}[
            inner._cov_param]
        self.innov = MvStudentT.dist(
            nu=nu, mu=inner.mu, **{inner._cov_param: getattr(inner, param)})
