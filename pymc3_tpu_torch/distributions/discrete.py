"""Discrete distributions (cf. ``pymc3_tpu/distributions/discrete.py``).

The JAX package's 15 distributions with its names, signatures, test values
(the mode, the median for the discrete Weibull) and log-densities. A value
may be an integer tensor (observed data) or a float one: a free discrete
variable rides in the samplers' flat vector as a float, as in the JAX
package, so every ``logp`` first takes its value to ``floatX``.

Where torch differs from XLA:

- ``Binomial.logcdf`` uses the port's incomplete beta and ``Poisson.logcdf``
  its incomplete gamma (``dist_math.betainc`` / ``gammaincc``). The integer
  part of the value enters them as a shape parameter; ``floor`` has no
  gradient, so it is detached and autograd never asks for the derivative in
  the shape;
- draws come from an explicit ``torch.Generator`` on the device:
  ``torch.binomial`` and ``torch.poisson``; the negative binomial as a
  Gamma-Poisson mixture; the geometric, the discrete Weibull, the discrete
  uniform and the categorical by inverting their CDF on uniforms; the
  zero-inflated ones by a Bernoulli mask. They come back as int64 tensors.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..config import floatX, intX, torch_floatX
from ..math import _log1mexp
from ..node import Node, as_node, apply
from .dist_math import (
    bound, binomln, betaln, factln, logpow, betainc, gammaincc,
    clipped_beta_rvs,
)
from .distribution import (
    Discrete, draw_values, point_lead, rand_uniform, rand_gamma, _align,
)
from .shape_utils import to_tuple

__all__ = [
    "Binomial", "BetaBinomial", "Bernoulli", "DiscreteWeibull", "Poisson",
    "NegativeBinomial", "Constant", "ConstantDist", "ZeroInflatedPoisson",
    "ZeroInflatedBinomial", "ZeroInflatedNegativeBinomial", "DiscreteUniform",
    "Geometric", "Categorical", "OrderedLogistic",
]


def _an(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


def _fv(value):
    """The value as ``floatX`` (observed data is integer)."""
    return value.to(torch_floatX())


def _int(x):
    return x.to(getattr(torch, intX()))


def _round_np(n, p):
    return _int(torch.minimum(torch.clamp(torch.round(n * p), min=0), n))


# -- samplers: sampler(gen, shape, *params) -> int64 tensor of ``shape`` -----
def _r_binomial(gen, shape, n, p):
    n = torch.broadcast_to(_fv(n), shape).contiguous()
    p = torch.broadcast_to(_fv(p), shape).contiguous()
    return torch.binomial(n, p, generator=gen).long()


def _r_betabinomial(gen, shape, alpha, beta, n):
    p = clipped_beta_rvs(alpha.expand(shape), beta.expand(shape), size=shape,
                         gen=gen)
    return _r_binomial(gen, shape, n, p)


def _r_bernoulli(gen, shape, p):
    return (rand_uniform(gen, shape) < p).long()


def _r_discrete_weibull(gen, shape, q, beta):
    u = rand_uniform(gen, shape, torch.float64)
    x = torch.ceil((torch.log1p(-u) / torch.log(q.double()))
                   ** (1.0 / beta.double())) - 1.0
    return torch.clamp(x, min=0).long()


def _r_poisson(gen, shape, mu):
    return torch.poisson(torch.broadcast_to(_fv(mu), shape).contiguous(),
                         generator=gen).long()


def _r_negbinomial(gen, shape, mu, alpha):
    rate = rand_gamma(gen, shape, alpha) * (mu.double() / alpha.double())
    return torch.poisson(rate, generator=gen).long()


def _r_geometric(gen, shape, p):
    # the smallest k with 1 - (1 - p)^k >= u; log(1 - U) is log of a uniform
    u = rand_uniform(gen, shape, torch.float64)
    k = torch.ceil(torch.log1p(-u) / torch.log1p(-p.double()))
    return torch.clamp(k, min=1).long()


def _r_discrete_uniform(gen, shape, lower, upper):
    lower, upper = lower.double(), upper.double()
    u = rand_uniform(gen, shape, torch.float64)
    x = lower + torch.floor(u * (upper - lower + 1.0))
    return torch.minimum(x, upper.expand(shape)).long()


def _r_constant(gen, shape, c):
    return torch.broadcast_to(c, shape).contiguous()


def _zero_inflate(sampler):
    def draw(gen, shape, psi, *params):
        keep = rand_uniform(gen, shape) < psi
        return sampler(gen, shape, *params) * keep
    return draw


_r_zi_poisson = _zero_inflate(_r_poisson)
_r_zi_binomial = _zero_inflate(_r_binomial)
_r_zi_negbinomial = _zero_inflate(_r_negbinomial)


# -- distributions -----------------------------------------------------------
class Binomial(Discrete):
    r"""Binomial (cf. ``discrete.py:36``)."""

    def __init__(self, n, p, *args, **kwargs):
        self.n = _an(n)
        self.p = _an(p)
        self.mode = apply(_round_np, self.n, self.p)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.n, self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        n, p = self._ev_params(("n", "p"), env, memo)
        value = _fv(value)
        return bound(
            binomln(n, value) + logpow(p, value) + logpow(1.0 - p, n - value),
            value >= 0, value <= n, p >= 0, p <= 1)

    def logcdf(self, value, env=None, memo=None):
        n, p = self._ev_params(("n", "p"), env, memo)
        value = _fv(value)
        k = torch.floor(value.detach())
        safe_k = torch.minimum(torch.clamp(k, min=0), n - 1.0)
        inner = torch.log(betainc((n - safe_k).detach(), safe_k + 1.0,
                                  1.0 - p))
        return torch.where(value < 0, -torch.inf,
                           torch.where(value >= n, 0.0, inner))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_binomial, ("n", "p"), point, size, gen)


class BetaBinomial(Discrete):
    r"""Beta-binomial (cf. ``discrete.py:73``)."""

    def __init__(self, alpha, beta, n, *args, **kwargs):
        self.alpha = _an(alpha)
        self.beta = _an(beta)
        self.n = _an(n)
        self.mode = apply(lambda a, b, n: _round_np(n, a / (a + b)),
                          self.alpha, self.beta, self.n)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta, self.n)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        alpha, beta, n = self._ev_params(("alpha", "beta", "n"), env, memo)
        value = _fv(value)
        return bound(
            binomln(n, value) + betaln(value + alpha, n - value + beta)
            - betaln(alpha, beta),
            value >= 0, value <= n, alpha > 0, beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_betabinomial, ("alpha", "beta", "n"), point,
                          size, gen)


class Bernoulli(Discrete):
    r"""Bernoulli, by ``p`` or ``logit_p`` (cf. ``discrete.py:107``)."""

    def __init__(self, p=None, logit_p=None, *args, **kwargs):
        if sum(x is not None for x in (p, logit_p)) != 1:
            raise ValueError("Specify one of p and logit_p")
        if p is not None:
            self.p = _an(p)
            self._is_logit = False
        else:
            self.p = apply(torch.sigmoid, _an(logit_p))
            self._is_logit = True
        self.mode = apply(lambda p: _int(p > 0.5), self.p)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        p, = self._ev_params(("p",), env, memo)
        value = _fv(value)
        return bound(
            torch.where(value == 1, torch.log(torch.where(p > 0, p, 1.0)),
                        torch.log1p(-torch.where(p < 1, p, 0.0))),
            value >= 0, value <= 1, p >= 0, p <= 1)

    def logcdf(self, value, env=None, memo=None):
        p, = self._ev_params(("p",), env, memo)
        value = _fv(value)
        return torch.where(value < 0, -torch.inf,
                           torch.where(value < 1, torch.log1p(-p), 0.0))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_bernoulli, ("p",), point, size, gen)


class DiscreteWeibull(Discrete):
    r"""Discrete Weibull (cf. ``discrete.py:146``)."""

    def _host_dtype(self):
        # the JAX package's draws are float ceilings
        return np.dtype("float64")

    def __init__(self, q, beta, *args, **kwargs):
        self.q = _an(q)
        self.beta = _an(beta)
        self.median = apply(
            lambda q, b: _int(torch.ceil(
                (math.log(0.5) / torch.log(q)) ** (1.0 / b)) - 1.0),
            self.q, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.q, self.beta)
        super().__init__(defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        q, beta = self._ev_params(("q", "beta"), env, memo)
        value = _fv(value)
        vv = torch.clamp(value, min=0)
        # log(q^(v^b) - q^((v+1)^b)) in log space, as in the JAX package:
        # v^b log q + log(1 - q^((v+1)^b - v^b))
        eps = torch.finfo(torch_floatX()).eps
        lq = torch.log(torch.clamp(q, eps, 1.0 - eps))
        d = (vv + 1.0) ** beta - vv ** beta
        return bound(vv ** beta * lq + _log1mexp(-d * lq),
                     value >= 0, q > 0, q < 1, beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_discrete_weibull, ("q", "beta"), point, size,
                          gen)


def _poisson_logp(mu, value):
    logp = logpow(mu, value) - factln(value) - mu
    # Poisson(0) has all its mass at 0
    return torch.where((mu == 0) & (value == 0), 0.0, logp)


class Poisson(Discrete):
    r"""Poisson (cf. ``discrete.py:188``)."""

    def __init__(self, mu, *args, **kwargs):
        self.mu = _an(mu)
        self.mode = apply(lambda m: _int(torch.floor(m)), self.mu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, = self._ev_params(("mu",), env, memo)
        value = _fv(value)
        return bound(_poisson_logp(mu, value), value >= 0, mu >= 0)

    def logcdf(self, value, env=None, memo=None):
        mu, = self._ev_params(("mu",), env, memo)
        value = _fv(value)
        safe_k = torch.clamp(torch.floor(value.detach()), min=0)
        return torch.where(value < 0, -torch.inf,
                           torch.log(gammaincc(safe_k + 1.0, mu)))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_poisson, ("mu",), point, size, gen)


def _negbinomial_logp(mu, alpha, value):
    return (binomln(value + alpha - 1.0, value)
            + logpow(mu / (mu + alpha), value)
            + logpow(alpha / (mu + alpha), alpha))


class NegativeBinomial(Discrete):
    r"""Negative binomial by (mu, alpha) (cf. ``discrete.py:223``)."""

    def __init__(self, mu, alpha, *args, **kwargs):
        self.mu = _an(mu)
        self.alpha = _an(alpha)
        self.mode = apply(lambda m: _int(torch.floor(m)), self.mu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.alpha)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, alpha = self._ev_params(("mu", "alpha"), env, memo)
        value = _fv(value)
        negbinom = bound(_negbinomial_logp(mu, alpha, value),
                         value >= 0, mu > 0, alpha > 0)
        # the limit alpha -> inf is the Poisson
        poisson = bound(logpow(mu, value) - factln(value) - mu,
                        value >= 0, mu >= 0)
        return torch.where(alpha > 1e10, poisson, negbinom)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_negbinomial, ("mu", "alpha"), point, size, gen)


class Geometric(Discrete):
    r"""Geometric on {1, 2, ...} (cf. ``discrete.py:258``)."""

    def __init__(self, p, *args, **kwargs):
        self.p = _an(p)
        self.mode = as_node(np.asarray(1, dtype=intX()))
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        p, = self._ev_params(("p",), env, memo)
        value = _fv(value)
        return bound(torch.log(p) + logpow(1.0 - p, value - 1.0),
                     value >= 1, p <= 1, p > 0)

    def logcdf(self, value, env=None, memo=None):
        p, = self._ev_params(("p",), env, memo)
        value = _fv(value)
        k = torch.clamp(torch.floor(value.detach()), min=1.0)
        return torch.where(value < 1, -torch.inf,
                           torch.log1p(-(1.0 - p) ** k))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_geometric, ("p",), point, size, gen)


def _int_bound(x):
    if isinstance(x, Node):
        return x
    return as_node(np.asarray(np.floor(np.asarray(x)), dtype=intX()))


class DiscreteUniform(Discrete):
    r"""Discrete uniform on {lower..upper} (cf. ``discrete.py:289``)."""

    def __init__(self, lower, upper, *args, **kwargs):
        self.lower = _int_bound(lower)
        self.upper = _int_bound(upper)
        self.mode = apply(
            lambda l, u: _int(torch.maximum(torch.floor((l + u) / 2.0), l)),
            self.lower, self.upper)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.lower, self.upper)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        lower, upper = self._ev_params(("lower", "upper"), env, memo)
        value = _fv(value)
        # the integer bounds in floatX: int + 1.0 is torch's default float
        return bound(-torch.log(_fv(upper) - _fv(lower) + 1.0),
                     value >= lower, value <= upper)

    def logcdf(self, value, env=None, memo=None):
        lower, upper = self._ev_params(("lower", "upper"), env, memo)
        value = _fv(value)
        k = torch.floor(value.detach())
        inner = (torch.log(torch.clamp(torch.minimum(k, _fv(upper)) - lower
                                       + 1.0, min=1.0))
                 - torch.log(_fv(upper) - _fv(lower) + 1.0))
        return torch.where(value < lower, -torch.inf,
                           torch.where(value >= upper, 0.0, inner))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_discrete_uniform, ("lower", "upper"), point,
                          size, gen)


class Categorical(Discrete):
    r"""Categorical over {0..K-1}; the last axis of ``p`` indexes the
    categories (cf. ``discrete.py:333``)."""

    def __init__(self, p, *args, **kwargs):
        self.p = _an(p)
        self.k = int(np.shape(self.p.test_value)[-1])
        self.mode = apply(lambda p: _int(torch.argmax(p, dim=-1)), self.p)
        if kwargs.get("shape") is None:
            batch = tuple(np.shape(self.p.test_value)[:-1])
            kwargs["shape"] = kwargs.pop("shape", None) or batch
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        p, = self._ev_params(("p",), env, memo)
        p = p / torch.sum(p, dim=-1, keepdim=True)
        k = p.shape[-1]
        # the index is an integer cast of the value: no gradient runs
        # through it, and none is asked for
        safe = torch.clamp(value.detach().long(), 0, k - 1)
        rows = torch.broadcast_to(p, torch.broadcast_shapes(
            p.shape, tuple(safe.shape) + (k,)))
        sel = torch.gather(rows, -1, torch.broadcast_to(
            safe, rows.shape[:-1])[..., None])[..., 0]
        value = _fv(value)
        return bound(torch.log(sel), value >= 0, value <= k - 1,
                     torch.all(p >= 0, dim=-1), torch.all(p <= 1, dim=-1))

    def _random(self, point=None, size=None, gen=None):
        """Inverse CDF on one uniform per draw: the index of the first
        cumulative weight above it."""
        gen = self._generator(gen)
        size_t = to_tuple(size)
        p, = draw_values([self.p], point=point, size=size, gen=gen)
        lead = point_lead(point)
        core = tuple(self.shape) if self.shape else tuple(p.shape[lead:-1])
        p = _align(p, lead, len(size_t), len(core) + 1)
        cum = torch.cumsum(p / p.sum(-1, keepdim=True), dim=-1)
        u = rand_uniform(gen, size_t + core)
        idx = (u[..., None] >= cum).sum(-1)
        return torch.clamp(idx, max=p.shape[-1] - 1)


class Constant(Discrete):
    r"""Point mass (cf. ``discrete.py:371``)."""

    def _host_dtype(self):
        # the JAX package fills with c's test value, a floatX
        return np.dtype(floatX())

    def __init__(self, c, *args, **kwargs):
        self.mean = self.median = self.mode = self.c = _an(c)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.c)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        c, = self._ev_params(("c",), env, memo)
        value = _fv(value)
        return bound(torch.zeros_like(value), value == c)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_constant, ("c",), point, size, gen)


ConstantDist = Constant


class _ZeroInflated(Discrete):
    """What the zero-inflated mixtures share."""

    @staticmethod
    def _zi_logp(value, psi, base_logp_at_value, base_logp_at_zero):
        logp_nonzero = torch.log(psi) + base_logp_at_value
        logp_zero = torch.logaddexp(torch.log1p(-psi),
                                    torch.log(psi) + base_logp_at_zero)
        return torch.where(value > 0, logp_nonzero, logp_zero)


class ZeroInflatedPoisson(_ZeroInflated):
    r"""Zero-inflated Poisson (cf. ``discrete.py:408``)."""

    def __init__(self, psi, theta, *args, **kwargs):
        self.theta = _an(theta)
        self.psi = _an(psi)
        self.mode = apply(lambda t: _int(torch.floor(t)), self.theta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.psi, self.theta)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        psi, theta = self._ev_params(("psi", "theta"), env, memo)
        value = _fv(value)
        base = logpow(theta, value) - factln(value) - theta
        out = self._zi_logp(value, psi, base, -theta)
        return bound(out, value >= 0, psi >= 0, psi <= 1, theta >= 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_zi_poisson, ("psi", "theta"), point, size, gen)


class ZeroInflatedBinomial(_ZeroInflated):
    r"""Zero-inflated binomial (cf. ``discrete.py:437``)."""

    def __init__(self, psi, n, p, *args, **kwargs):
        self.n = _an(n)
        self.p = _an(p)
        self.psi = _an(psi)
        self.mode = apply(_round_np, self.n, self.p)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.psi, self.n, self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        psi, n, p = self._ev_params(("psi", "n", "p"), env, memo)
        value = _fv(value)
        base = (binomln(n, value) + logpow(p, value)
                + logpow(1.0 - p, n - value))
        base_zero = n * torch.log1p(-torch.where(p < 1, p, 0.0))
        out = self._zi_logp(value, psi, base, base_zero)
        return bound(out, value >= 0, value <= n, psi >= 0, psi <= 1,
                     p >= 0, p <= 1)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_zi_binomial, ("psi", "n", "p"), point, size,
                          gen)


class ZeroInflatedNegativeBinomial(_ZeroInflated):
    r"""Zero-inflated negative binomial (cf. ``discrete.py:471``)."""

    def __init__(self, psi, mu, alpha, *args, **kwargs):
        self.mu = _an(mu)
        self.alpha = _an(alpha)
        self.psi = _an(psi)
        self.mode = apply(lambda m: _int(torch.floor(m)), self.mu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.psi, self.mu, self.alpha)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        psi, mu, alpha = self._ev_params(("psi", "mu", "alpha"), env, memo)
        value = _fv(value)
        base = _negbinomial_logp(mu, alpha, value)
        base_zero = alpha * (torch.log(alpha) - torch.log(alpha + mu))
        out = self._zi_logp(value, psi, base, base_zero)
        return bound(out, value >= 0, psi >= 0, psi <= 1, mu > 0, alpha > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_zi_negbinomial, ("psi", "mu", "alpha"), point,
                          size, gen)


def _ordered_p(eta, cutpoints):
    pa = torch.sigmoid(cutpoints - eta[..., None])
    p_cum = torch.cat([torch.zeros_like(pa[..., :1]), pa,
                       torch.ones_like(pa[..., :1])], dim=-1)
    return p_cum[..., 1:] - p_cum[..., :-1]


class OrderedLogistic(Categorical):
    r"""Ordered logistic: a categorical whose probabilities are the steps
    of the logistic CDF at the cutpoints (cf. ``discrete.py:505``)."""

    def __init__(self, eta, cutpoints, *args, **kwargs):
        self.eta = _an(eta)
        self.cutpoints = _an(cutpoints)
        p = apply(_ordered_p, self.eta, self.cutpoints)
        super().__init__(p=p, *args, **kwargs)
