"""Univariate continuous distributions (cf. ``pymc3_tpu/distributions/continuous.py``).

The JAX package's 30 distributions with its names, signatures, defaults and
default transforms (log for positive support, logodds for the unit
interval, interval or bound transforms for bounded support). Each stores its
parameters as symbolic nodes and has an elementwise tensor ``logp``
(``-inf`` outside the support through ``bound``), ``logcdf`` where the JAX
package has one, and ``random`` drawing on the device from an explicit
generator.

Where torch differs from XLA:

- Gamma and InverseGamma ``logcdf`` use the port's incomplete gamma
  (``dist_math.gammainc`` / ``gammaincc``), differentiable in the value and
  in the shape ``alpha`` as ``jax.scipy.special.gammainc`` is (torch's own
  has no derivative in the shape);
- Beta and StudentT ``logcdf`` use the port's incomplete beta
  (``dist_math.betainc``);
- samplers use the generator-taking primitives of torch (normal, uniform,
  exponential, standard gamma) and inverse-CDF or transformation formulas
  where a family has none; VonMises uses the Best-Fisher rejection sampler
  with a fixed trip count and a mask.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from ..config import floatX, torch_floatX
from ..node import Node, as_node, apply
from . import transforms
from .dist_math import (
    bound, logpow, betaln, normal_lcdf, normal_lccdf, log_diff_normal_cdf,
    betainc, gammainc, gammaincc, clipped_beta_rvs, interp,
)
from .special import log_i0
from .distribution import (
    Continuous, rand_uniform, rand_normal, rand_exponential, rand_gamma,
)

__all__ = [
    "Uniform", "Flat", "HalfFlat", "Normal", "TruncatedNormal", "HalfNormal",
    "Wald", "Beta", "Kumaraswamy", "Exponential", "Laplace", "Lognormal",
    "StudentT", "Pareto", "Cauchy", "HalfCauchy", "Gamma", "InverseGamma",
    "ChiSquared", "Weibull", "HalfStudentT", "ExGaussian", "VonMises",
    "SkewNormal", "Triangular", "Gumbel", "Rice", "Logistic", "LogitNormal",
    "Interpolated",
]

_LOG2PI = math.log(2.0 * math.pi)


def _param(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


def _f32(x):
    return x.to(torch_floatX())


class PositiveContinuous(Continuous):
    """Positive support; default log transform (cf. ``continuous.py:41``)."""

    def __init__(self, transform=transforms.log, *args, **kwargs):
        if transform == "auto" or transform is True:
            transform = transforms.log
        super().__init__(transform=transform, *args, **kwargs)


class UnitContinuous(Continuous):
    """(0, 1) support; default logodds transform (cf. ``continuous.py:50``)."""

    def __init__(self, transform=transforms.logodds, *args, **kwargs):
        if transform == "auto" or transform is True:
            transform = transforms.logodds
        super().__init__(transform=transform, *args, **kwargs)


class BoundedContinuous(Continuous):
    """Interval support (cf. ``continuous.py:59``)."""

    def __init__(self, transform="auto", lower=None, upper=None,
                 *args, **kwargs):
        if transform == "auto" or transform is True:
            if lower is None and upper is None:
                transform = None
            elif lower is not None and upper is not None:
                transform = transforms.interval(lower, upper)
            elif upper is not None:
                transform = transforms.upperbound(upper)
            else:
                transform = transforms.lowerbound(lower)
        super().__init__(transform=transform, *args, **kwargs)


def assert_negative_support(var, label, distname, value=-1e-6):
    """Warn when a parameter's test value is not positive
    (cf. ``continuous.py:82``)."""
    if np.any(np.asarray(as_node(var).test_value) <= value):
        warnings.warn(
            f"The variable specified for {label} has negative support for "
            f"{distname}, likely making it unsuitable for this parameter.",
            UserWarning)


def get_tau_sigma(tau=None, sigma=None):
    """Precision/stddev pair from whichever was given
    (cf. ``continuous.py:96``)."""
    if tau is None:
        if sigma is None:
            return as_node(floatX(1.0)), as_node(floatX(1.0))
        sigma = _param(sigma)
        return apply(lambda s: s ** -2.0, sigma), sigma
    if sigma is not None:
        raise ValueError("Can't pass both tau and sigma")
    tau = _param(tau)
    return tau, apply(lambda t: t ** -0.5, tau)


# -- samplers: sampler(gen, shape, *params) -> tensor of ``shape`` -----------
def _r_uniform(gen, shape, lower, upper):
    return lower + (upper - lower) * rand_uniform(gen, shape)


def _r_normal(gen, shape, mu, sigma):
    return mu + sigma * rand_normal(gen, shape)


def _r_halfnormal(gen, shape, sigma):
    return torch.abs(sigma * rand_normal(gen, shape))


def _r_truncnorm(gen, shape, mu, sigma, lower, upper):
    """Inverse CDF in float64; a window right of the mean is drawn
    mirrored, where the CDF keeps its precision."""
    mu, sigma = mu.double(), sigma.double()
    a = (lower.double() - mu) / sigma
    b = (upper.double() - mu) / sigma
    flip = a > 0
    lo = torch.where(flip, -b, a)
    hi = torch.where(flip, -a, b)
    plo, phi = torch.special.ndtr(lo), torch.special.ndtr(hi)
    u = rand_uniform(gen, shape, torch.float64)
    x = torch.special.ndtri(plo + (phi - plo) * u)
    x = torch.minimum(torch.maximum(torch.where(flip, -x, x), a), b)
    return _f32(mu + sigma * x)


def _r_wald(gen, shape, mu, lam, alpha):
    """Michael, Schucany and Haas (1976), as numpy's ``wald``, with the
    root taken in a cancellation-free form, in float64."""
    mu, lam = mu.double(), lam.double()
    y = mu * rand_normal(gen, shape, torch.float64) ** 2
    x = mu - 2.0 * mu * y / (y + torch.sqrt(y * y + 4.0 * lam * y))
    u = rand_uniform(gen, shape, torch.float64)
    return _f32(torch.where(u <= mu / (mu + x), x, mu * mu / x)) + alpha


def _r_beta(gen, shape, alpha, beta):
    return clipped_beta_rvs(alpha.expand(shape), beta.expand(shape),
                            size=shape, gen=gen)


def _r_kumaraswamy(gen, shape, a, b):
    u = rand_uniform(gen, shape)
    return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)


def _r_exponential(gen, shape, lam):
    return rand_exponential(gen, shape) / lam


def _r_laplace(gen, shape, mu, b):
    # the difference of two unit exponentials is a unit Laplace
    return mu + b * (rand_exponential(gen, shape) - rand_exponential(gen, shape))


def _r_lognormal(gen, shape, mu, tau):
    return torch.exp(mu + tau ** -0.5 * rand_normal(gen, shape))


def _std_t(gen, shape, nu):
    """Unit Student's t: Z * sqrt(nu / chi2_nu), the chi-square as twice a
    float64 gamma draw."""
    chi2 = 2.0 * rand_gamma(gen, shape, nu / 2.0)
    scale = torch.sqrt(nu.double() / chi2)
    return _f32(rand_normal(gen, shape, torch.float64) * scale)


def _r_studentt(gen, shape, nu, mu, lam):
    return mu + lam ** -0.5 * _std_t(gen, shape, nu)


def _r_pareto(gen, shape, alpha, m):
    return m * torch.exp(rand_exponential(gen, shape) / alpha)


def _std_cauchy(gen, shape):
    # the ratio of two standard normals
    return rand_normal(gen, shape) / rand_normal(gen, shape)


def _r_cauchy(gen, shape, alpha, beta):
    return alpha + beta * _std_cauchy(gen, shape)


def _r_halfcauchy(gen, shape, beta):
    return torch.abs(beta * _std_cauchy(gen, shape))


def _r_gamma(gen, shape, alpha, beta):
    return _f32(rand_gamma(gen, shape, alpha) / beta.double())


def _r_inversegamma(gen, shape, alpha, beta):
    return _f32(beta.double() / rand_gamma(gen, shape, alpha))


def _r_chisquared(gen, shape, nu):
    return _f32(2.0 * rand_gamma(gen, shape, nu / 2.0))


def _r_weibull(gen, shape, alpha, beta):
    return beta * rand_exponential(gen, shape) ** (1.0 / alpha)


def _r_halfstudentt(gen, shape, nu, sigma):
    return torch.abs(sigma * _std_t(gen, shape, nu))


def _r_exgaussian(gen, shape, mu, sigma, nu):
    return (mu + sigma * rand_normal(gen, shape)
            + nu * rand_exponential(gen, shape))


# Trips of the VonMises rejection sampler. Best-Fisher accepts at least
# about 65% of proposals at every kappa, so every element is accepted
# after 64 trips but with probability below 1e-29.
_VONMISES_TRIPS = 64


def _r_vonmises(gen, shape, mu, kappa):
    """Best and Fisher (1979) as numpy's ``vonmises``: every trip proposes
    for all elements, and a mask keeps the first accepted proposal."""
    kappa = torch.broadcast_to(kappa.double(), shape)
    r = 1.0 + torch.sqrt(1.0 + 4.0 * kappa * kappa)
    rho = (r - torch.sqrt(2.0 * r)) / (2.0 * kappa)
    s = torch.where(kappa < 1e-5, 1.0 / kappa + kappa,
                    (1.0 + rho * rho) / (2.0 * rho))
    w = torch.zeros(shape, dtype=torch.float64, device=gen.device)
    done = torch.zeros(shape, dtype=torch.bool, device=gen.device)
    for _ in range(_VONMISES_TRIPS):
        z = torch.cos(math.pi * rand_uniform(gen, shape, torch.float64))
        wc = (1.0 + s * z) / (s + z)
        y = kappa * (s - wc)
        v = rand_uniform(gen, shape, torch.float64)
        ok = (y * (2.0 - y) - v >= 0) | (torch.log(y / v) + 1.0 - y >= 0)
        w = torch.where(ok & ~done, wc, w)
        done = done | ok
    if not bool(done.all()):
        raise RuntimeError(f"VonMises rejection sampler did not accept every "
                           f"draw in {_VONMISES_TRIPS} trips")
    u = rand_uniform(gen, shape, torch.float64)
    angle = torch.acos(torch.clamp(w, -1.0, 1.0))
    angle = torch.where(u < 0.5, -angle, angle)
    # kappa ~ 0: the uniform circle
    angle = torch.where(kappa < 1e-8, math.pi * (2.0 * u - 1.0), angle)
    x = angle + mu.double()
    return _f32(torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi)


def _r_skewnormal(gen, shape, mu, sigma, alpha):
    delta = alpha / torch.sqrt(1.0 + alpha * alpha)
    u0 = rand_normal(gen, shape)
    v = rand_normal(gen, shape)
    u1 = delta * u0 + torch.sqrt(1.0 - delta * delta) * v
    return mu + sigma * torch.where(u0 >= 0, u1, -u1)


def _r_triangular(gen, shape, c, lower, upper):
    u = rand_uniform(gen, shape)
    width = upper - lower
    fc = (c - lower) / width
    left = lower + torch.sqrt(u * width * (c - lower))
    right = upper - torch.sqrt((1.0 - u) * width * (upper - c))
    return torch.where(u < fc, left, right)


def _r_gumbel(gen, shape, mu, beta):
    return mu - beta * torch.log(rand_exponential(gen, shape))


def _r_rice(gen, shape, nu, sigma):
    x = nu + sigma * rand_normal(gen, shape)
    y = sigma * rand_normal(gen, shape)
    return torch.sqrt(x * x + y * y)


def _r_logistic(gen, shape, mu, s):
    # the difference of two standard Gumbels is a standard logistic
    e1, e2 = rand_exponential(gen, shape), rand_exponential(gen, shape)
    return mu + s * (torch.log(e2) - torch.log(e1))


def _r_logitnormal(gen, shape, mu, tau):
    return torch.sigmoid(mu + tau ** -0.5 * rand_normal(gen, shape))


# -- distributions -----------------------------------------------------------
class Uniform(BoundedContinuous):
    r"""Continuous uniform (cf. ``continuous.py:118``)."""

    def __init__(self, lower=0, upper=1, *args, **kwargs):
        self.lower = lower = _param(lower)
        self.upper = upper = _param(upper)
        self.mean = apply(lambda l, u: (l + u) / 2.0, lower, upper)
        self.median = self.mean
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                lower, upper)
        super().__init__(lower=lower, upper=upper, defaults=("mean",),
                         *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        lower, upper = self._ev_params(("lower", "upper"), env, memo)
        return bound(-torch.log(upper - lower),
                     value >= lower, value <= upper)

    def logcdf(self, value, env=None, memo=None):
        lower, upper = self._ev_params(("lower", "upper"), env, memo)
        return torch.where(
            value < lower, -torch.inf,
            torch.where(value >= upper, 0.0,
                        torch.log(value - lower) - torch.log(upper - lower)))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_uniform, ("lower", "upper"), point, size, gen)


class Flat(Continuous):
    r"""Improper flat prior, logp = 0 (cf. ``continuous.py:154``)."""

    def __init__(self, *args, **kwargs):
        self._default = 0.0
        super().__init__(defaults=("_default",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        return torch.zeros_like(value, dtype=torch_floatX())

    def logcdf(self, value, env=None, memo=None):
        return torch.where(value == -torch.inf, -torch.inf,
                           torch.where(value == torch.inf, 0.0,
                                       math.log(0.5)))

    def _random(self, point=None, size=None, gen=None):
        raise ValueError("Cannot sample from Flat distribution")


class HalfFlat(PositiveContinuous):
    r"""Improper flat prior on the positives (cf. ``continuous.py:174``)."""

    def __init__(self, *args, **kwargs):
        self._default = 1.0
        super().__init__(defaults=("_default",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        return bound(torch.zeros_like(value, dtype=torch_floatX()), value > 0)

    def logcdf(self, value, env=None, memo=None):
        return torch.where(value == torch.inf, 0.0, -torch.inf)

    def _random(self, point=None, size=None, gen=None):
        raise ValueError("Cannot sample from HalfFlat distribution")


class Normal(Continuous):
    r"""Univariate normal (cf. ``continuous.py:193``)."""

    def __init__(self, mu=0, sigma=None, tau=None, sd=None, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mean = self.median = self.mode = self.mu = _param(mu)
        self.variance = apply(lambda t: 1.0 / t, self.tau)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma)
        assert_negative_support(self.sigma, "sigma", "Normal")
        super().__init__(**kwargs)

    def logp(self, value, env=None, memo=None):
        mu, tau = self._ev_params(("mu", "tau"), env, memo)
        return bound((-tau * (value - mu) ** 2
                      + torch.log(tau / np.pi / 2.0)) / 2.0,
                     tau > 0)

    def logcdf(self, value, env=None, memo=None):
        mu, sigma = self._ev_params(("mu", "sigma"), env, memo)
        return normal_lcdf(mu, sigma, value)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_normal, ("mu", "sigma"), point, size, gen)


class TruncatedNormal(BoundedContinuous):
    r"""Truncated normal (cf. ``continuous.py:229``)."""

    def __init__(self, mu=0, sigma=None, tau=None, lower=None, upper=None,
                 sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mu = _param(mu)
        self.lower = None if lower is None else _param(lower)
        self.upper = None if upper is None else _param(upper)
        # the draws' window; an open side is infinite
        self._lo = self.lower if lower is not None else as_node(
            floatX(-np.inf))
        self._hi = self.upper if upper is not None else as_node(
            floatX(np.inf))
        # testval: mu clipped into the support
        lo = -np.inf if lower is None else np.asarray(self.lower.test_value)
        hi = np.inf if upper is None else np.asarray(self.upper.test_value)
        self.mean = self.median = self.mode = as_node(
            floatX(np.clip(np.asarray(self.mu.test_value), lo, hi)))
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(
                kwargs.pop("shape", None), self.mu, self.sigma,
                self.lower, self.upper)
        assert_negative_support(self.sigma, "sigma", "TruncatedNormal")
        super().__init__(lower=self.lower, upper=self.upper,
                         defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, sigma = self._ev_params(("mu", "sigma"), env, memo)
        norm_logp = -0.5 * ((value - mu) / sigma) ** 2 \
            - torch.log(sigma) - 0.5 * _LOG2PI
        # normalizer over the truncated interval
        if self.lower is not None and self.upper is not None:
            lower, upper = self._ev_params(("lower", "upper"), env, memo)
            lnorm = log_diff_normal_cdf(mu, sigma, upper, lower)
            in_bounds = (value >= lower) & (value <= upper)
        elif self.lower is not None:
            lower, = self._ev_params(("lower",), env, memo)
            lnorm = normal_lccdf(mu, sigma, lower)
            in_bounds = value >= lower
        elif self.upper is not None:
            upper, = self._ev_params(("upper",), env, memo)
            lnorm = normal_lcdf(mu, sigma, upper)
            in_bounds = value <= upper
        else:
            lnorm = 0.0
            in_bounds = True
        return bound(norm_logp - lnorm, in_bounds, sigma > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_truncnorm, ("mu", "sigma", "_lo", "_hi"),
                          point, size, gen)


class HalfNormal(PositiveContinuous):
    r"""Half-normal (cf. ``continuous.py:293``)."""

    def __init__(self, sigma=None, tau=None, sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mean = apply(lambda s: s * math.sqrt(2.0 / np.pi), self.sigma)
        self.variance = apply(lambda t: (1.0 - 2.0 / np.pi) / t, self.tau)
        self.mode = as_node(floatX(np.broadcast_to(
            1.0, np.shape(self.sigma.test_value))))
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.sigma)
        assert_negative_support(self.sigma, "sigma", "HalfNormal")
        super().__init__(defaults=("mode",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        tau, sigma = self._ev_params(("tau", "sigma"), env, memo)
        return bound(-0.5 * tau * value ** 2
                     + 0.5 * torch.log(tau * 2.0 / np.pi),
                     value >= 0, tau > 0, sigma > 0)

    def logcdf(self, value, env=None, memo=None):
        sigma, = self._ev_params(("sigma",), env, memo)
        z = value / sigma
        return bound(torch.log1p(-torch.special.erfc(z / math.sqrt(2.0))),
                     value >= 0, sigma > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_halfnormal, ("sigma",), point, size, gen)


class Wald(PositiveContinuous):
    r"""Inverse Gaussian (cf. ``continuous.py:332``)."""

    def __init__(self, mu=None, lam=None, phi=None, alpha=0.0, *args,
                 **kwargs):
        mu, lam, phi = self.get_mu_lam_phi(mu, lam, phi)
        self.alpha = _param(alpha)
        self.mu = _param(mu)
        self.lam = _param(lam)
        self.phi = _param(phi)
        self.mean = apply(lambda m, a: m + a, self.mu, self.alpha)
        self.mode = apply(
            lambda m, l, a: m * ((1.0 + (1.5 * m / l) ** 2) ** 0.5
                                 - 1.5 * m / l) + a,
            self.mu, self.lam, self.alpha)
        self.variance = apply(lambda m, l: m ** 3 / l, self.mu, self.lam)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.lam)
        assert_negative_support(self.mu, "mu", "Wald")
        assert_negative_support(self.lam, "lam", "Wald")
        super().__init__(defaults=("mean",), *args, **kwargs)

    @staticmethod
    def get_mu_lam_phi(mu, lam, phi):
        """cf. ``continuous.py:355``."""
        if mu is None:
            if lam is not None and phi is not None:
                return lam / phi, lam, phi
        else:
            if lam is None:
                if phi is None:
                    return mu, 1.0, 1.0 / mu
                return mu, mu * phi, phi
            if phi is None:
                return mu, lam, lam / mu
        raise ValueError(
            "Wald distribution must specify either mu only, mu and lam, "
            "mu and phi, or lam and phi.")

    def logp(self, value, env=None, memo=None):
        mu, lam, alpha = self._ev_params(("mu", "lam", "alpha"), env, memo)
        centered = value - alpha
        safe = torch.where(centered > 0, centered, 1.0)
        logp = (0.5 * torch.log(lam / (2.0 * np.pi))
                - 1.5 * torch.log(safe)
                - 0.5 * lam / safe * ((safe - mu) / mu) ** 2)
        return bound(logp, centered > 0, mu > 0, lam > 0, alpha >= 0)

    def logcdf(self, value, env=None, memo=None):
        """Inverse-Gaussian log CDF
        ``log[Phi(sqrt(lam/x)(x/mu - 1)) + e^(2 lam/mu) Phi(-sqrt(lam/x)(x/mu + 1))]``,
        the closed form the JAX package uses (cf. ``continuous.py:381``)."""
        mu, lam, alpha = self._ev_params(("mu", "lam", "alpha"), env, memo)
        x = value - alpha
        safe = torch.where(x > 0, x, 1.0)
        rt = torch.sqrt(lam / safe)
        a = normal_lcdf(0.0, 1.0, rt * (safe / mu - 1.0))
        b = 2.0 * lam / mu + normal_lcdf(0.0, 1.0, -rt * (safe / mu + 1.0))
        lcdf = torch.clamp(a + torch.log1p(torch.exp(b - a)), max=0.0)
        return bound(torch.where(x > 0, lcdf, -torch.inf),
                     mu > 0, lam > 0, alpha >= 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_wald, ("mu", "lam", "alpha"), point, size, gen)


class Beta(UnitContinuous):
    r"""Beta (cf. ``continuous.py:411``)."""

    def _host_dtype(self):
        # the JAX package's clipped_beta_rvs returns floatX
        return np.dtype(floatX())

    def __init__(self, alpha=None, beta=None, mu=None, sigma=None, sd=None,
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        alpha, beta = self.get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        self.mean = apply(lambda a, b: a / (a + b), self.alpha, self.beta)
        self.variance = apply(
            lambda a, b: a * b / ((a + b) ** 2 * (a + b + 1.0)),
            self.alpha, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.alpha, "alpha", "Beta")
        assert_negative_support(self.beta, "beta", "Beta")
        super().__init__(defaults=("mean",), *args, **kwargs)

    @staticmethod
    def get_alpha_beta(alpha=None, beta=None, mu=None, sigma=None):
        """cf. ``continuous.py:433``."""
        if alpha is not None and beta is not None:
            return alpha, beta
        if mu is not None and sigma is not None:
            kappa = mu * (1 - mu) / sigma ** 2 - 1
            return mu * kappa, (1 - mu) * kappa
        raise ValueError(
            "Incompatible parameterization. Either use alpha and beta, or mu "
            "and sigma to specify distribution.")

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        logval = torch.log(torch.where(value > 0, value, 1.0))
        log1mval = torch.log1p(-torch.where(value < 1, value, 0.0))
        logp = (alpha - 1.0) * logval + (beta - 1.0) * log1mval \
            - betaln(alpha, beta)
        return bound(logp, value >= 0, value <= 1, alpha > 0, beta > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        safe = torch.clamp(value, 0.0, 1.0)
        return torch.where(
            value <= 0, -torch.inf,
            torch.where(value >= 1, 0.0,
                        torch.log(betainc(alpha, beta, safe))))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_beta, ("alpha", "beta"), point, size, gen)


class Kumaraswamy(UnitContinuous):
    r"""Kumaraswamy (cf. ``continuous.py:470``)."""

    def __init__(self, a, b, *args, **kwargs):
        self.a = _param(a)
        self.b = _param(b)
        # mean = b * B(1 + 1/a, b)
        gl = torch.special.gammaln
        self.mean = apply(
            lambda a, b: torch.exp(torch.log(b) + gl(1 + 1 / a) + gl(b)
                                   - gl(1 + 1 / a + b)),
            self.a, self.b)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.a, self.b)
        assert_negative_support(self.a, "a", "Kumaraswamy")
        assert_negative_support(self.b, "b", "Kumaraswamy")
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        a, b = self._ev_params(("a", "b"), env, memo)
        safe = torch.clamp(value, 1e-30, 1.0)
        logp = torch.log(a) + torch.log(b) + (a - 1.0) * torch.log(safe) \
            + (b - 1.0) * torch.log1p(-safe ** a)
        return bound(logp, value >= 0, value <= 1, a > 0, b > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_kumaraswamy, ("a", "b"), point, size, gen)


class Exponential(PositiveContinuous):
    r"""Exponential (cf. ``continuous.py:505``)."""

    def __init__(self, lam, *args, **kwargs):
        self.lam = _param(lam)
        self.mean = apply(lambda l: 1.0 / l, self.lam)
        self.median = apply(lambda l: math.log(2.0) / l, self.lam)
        self.mode = as_node(floatX(np.zeros(np.shape(self.lam.test_value))))
        self.variance = apply(lambda l: l ** -2.0, self.lam)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.lam)
        assert_negative_support(self.lam, "lam", "Exponential")
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        lam, = self._ev_params(("lam",), env, memo)
        return bound(torch.log(lam) - lam * value, value >= 0, lam > 0)

    def logcdf(self, value, env=None, memo=None):
        lam, = self._ev_params(("lam",), env, memo)
        a = lam * value
        return torch.where(a <= 0, -torch.inf,
                           torch.log1p(-torch.exp(-torch.clamp(a, min=1e-30))))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_exponential, ("lam",), point, size, gen)


class Laplace(Continuous):
    r"""Laplace (cf. ``continuous.py:539``)."""

    def __init__(self, mu, b, *args, **kwargs):
        self.b = _param(b)
        self.mean = self.median = self.mode = self.mu = _param(mu)
        self.variance = apply(lambda b: 2.0 * b ** 2, self.b)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.b)
        assert_negative_support(self.b, "b", "Laplace")
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, b = self._ev_params(("mu", "b"), env, memo)
        return -torch.log(2.0 * b) - torch.abs(value - mu) / b

    def logcdf(self, value, env=None, memo=None):
        mu, b = self._ev_params(("mu", "b"), env, memo)
        y = (value - mu) / b
        return torch.where(y <= 0, math.log(0.5) + y,
                           torch.log1p(-0.5 * torch.exp(-torch.abs(y))))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_laplace, ("mu", "b"), point, size, gen)


class Lognormal(PositiveContinuous):
    r"""Log-normal (cf. ``continuous.py:572``)."""

    def __init__(self, mu=0, sigma=None, tau=None, sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mu = _param(mu)
        self.mean = apply(lambda m, t: torch.exp(m + 0.5 / t), self.mu,
                          self.tau)
        self.median = apply(torch.exp, self.mu)
        self.mode = apply(lambda m, t: torch.exp(m - 1.0 / t), self.mu,
                          self.tau)
        self.variance = apply(
            lambda m, t: (torch.exp(1.0 / t) - 1.0) * torch.exp(2 * m + 1.0 / t),
            self.mu, self.tau)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma)
        assert_negative_support(self.sigma, "sigma", "Lognormal")
        super().__init__(defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, tau = self._ev_params(("mu", "tau"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        logp = -0.5 * tau * (torch.log(safe) - mu) ** 2 \
            + 0.5 * torch.log(tau / (2.0 * np.pi)) - torch.log(safe)
        return bound(logp, value > 0, tau > 0)

    def logcdf(self, value, env=None, memo=None):
        mu, sigma = self._ev_params(("mu", "sigma"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        return torch.where(value > 0, normal_lcdf(mu, sigma, torch.log(safe)),
                           -torch.inf)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_lognormal, ("mu", "tau"), point, size, gen)


class StudentT(Continuous):
    r"""Student's t (cf. ``continuous.py:616``)."""

    def __init__(self, nu, mu=0, lam=None, sigma=None, sd=None, *args,
                 **kwargs):
        if sd is not None:
            sigma = sd
        self.nu = _param(nu)
        self.lam, self.sigma = get_tau_sigma(tau=lam, sigma=sigma)
        self.sd = self.sigma
        self.mean = self.median = self.mode = self.mu = _param(mu)
        self.variance = apply(
            lambda nu, lam: torch.where(
                nu > 2, nu / torch.where(nu > 2, nu - 2.0, 1.0) / lam,
                torch.inf),
            self.nu, self.lam)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma, self.nu)
        assert_negative_support(self.lam, "lam (sigma)", "StudentT")
        assert_negative_support(self.nu, "nu", "StudentT")
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        nu, mu, lam, sigma = self._ev_params(("nu", "mu", "lam", "sigma"),
                                             env, memo)
        gl = torch.special.gammaln
        logp = (gl((nu + 1.0) / 2.0)
                + 0.5 * torch.log(lam / (nu * np.pi))
                - gl(nu / 2.0)
                - (nu + 1.0) / 2.0 * torch.log1p(lam * (value - mu) ** 2 / nu))
        return bound(logp, lam > 0, nu > 0, sigma > 0)

    def logcdf(self, value, env=None, memo=None):
        nu, mu, sigma = self._ev_params(("nu", "mu", "sigma"), env, memo)
        t = (value - mu) / sigma
        sq = nu / (nu + t ** 2)
        it = 0.5 * betainc(nu / 2.0, torch.full_like(nu, 0.5), sq)
        return torch.log(torch.where(t >= 0, 1.0 - it, it))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_studentt, ("nu", "mu", "lam"), point, size, gen)


class Pareto(Continuous):
    r"""Pareto (cf. ``continuous.py:666``)."""

    def __init__(self, alpha, m, transform="lowerbound", *args, **kwargs):
        self.alpha = _param(alpha)
        self.m = _param(m)
        self.mean = apply(
            # double where: alpha == 1 never divides by zero
            lambda a, m: torch.where(a > 1,
                                     a * m / torch.where(a > 1, a - 1.0, 1.0),
                                     torch.inf),
            self.alpha, self.m)
        self.median = apply(lambda a, m: m * 2.0 ** (1.0 / a),
                            self.alpha, self.m)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.m)
        assert_negative_support(self.alpha, "alpha", "Pareto")
        assert_negative_support(self.m, "m", "Pareto")
        if transform == "lowerbound":
            transform = transforms.lowerbound(self.m)
        super().__init__(transform=transform, defaults=("median",),
                         *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        alpha, m = self._ev_params(("alpha", "m"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        logp = torch.log(alpha) + logpow(m, alpha) \
            - (alpha + 1.0) * torch.log(safe)
        return bound(logp, value >= m, alpha > 0, m > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, m = self._ev_params(("alpha", "m"), env, memo)
        arg = (m / torch.where(value > 0, value, 1.0)) ** alpha
        return torch.where(value < m, -torch.inf,
                           torch.where(arg > 1e-5, torch.log1p(-arg), -arg))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_pareto, ("alpha", "m"), point, size, gen)


class Cauchy(Continuous):
    r"""Cauchy (cf. ``continuous.py:712``)."""

    def __init__(self, alpha, beta, *args, **kwargs):
        self.median = self.mode = self.alpha = _param(alpha)
        self.beta = _param(beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.beta, "beta", "Cauchy")
        super().__init__(defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        return bound(-math.log(np.pi) - torch.log(beta)
                     - torch.log1p(((value - alpha) / beta) ** 2), beta > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        return torch.log(0.5 + torch.atan((value - alpha) / beta) / np.pi)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_cauchy, ("alpha", "beta"), point, size, gen)


class HalfCauchy(PositiveContinuous):
    r"""Half-Cauchy (cf. ``continuous.py:744``)."""

    def __init__(self, beta, *args, **kwargs):
        self.median = self.beta = _param(beta)
        self.mode = as_node(floatX(np.zeros(np.shape(self.beta.test_value))))
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.beta)
        assert_negative_support(self.beta, "beta", "HalfCauchy")
        super().__init__(defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        beta, = self._ev_params(("beta",), env, memo)
        return bound(math.log(2.0) - math.log(np.pi) - torch.log(beta)
                     - torch.log1p((value / beta) ** 2),
                     value >= 0, beta > 0)

    def logcdf(self, value, env=None, memo=None):
        beta, = self._ev_params(("beta",), env, memo)
        return bound(torch.log(2.0 * torch.atan(value / beta) / np.pi),
                     value >= 0, beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_halfcauchy, ("beta",), point, size, gen)


class Gamma(PositiveContinuous):
    r"""Gamma (cf. ``continuous.py:778``)."""

    def __init__(self, alpha=None, beta=None, mu=None, sigma=None, sd=None,
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        alpha, beta = self.get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        self.mean = apply(lambda a, b: a / b, self.alpha, self.beta)
        self.mode = apply(lambda a, b: torch.clamp((a - 1.0) / b, min=0.0),
                          self.alpha, self.beta)
        self.variance = apply(lambda a, b: a / b ** 2, self.alpha, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.alpha, "alpha", "Gamma")
        assert_negative_support(self.beta, "beta", "Gamma")
        super().__init__(defaults=("mean",), *args, **kwargs)

    @staticmethod
    def get_alpha_beta(alpha=None, beta=None, mu=None, sigma=None):
        """cf. ``continuous.py:800``."""
        if alpha is not None and beta is not None:
            return alpha, beta
        if mu is not None and sigma is not None:
            return (mu / sigma) ** 2, mu / sigma ** 2
        raise ValueError(
            "Incompatible parameterization. Either use alpha and beta, or mu "
            "and sigma to specify distribution.")

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        logp = (-torch.special.gammaln(alpha) + logpow(beta, alpha)
                - beta * value + logpow(value, alpha - 1.0))
        return bound(logp, value >= 0, alpha > 0, beta > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        return bound(torch.log(gammainc(alpha, beta * safe)),
                     value >= 0, alpha > 0, beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_gamma, ("alpha", "beta"), point, size, gen)


class InverseGamma(PositiveContinuous):
    r"""Inverse gamma (cf. ``continuous.py:834``)."""

    def __init__(self, alpha=None, beta=None, mu=None, sigma=None, sd=None,
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        alpha, beta = self._get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        self.mean = apply(
            lambda a, b: torch.where(
                a > 1, b / torch.where(a > 1, a - 1.0, 1.0), torch.inf),
            self.alpha, self.beta)
        self.mode = apply(lambda a, b: b / (a + 1.0), self.alpha, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.alpha, "alpha", "InverseGamma")
        assert_negative_support(self.beta, "beta", "InverseGamma")
        super().__init__(defaults=("mode",), *args, **kwargs)

    @classmethod
    def _get_alpha_beta(cls, alpha, beta, mu, sigma):
        """cf. ``continuous.py:857``."""
        if alpha is not None:
            if beta is None:
                beta = 1.0
        elif mu is not None and sigma is not None:
            alpha = (2 * sigma ** 2 + mu ** 2) / sigma ** 2
            beta = mu * (mu ** 2 + sigma ** 2) / sigma ** 2
        else:
            raise ValueError(
                "Incompatible parameterization. Either use alpha and "
                "(optionally) beta, or mu and sigma to specify distribution.")
        return alpha, beta

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        logp = (logpow(beta, alpha) - torch.special.gammaln(alpha)
                - beta / safe + logpow(safe, -alpha - 1.0))
        return bound(logp, value > 0, alpha > 0, beta > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        return bound(torch.log(gammaincc(alpha, beta / safe)),
                     value > 0, alpha > 0, beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_inversegamma, ("alpha", "beta"), point, size,
                          gen)


class ChiSquared(Gamma):
    r"""Chi-squared: Gamma(nu/2, 1/2) (cf. ``continuous.py:895``)."""

    def __init__(self, nu, *args, **kwargs):
        self.nu = _param(nu)
        super().__init__(alpha=apply(lambda n: n / 2.0, self.nu),
                         beta=floatX(0.5), *args, **kwargs)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_chisquared, ("nu",), point, size, gen)


class Weibull(PositiveContinuous):
    r"""Weibull (cf. ``continuous.py:910``)."""

    def __init__(self, alpha, beta, *args, **kwargs):
        self.alpha = _param(alpha)
        self.beta = _param(beta)
        self.mean = apply(
            lambda a, b: b * torch.exp(torch.special.gammaln(1.0 + 1.0 / a)),
            self.alpha, self.beta)
        self.median = apply(lambda a, b: b * math.log(2.0) ** (1.0 / a),
                            self.alpha, self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.alpha, self.beta)
        assert_negative_support(self.alpha, "alpha", "Weibull")
        assert_negative_support(self.beta, "beta", "Weibull")
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        safe = torch.where(value > 0, value, 1.0)
        logp = (torch.log(alpha) - torch.log(beta)
                + (alpha - 1.0) * torch.log(safe / beta)
                - (safe / beta) ** alpha)
        return bound(logp, value >= 0, alpha > 0, beta > 0)

    def logcdf(self, value, env=None, memo=None):
        alpha, beta = self._ev_params(("alpha", "beta"), env, memo)
        a = (torch.where(value > 0, value, 1.0) / beta) ** alpha
        return bound(torch.log1p(-torch.exp(-a)), value >= 0, alpha > 0,
                     beta > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_weibull, ("alpha", "beta"), point, size, gen)


class HalfStudentT(PositiveContinuous):
    r"""Half Student's t (cf. ``continuous.py:952``)."""

    def __init__(self, nu=1, sigma=None, lam=None, sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.mode = as_node(floatX(0.0))
        self.lam, self.sigma = get_tau_sigma(lam, sigma)
        self.sd = self.sigma
        self.median = apply(lambda s: s, self.sigma)
        self.nu = _param(nu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.sigma, self.nu)
        assert_negative_support(self.sigma, "sigma", "HalfStudentT")
        assert_negative_support(self.nu, "nu", "HalfStudentT")
        super().__init__(defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        nu, sigma, lam = self._ev_params(("nu", "sigma", "lam"), env, memo)
        gl = torch.special.gammaln
        logp = (math.log(2.0) + gl((nu + 1.0) / 2.0)
                - gl(nu / 2.0)
                - 0.5 * torch.log(nu * np.pi * sigma ** 2)
                - (nu + 1.0) / 2.0 * torch.log1p(value ** 2 / (nu * sigma ** 2)))
        return bound(logp, value >= 0, nu > 0, sigma > 0, lam > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_halfstudentt, ("nu", "sigma"), point, size, gen)


class ExGaussian(Continuous):
    r"""Exponentially modified Gaussian (cf. ``continuous.py:987``)."""

    def __init__(self, mu=0.0, sigma=None, nu=None, sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.mu = _param(mu)
        self.sigma = self.sd = _param(sigma)
        self.nu = _param(nu)
        self.mean = apply(lambda m, n: m + n, self.mu, self.nu)
        self.variance = apply(lambda s, n: s ** 2 + n ** 2, self.sigma,
                              self.nu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma, self.nu)
        assert_negative_support(self.sigma, "sigma", "ExGaussian")
        assert_negative_support(self.nu, "nu", "ExGaussian")
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, sigma, nu = self._ev_params(("mu", "sigma", "nu"), env, memo)
        # -log nu + (mu - v)/nu + sigma^2/(2 nu^2) + log Phi((v - mu)/sigma - sigma/nu)
        logp = (-torch.log(nu) + (mu - value) / nu
                + 0.5 * (sigma / nu) ** 2
                + normal_lcdf(mu + (sigma ** 2) / nu, sigma, value))
        return bound(logp, sigma > 0, nu > 0)

    def logcdf(self, value, env=None, memo=None):
        mu, sigma, nu = self._ev_params(("mu", "sigma", "nu"), env, memo)
        z = (value - mu) / sigma
        exp_arg = (sigma / nu) ** 2 / 2.0 - (value - mu) / nu \
            + normal_lcdf(mu + (sigma ** 2) / nu, sigma, value)
        return torch.log(torch.special.ndtr(z) - torch.exp(exp_arg))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_exgaussian, ("mu", "sigma", "nu"), point, size,
                          gen)


class VonMises(Continuous):
    r"""Von Mises, circular (cf. ``continuous.py:1033``)."""

    def __init__(self, mu=0.0, kappa=None, transform="circular",
                 *args, **kwargs):
        if transform == "circular":
            transform = transforms.Circular()
        self.mean = self.median = self.mode = self.mu = _param(mu)
        self.kappa = _param(kappa)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.kappa)
        assert_negative_support(self.kappa, "kappa", "VonMises")
        super().__init__(transform=transform, defaults=("mean",),
                         *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, kappa = self._ev_params(("mu", "kappa"), env, memo)
        return bound(kappa * torch.cos(mu - value) - _LOG2PI - log_i0(kappa),
                     kappa > 0, value >= -np.pi, value <= np.pi)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_vonmises, ("mu", "kappa"), point, size, gen)


class SkewNormal(Continuous):
    r"""Skew-normal (cf. ``continuous.py:1064``)."""

    def __init__(self, mu=0.0, sigma=None, tau=None, alpha=1, sd=None,
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.mu = _param(mu)
        self.alpha = _param(alpha)
        self.mean = apply(
            lambda m, s, a: m + s * (2.0 / np.pi) ** 0.5 * a
            / (1.0 + a ** 2) ** 0.5,
            self.mu, self.sigma, self.alpha)
        self.variance = apply(
            lambda s, a: s ** 2 * (1.0 - (2.0 * a ** 2)
                                   / ((1.0 + a ** 2) * np.pi)),
            self.sigma, self.alpha)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma,
                                                self.alpha)
        assert_negative_support(self.tau, "tau", "SkewNormal")
        assert_negative_support(self.sigma, "sigma", "SkewNormal")
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, sigma, tau, alpha = self._ev_params(
            ("mu", "sigma", "tau", "alpha"), env, memo)
        # log(2 Phi(alpha z)) through log_ndtr, stable far into the tail
        return bound(
            math.log(2.0)
            + torch.special.log_ndtr(alpha * (value - mu) * tau ** 0.5)
            + (-tau * (value - mu) ** 2 + torch.log(tau / np.pi / 2.0)) / 2.0,
            tau > 0, sigma > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_skewnormal, ("mu", "sigma", "alpha"), point,
                          size, gen)


class Triangular(BoundedContinuous):
    r"""Triangular (cf. ``continuous.py:1110``)."""

    def __init__(self, lower=0, upper=1, c=0.5, *args, **kwargs):
        self.median = self.mean = self.c = _param(c)
        self.lower = _param(lower)
        self.upper = _param(upper)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(
                kwargs.pop("shape", None), self.c, self.lower, self.upper)
        super().__init__(lower=self.lower, upper=self.upper,
                         defaults=("median",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        c, lower, upper = self._ev_params(("c", "lower", "upper"), env, memo)
        safe_l = torch.where(value < c, value, lower)
        safe_u = torch.where(value >= c, value, upper)
        return torch.where(
            value < lower, -torch.inf,
            torch.where(value < c,
                        torch.log(2.0 * (safe_l - lower)
                                  / ((upper - lower) * (c - lower))),
                        torch.where(value == c,
                                    torch.log(2.0 / (upper - lower)),
                                    torch.where(value <= upper,
                                                torch.log(
                                                    2.0 * (upper - safe_u)
                                                    / ((upper - lower)
                                                       * (upper - c))),
                                                -torch.inf))))

    def logcdf(self, value, env=None, memo=None):
        c, lower, upper = self._ev_params(("c", "lower", "upper"), env, memo)
        return torch.where(
            value < lower, -torch.inf,
            torch.where(value <= c,
                        torch.log(((value - lower) ** 2)
                                  / ((upper - lower) * (c - lower))),
                        torch.where(value < upper,
                                    torch.log1p(-((upper - value) ** 2)
                                                / ((upper - lower)
                                                   * (upper - c))),
                                    0.0)))

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_triangular, ("c", "lower", "upper"), point,
                          size, gen)


class Gumbel(Continuous):
    r"""Gumbel (cf. ``continuous.py:1164``)."""

    def __init__(self, mu=0, beta=1.0, **kwargs):
        self.mu = _param(mu)
        self.beta = _param(beta)
        self.mean = apply(lambda m, b: m + b * np.euler_gamma, self.mu,
                          self.beta)
        self.median = apply(lambda m, b: m - b * math.log(math.log(2.0)),
                            self.mu, self.beta)
        self.mode = self.mu
        self.variance = apply(lambda b: (np.pi ** 2 / 6.0) * b ** 2,
                              self.beta)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.beta)
        assert_negative_support(self.beta, "beta", "Gumbel")
        super().__init__(defaults=("mean",), **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, beta = self._ev_params(("mu", "beta"), env, memo)
        z = (value - mu) / beta
        return bound(-z - torch.exp(-z) - torch.log(beta), beta > 0)

    def logcdf(self, value, env=None, memo=None):
        mu, beta = self._ev_params(("mu", "beta"), env, memo)
        return -torch.exp(-(value - mu) / beta)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_gumbel, ("mu", "beta"), point, size, gen)


def _laguerre_half(x):
    """L_{1/2}(x) of the Rice mean (cf. ``continuous.py:1252``)."""
    return torch.exp(x / 2.0) * ((1.0 - x) * torch.special.i0e(-x / 2.0)
                                 - x * torch.special.i1e(-x / 2.0))


class Rice(PositiveContinuous):
    r"""Rice (cf. ``continuous.py:1199``)."""

    def __init__(self, nu=None, sigma=None, b=None, sd=None, *args, **kwargs):
        if sd is not None:
            sigma = sd
        nu, b, sigma = self.get_nu_b(nu, b, sigma)
        self.nu = _param(nu)
        self.sigma = self.sd = _param(sigma)
        self.b = _param(b)
        self.mean = apply(
            lambda nu, sigma: sigma * math.sqrt(np.pi / 2.0)
            * _laguerre_half(-nu ** 2 / (2 * sigma ** 2)),
            self.nu, self.sigma)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.nu, self.sigma)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def get_nu_b(self, nu, b, sigma):
        """cf. ``continuous.py:1219``."""
        if sigma is None:
            sigma = 1.0
        if nu is None and b is not None:
            nu = b * sigma
            return nu, b, sigma
        elif nu is not None and b is None:
            if isinstance(nu, Node) or isinstance(sigma, Node):
                b = apply(lambda n, s: n / s, _param(nu), _param(sigma))
            else:
                b = np.asarray(nu) / np.asarray(sigma)
            return nu, b, sigma
        raise ValueError("Rice distribution must specify either nu or b.")

    def logp(self, value, env=None, memo=None):
        nu, sigma, b = self._ev_params(("nu", "sigma", "b"), env, memo)
        x = value / sigma
        safe_x = torch.where(value > 0, x, 1.0)
        logp = (torch.log(safe_x) - torch.log(sigma)
                - (safe_x ** 2 + b ** 2) / 2.0
                + log_i0(safe_x * b))
        return bound(logp, value >= 0, sigma > 0, nu >= 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_rice, ("nu", "sigma"), point, size, gen)


class Logistic(Continuous):
    r"""Logistic (cf. ``continuous.py:1258``)."""

    def __init__(self, mu=0.0, s=1.0, *args, **kwargs):
        self.mu = _param(mu)
        self.s = _param(s)
        self.mean = self.mode = self.mu
        self.variance = apply(lambda s: (s * np.pi) ** 2 / 3.0, self.s)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.s)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, s = self._ev_params(("mu", "s"), env, memo)
        z = (value - mu) / s
        return bound(-z - torch.log(s) - 2.0 * F.softplus(-z), s > 0)

    def logcdf(self, value, env=None, memo=None):
        mu, s = self._ev_params(("mu", "s"), env, memo)
        return -F.softplus(-(value - mu) / s)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_logistic, ("mu", "s"), point, size, gen)


class LogitNormal(UnitContinuous):
    r"""Logit-normal (cf. ``continuous.py:1289``)."""

    def __init__(self, mu=0, sigma=None, tau=None, sd=None, **kwargs):
        if sd is not None:
            sigma = sd
        self.mu = _param(mu)
        self.tau, self.sigma = get_tau_sigma(tau=tau, sigma=sigma)
        self.sd = self.sigma
        self.median = apply(torch.sigmoid, self.mu)
        if kwargs.get("shape") is None:
            kwargs["shape"] = self._infer_shape(kwargs.pop("shape", None),
                                                self.mu, self.sigma)
        assert_negative_support(self.sigma, "sigma", "LogitNormal")
        super().__init__(defaults=("median",), **kwargs)

    def logp(self, value, env=None, memo=None):
        mu, tau = self._ev_params(("mu", "tau"), env, memo)
        safe = torch.clamp(value, 1e-12, 1.0 - 1e-12)
        lv = torch.special.logit(safe)
        logp = (-0.5 * tau * (lv - mu) ** 2
                + 0.5 * torch.log(tau / (2.0 * np.pi))
                - torch.log(safe * (1.0 - safe)))
        return bound(logp, value > 0, value < 1, tau > 0)

    def _random(self, point=None, size=None, gen=None):
        return self._draw(_r_logitnormal, ("mu", "tau"), point, size, gen)


class Interpolated(BoundedContinuous):
    r"""Density interpolated from tabulated (x, pdf) points
    (cf. ``continuous.py:1324``).

    The normalizer and the CDF grid come from a scipy spline on the host,
    once; the logp is a tensor linear interpolation of the normalized pdf,
    differentiable in ``value``, and draws invert the CDF grid the same way.
    """

    def __init__(self, x_points, pdf_points, *args, **kwargs):
        self.lower = lower = floatX(np.min(x_points))
        self.upper = upper = floatX(np.max(x_points))
        import scipy.interpolate  # host-side, once per distribution
        x = np.asarray(x_points, dtype=float)
        p = np.asarray(pdf_points, dtype=float)
        spline = scipy.interpolate.InterpolatedUnivariateSpline(
            x, p, k=1, ext="zeros")
        Z = spline.integral(x[0], x[-1])
        self.x_points = floatX(x)
        self.pdf_points = floatX(p / Z)
        self._spline = spline
        self._Z = Z
        # cdf grid for inverse-cdf draws
        cdf = np.array([spline.integral(x[0], xi) for xi in x]) / Z
        self.cdf_points = cdf
        self.median = floatX(np.interp(0.5, cdf, x))
        self._x = as_node(self.x_points)
        self._pdf = as_node(self.pdf_points)
        self._cdf = as_node(floatX(cdf))
        super().__init__(lower=lower, upper=upper, defaults=("median",),
                         *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        xp, fp = self._ev_params(("_x", "_pdf"), env, memo)
        return torch.log(interp(value, xp, fp))

    def _random(self, point=None, size=None, gen=None):
        gen = self._generator(gen)
        cdf, xp = self._cdf.value, self._x.value
        shape = tuple(np.atleast_1d(size)) if size is not None else ()
        shape = shape + tuple(self.shape)
        return interp(rand_uniform(gen, shape), cdf.to(gen.device),
                      xp.to(gen.device))
