"""Numeric helpers for log-densities (cf. ``pymc3_tpu/distributions/dist_math.py``).

Tensor functions that batch under ``torch.func.vmap``: no data-dependent
Python control flow. Three pieces have no torch counterpart of the XLA
intrinsic the JAX package calls:

- ``incomplete_beta``: torch has no ``betainc``. The port evaluates the
  regularized incomplete beta by its continued fraction (modified Lentz,
  Numerical Recipes 6.4) with a fixed trip count in float64, inside an
  ``autograd.Function`` whose gradient in ``x`` is the Beta density;
- ``gammainc`` / ``gammaincc``: torch's own cannot be differentiated in the
  shape ``a``. The port evaluates the regularized incomplete gamma by its
  series (x < a + 1) or its continued fraction (otherwise) with fixed trip
  counts in float64; the gradient in ``x`` is the Gamma density and the
  gradient in ``a`` differentiates the series or the fraction term by term;
- ``interp``: ``jnp.interp``'s clamped linear interpolation, through
  ``torch.searchsorted``.

The random-draw helpers take an explicit ``torch.Generator``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import floatX, torch_floatX
from ..node import current_device

__all__ = [
    "bound", "alltrue_elemwise", "alltrue_scalar", "logpow", "factln",
    "betaln", "binomln", "std_cdf", "normal_lcdf", "normal_lccdf",
    "log_diff_normal_cdf", "sigma2rho", "rho2sigma", "log_normal",
    "SplineWrapper", "i0e", "i1e", "incomplete_beta", "betainc",
    "gammainc", "gammaincc",
    "random_choice", "zvalue", "clipped_beta_rvs", "interp",
    "MvNormal_logp",
]


def _as_cond(c, like):
    if isinstance(c, torch.Tensor):
        return c
    return torch.as_tensor(bool(c), device=like.device)


def alltrue_elemwise(conditions):
    """Elementwise AND over boolean tensors (broadcasting); ``None`` when
    every condition is the constant ``True``."""
    ret = None
    for c in conditions:
        if c is True:
            continue
        ret = c if ret is None else ret & c
    return ret


def alltrue_scalar(conditions):
    return torch.stack([torch.all(c) for c in conditions]).all()


def bound(logp, *conditions, broadcast_conditions=True):
    """``logp`` where all conditions hold, ``-inf`` elsewhere
    (cf. ``pymc3/dist_math.py:38``). With ``broadcast_conditions=False``
    the conditions reduce to one scalar gate (multivariate logps)."""
    if broadcast_conditions:
        cond = alltrue_elemwise(conditions)
        if cond is None:
            return logp
    else:
        cond = alltrue_scalar([_as_cond(c, logp) for c in conditions])
    return torch.where(_as_cond(cond, logp), logp, -torch.inf)


def logpow(x, m):
    """Safe ``m * log(x)`` with ``0**0 = 1`` (cf. ``dist_math.py:78``)."""
    zero = x == 0
    inner = torch.where(m == 0, 0.0, -torch.inf)
    return torch.where(zero, inner,
                       m * torch.log(torch.where(zero, 1.0, x)))


def factln(n):
    return torch.special.gammaln(n + 1.0)


def betaln(x, y):
    gl = torch.special.gammaln
    return gl(x) + gl(y) - gl(x + y)


def binomln(n, k):
    return factln(n) - factln(k) - factln(n - k)


def std_cdf(x):
    """Standard normal CDF (cf. ``dist_math.py:98``)."""
    return torch.special.ndtr(x)


def zvalue(value, mu=0.0, sigma=1.0):
    return (value - mu) / sigma


def log_ndtr(z):
    """log Phi(z), stable in both tails, from operations that
    ``torch.func.vmap`` batches and that run as the card's built-in kernels:
    ``log1p(-erfc(z/√2) / 2)`` above 0, ``log(erfc(-z/√2) / 2)`` down to
    ``-T``, and below it the asymptotic series ``-z²/2 - log(-z) -
    log(2π)/2 + log1p(Σ_k (-1)^k (2k-1)!! / z^2k)`` (six terms; T = 10 in
    float32, 20 in float64, where erfc is still normal and the series'
    first omitted term is below the dtype's rounding). The same function as
    ``torch.special.log_ndtr``, which has no batching rule (under ``vmap``
    it runs once per lane) and, like ``erfcx``, is compiled at run time on
    the card at its first call. Each branch sees only its own part of the
    line, so the others' gradients stay finite."""
    t = 20.0 if z.dtype == torch.float64 else 10.0
    lo = torch.clamp(z, max=-t)
    mid = torch.clamp(z, min=-t, max=0.0)
    hi = torch.clamp(z, min=0.0)
    inv = 1.0 / (lo * lo)
    series, term = torch.zeros_like(lo), torch.ones_like(lo)
    for k in range(1, 7):
        term = term * (-(2 * k - 1)) * inv
        series = series + term
    tail = -0.5 * lo * lo - torch.log(-lo) - _HALF_LOG_2PI \
        + torch.log1p(series)
    left = torch.log(0.5 * torch.erfc(-mid * _SQRT1_2))
    right = torch.log1p(-0.5 * torch.erfc(hi * _SQRT1_2))
    return torch.where(z < -t, tail, torch.where(z < 0, left, right))


_SQRT1_2 = 0.7071067811865476
_HALF_LOG_2PI = 0.9189385332046727


def normal_lcdf(mu, sigma, x):
    """log Phi((x - mu) / sigma), stable in both tails (cf. ``dist_math.py:105``)."""
    return log_ndtr((x - mu) / sigma)


def normal_lccdf(mu, sigma, x):
    """log(1 - Phi((x - mu) / sigma)) (cf. ``dist_math.py:114``)."""
    return log_ndtr(-(x - mu) / sigma)


def _logdiffexp(a, b):
    return a + torch.log1p(-torch.exp(torch.clamp(b - a, max=-1e-12)))


def log_diff_normal_cdf(mu, sigma, x, y):
    """log(Phi((x - mu)/s) - Phi((y - mu)/s)) for x > y
    (cf. ``dist_math.py:124``): the right tail goes through lccdf."""
    x_z = (x - mu) / sigma
    y_z = (y - mu) / sigma
    return torch.where(
        (x_z > 0) & (y_z > 0),
        _logdiffexp(normal_lccdf(mu, sigma, y), normal_lccdf(mu, sigma, x)),
        _logdiffexp(normal_lcdf(mu, sigma, x), normal_lcdf(mu, sigma, y)))


def sigma2rho(sigma):
    """sigma -> softplus-inverse rho (cf. ``dist_math.py:155``)."""
    return torch.log(torch.expm1(torch.abs(sigma)))


def rho2sigma(rho):
    """rho -> softplus sigma (cf. ``dist_math.py:164``)."""
    return F.softplus(rho)


rho2sd = rho2sigma
sd2rho = sigma2rho


def log_normal(x, mean, **kwargs):
    """Normal log-density by sd, tau, w or rho (cf. ``dist_math.py:140``)."""
    sigma = kwargs.get("sigma", kwargs.get("sd"))
    w = kwargs.get("w")
    rho = kwargs.get("rho")
    tau = kwargs.get("tau")
    eps = kwargs.get("eps", 0.0)
    check = sum(v is not None for v in [sigma, w, rho, tau])
    if check > 1:
        raise ValueError("more than one required kwarg is passed")
    if check == 0:
        raise ValueError("none of required kwarg is passed")
    if sigma is not None:
        std = sigma
    elif w is not None:
        std = torch.exp(w)
    elif rho is not None:
        std = rho2sigma(rho)
    else:
        std = tau ** (-0.5)
    std = std + eps
    return -0.5 * ((x - mean) / std) ** 2 - torch.log(std) \
        - 0.5 * np.log(2.0 * np.pi)


def interp(x, xp, fp):
    """Piecewise-linear interpolation of ``fp`` over increasing ``xp``,
    clamped to the end values outside the grid (``jnp.interp``)."""
    n = xp.shape[-1]
    i = torch.searchsorted(xp, x.detach().contiguous()).clamp(1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    y = f0 + (x - x0) / (x1 - x0) * (f1 - f0)
    return torch.where(x < xp[0], fp[0], torch.where(x > xp[-1], fp[-1], y))


class SplineWrapper:
    """A fixed scipy spline as a differentiable tensor function.

    The spline is sampled densely once, on the host, when the wrapper is
    made (cf. ``dist_math.py:251``); calls interpolate that grid on the
    argument's device.
    """

    def __init__(self, spline, x_lo=None, x_hi=None, n=4096):
        self.spline = spline
        knots = getattr(spline, "get_knots", lambda: None)()
        if x_lo is None:
            x_lo = float(knots[0]) if knots is not None else 0.0
        if x_hi is None:
            x_hi = float(knots[-1]) if knots is not None else 1.0
        grid = np.linspace(x_lo, x_hi, n)
        self.x_grid = floatX(grid)
        self.y_grid = floatX(np.asarray(spline(grid)))
        self._on = {}

    def __call__(self, x):
        if x.device not in self._on:
            self._on[x.device] = (
                torch.as_tensor(self.x_grid, device=x.device),
                torch.as_tensor(self.y_grid, device=x.device))
        xp, fp = self._on[x.device]
        return interp(x, xp, fp)


def i0e(x):
    """Exponentially scaled modified Bessel I0 (cf. ``dist_math.py:288``)."""
    return torch.special.i0e(x)


def i1e(x):
    return torch.special.i1e(x)


# -- regularized incomplete beta --------------------------------------------
# Trip count of the continued fraction. Each trip is two of its terms; it
# converges in O(sqrt(max(a, b))) trips, so 200 carries float64 precision
# well past the parameters any model here uses (a, b up to ~1e4).
_BETAINC_TRIPS = 200
_TINY = 1e-300


def _betacf(a, b, x):
    """Continued fraction of I_x(a, b), modified Lentz, fixed trip count."""
    qab, qap, qam = a + b, a + 1.0, a - 1.0

    def fix(v):
        return torch.where(torch.abs(v) < _TINY, _TINY, v)

    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - qab * x / qap)
    h = d
    for m in range(1, _BETAINC_TRIPS + 1):
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        d = 1.0 / fix(1.0 + aa * d)
        c = fix(1.0 + aa / c)
        h = h * d * c
    return h


def _betainc_f64(a, b, x):
    """I_x(a, b) in float64 for broadcast tensors."""
    inside = (x > 0) & (x < 1)
    xs = torch.where(inside, x, 0.5)
    # the fraction converges fast for x < (a + 1) / (a + b + 2); past it,
    # use I_x(a, b) = 1 - I_{1-x}(b, a)
    swap = xs >= (a + 1.0) / (a + b + 2.0)
    a2 = torch.where(swap, b, a)
    b2 = torch.where(swap, a, b)
    x2 = torch.where(swap, 1.0 - xs, xs)
    log_front = (a2 * torch.log(x2) + b2 * torch.log1p(-x2)
                 - betaln(a2, b2))
    part = torch.exp(log_front) * _betacf(a2, b2, x2) / a2
    val = torch.where(swap, 1.0 - part, part)
    return torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, val))


class _BetaInc(torch.autograd.Function):
    """Regularized incomplete beta with its gradient in ``x`` (the Beta
    density). Its derivative in ``a`` and ``b`` is not implemented and
    raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, x):
        a64, b64, x64 = torch.broadcast_tensors(a.double(), b.double(),
                                                x.double())
        return _betainc_f64(a64, b64, x64).to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, grad):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "the derivative of the incomplete beta in its shape "
                "parameters a, b is not implemented")
        inside = (x > 0) & (x < 1)
        xs = torch.where(inside, x, 0.5)
        dens = torch.exp((a - 1.0) * torch.log(xs)
                         + (b - 1.0) * torch.log1p(-xs) - betaln(a, b))
        gx = grad * torch.where(inside, dens, 0.0)
        return None, None, _sum_to(gx, x.shape)


def _sum_to(g, shape):
    """Reduce a broadcast gradient back to ``shape``."""
    while g.ndim > len(shape):
        g = g.sum(0)
    for i, s in enumerate(shape):
        if s == 1 and g.shape[i] != 1:
            g = g.sum(i, keepdim=True)
    return g


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b) on tensors."""
    x = torch.as_tensor(x)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return _BetaInc.apply(a, b, x)


def incomplete_beta(a, b, value):
    """Regularized incomplete beta I_x(a, b) (cf. ``dist_math.py:216``)."""
    return betainc(a, b, value)


# -- regularized incomplete gamma ---------------------------------------------
# Trip count of the series and of the continued fraction. Both need
# O(sqrt(a)) trips near x = a, their slowest point: 300 carry float64
# precision up to a of about 1000 (n^2 / (2 a) > 37 at n = 300).
_GAMMAINC_TRIPS = 300


def _gamma_series(a, x, want_da):
    """P(a, x) / F and its a-derivative, F = exp(a ln x - x - lgamma(a + 1)):
    S = sum_n c_n, c_0 = 1, c_n = c_{n-1} x / (a + n)."""
    c = torch.ones_like(x)
    s = torch.ones_like(x)
    dc = torch.zeros_like(x)
    ds = torch.zeros_like(x)
    for n in range(1, _GAMMAINC_TRIPS + 1):
        r = x / (a + n)
        c_new = c * r
        if want_da:
            dc = dc * r - c_new / (a + n)
            ds = ds + dc
        c = c_new
        s = s + c
    return s, ds


def _gamma_fraction(a, x, want_da):
    """Q(a, x) / G and its a-derivative, G = exp(a ln x - x - lgamma(a)):
    modified Lentz (Numerical Recipes 6.2) with every recurrence carried
    together with its derivative in a."""
    def fix(v):
        return torch.where(torch.abs(v) < _TINY, _TINY, v)

    b = x + 1.0 - a
    c = torch.full_like(x, 1.0 / _TINY)
    d = 1.0 / fix(b)
    h = d
    zero = torch.zeros_like(x)
    # db/da = -1, dc = 0 at the start, dd = d^2
    dc, dd = zero, d * d
    dh = dd
    for i in range(1, _GAMMAINC_TRIPS + 1):
        an = -i * (i - a)            # d an / da = i
        b = b + 2.0
        d_new = 1.0 / fix(an * d + b)
        c_new = fix(b + an / c)
        if want_da:
            dd = -(i * d + an * dd - 1.0) * d_new * d_new
            dc = -1.0 + i / c - an * dc / (c * c)
            dh = dh * (d_new * c_new) + h * (dd * c_new + d_new * dc)
        d, c = d_new, c_new
        h = h * (d * c)
    return h, dh


def _gammainc_f64(a, x, upper, want_da):
    """(value, d value / da) of P(a, x), or of Q = 1 - P when ``upper``, in
    float64 on broadcast tensors."""
    inside = x > 0
    xs = torch.where(inside, x, 1.0)
    use_series = xs < a + 1.0
    log_g = a * torch.log(xs) - xs - torch.special.gammaln(a)
    # each branch runs on inputs of its own region: the other region's
    # lanes take x = a (series) or x = a + 1 (fraction), and are dropped
    x_ser = torch.where(use_series, xs, a)
    x_cf = torch.where(use_series, a + 1.0, xs)
    s, ds = _gamma_series(a, x_ser, want_da)
    h, dh = _gamma_fraction(a, x_cf, want_da)
    front_ser = torch.exp(log_g) / a           # exp(.. - lgamma(a + 1))
    front_cf = torch.exp(log_g)
    p_ser = front_ser * s
    q_cf = front_cf * h
    if upper:
        val = torch.where(use_series, 1.0 - p_ser, q_cf)
        edge = 1.0
    else:
        val = torch.where(use_series, p_ser, 1.0 - q_cf)
        edge = 0.0
    val = torch.where(inside, val, edge)
    if not want_da:
        return val, None
    lx = torch.log(xs)
    dp_ser = front_ser * ((lx - torch.special.digamma(a + 1.0)) * s + ds)
    dq_cf = front_cf * ((lx - torch.special.digamma(a)) * h + dh)
    dp = torch.where(use_series, dp_ser, -dq_cf)
    da = torch.where(inside, -dp if upper else dp, 0.0)
    return val, da


class _GammaInc(torch.autograd.Function):
    """Regularized incomplete gamma P(a, x) (or Q = 1 - P) with both
    gradients: in ``x`` the Gamma density, in ``a`` the term-by-term
    derivative of the series or the continued fraction."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x, upper):
        a64, x64 = torch.broadcast_tensors(a.double(), x.double())
        return _gammainc_f64(a64, x64, upper, False)[0].to(x.dtype)

    @staticmethod
    def setup_context(ctx, inputs, output):
        a, x, upper = inputs
        ctx.save_for_backward(a, x)
        ctx.upper = upper

    @staticmethod
    def backward(ctx, grad):
        a, x = ctx.saved_tensors
        sign = -1.0 if ctx.upper else 1.0
        ga = gx = None
        if ctx.needs_input_grad[0]:
            a64, x64 = torch.broadcast_tensors(a.double(), x.double())
            da = _gammainc_f64(a64, x64, ctx.upper, True)[1].to(grad.dtype)
            ga = _sum_to(grad * da, a.shape)
        if ctx.needs_input_grad[1]:
            inside = x > 0
            xs = torch.where(inside, x, 1.0)
            dens = torch.exp((a - 1.0) * torch.log(xs) - xs
                             - torch.special.gammaln(a))
            gx = _sum_to(grad * sign * torch.where(inside, dens, 0.0),
                         x.shape)
        return ga, gx, None


def _gammainc_args(a, x):
    x = torch.as_tensor(x)
    return torch.as_tensor(a, dtype=x.dtype, device=x.device), x


def gammainc(a, x):
    """Regularized lower incomplete gamma P(a, x), differentiable in both."""
    return _GammaInc.apply(*_gammainc_args(a, x), False)


def gammaincc(a, x):
    """Regularized upper incomplete gamma Q(a, x) = 1 - P(a, x)."""
    return _GammaInc.apply(*_gammainc_args(a, x), True)


# -- random draws ------------------------------------------------------------
def _rng_generator(rng, gen, device):
    """``gen``, or, for the JAX package's ``rng`` (a numpy ``RandomState``
    or ``Generator``), a ``torch.Generator`` on ``device`` seeded from one
    draw of it."""
    if rng is None:
        return gen
    if gen is not None:
        raise ValueError("give rng (numpy) or gen (torch), not both")
    seed = rng.integers(2 ** 62) if hasattr(rng, "integers") else \
        rng.randint(2 ** 62, dtype=np.int64)
    return torch.Generator(device=device).manual_seed(int(seed))


def random_choice(p, size=None, rng=None, gen=None):
    """Categorical draws from (batched) probability rows on ``p``'s device
    (cf. ``dist_math.py:225``): one draw per row, or ``size`` draws from a
    single row. With ``gen`` (a ``torch.Generator``) the draws are a
    tensor; with the JAX package's ``rng`` they are seeded from it and
    returned as numpy int64, as the JAX package returns them."""
    p = torch.as_tensor(p)
    gen = _rng_generator(rng, gen, p.device)
    p = p / p.sum(-1, keepdim=True)
    if p.ndim > 1:
        target = (tuple(np.atleast_1d(size)) if size is not None
                  else tuple(p.shape[:-1]))
        rows = torch.broadcast_to(p, target + p.shape[-1:]).reshape(
            -1, p.shape[-1])
        out = torch.multinomial(rows, 1, replacement=True, generator=gen)
    else:
        target = tuple(np.atleast_1d(size)) if size is not None else ()
        n = int(np.prod(target, dtype=int)) if target else 1
        out = torch.multinomial(p, n, replacement=True, generator=gen)
    out = out.reshape(target)
    return out if rng is None else out.cpu().numpy()


def clipped_beta_rvs(a, b, size=None, rng=None, dtype=None, gen=None):
    """Beta draws clipped away from 0 and 1 by the float's epsilon
    (cf. ``dist_math.py:246``), made from two float64 gamma draws, in
    ``dtype`` (``floatX`` by default). With ``gen`` (a ``torch.Generator``)
    the draws are a tensor on ``a``'s device; with the JAX package's
    ``rng`` they are seeded from it and returned as numpy."""
    a = torch.as_tensor(a, dtype=torch.float64)
    b = torch.as_tensor(b, dtype=torch.float64)
    gen = _rng_generator(rng, gen, a.device)
    shape = (tuple(np.atleast_1d(size)) if size is not None
             else np.broadcast_shapes(tuple(a.shape), tuple(b.shape)))
    ga = torch._standard_gamma(a.expand(shape).contiguous(), generator=gen)
    gb = torch._standard_gamma(b.expand(shape).contiguous(), generator=gen)
    if dtype is None:
        dtype = torch_floatX()
    elif not isinstance(dtype, torch.dtype):
        dtype = getattr(torch, np.dtype(dtype).name)
    eps = torch.finfo(dtype).eps
    out = torch.clamp(ga / (ga + gb), eps, 1.0 - eps).to(dtype)
    return out if rng is None else out.cpu().numpy()


def MvNormal_logp(cov, delta):
    """The multivariate normal log-density of residuals ``delta (..., k)``
    under a covariance ``cov (k, k)`` (cf. ``dist_math.py:158``): one
    Cholesky factor and one triangular solve against all residuals. A
    covariance that is not positive definite gives -inf. numpy inputs go to
    the configured device, in ``floatX``."""
    cov, delta = (x if isinstance(x, torch.Tensor) else torch.as_tensor(
        floatX(np.asarray(x)), device=current_device()) for x in (cov, delta))
    k = cov.shape[-1]
    chol, info = torch.linalg.cholesky_ex(cov)
    diag = torch.diagonal(chol, dim1=-2, dim2=-1)
    ok = (info == 0) & torch.all(diag > 0) & torch.all(torch.isfinite(diag))
    eye = torch.eye(k, dtype=cov.dtype, device=cov.device)
    safe = torch.where(ok, chol, eye)
    sol = torch.linalg.solve_triangular(safe, delta.reshape(-1, k).T,
                                        upper=False)
    quad = torch.sum(sol ** 2, dim=0).reshape(delta.shape[:-1])
    logdet = torch.sum(torch.log(torch.diagonal(safe)))
    out = -0.5 * (k * np.log(2.0 * np.pi) + quad) - logdet
    return torch.where(ok, out, torch.full_like(out, -np.inf))
