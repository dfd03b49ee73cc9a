"""Multivariate distributions (cf. ``pymc3_tpu/distributions/multivariate.py``).

A covariance that is not positive definite gives a logp of ``-inf`` through
an ok-flag, as in the JAX package: ``cholesky_ex`` neither raises nor
synchronises with the host, and it batches under ``torch.func.vmap``, so a
bad leapfrog during warmup is rejected instead of ending the run.

Draws run on the device from an explicit generator: ``MvNormal`` and
``MvStudentT`` through the covariance's cholesky factor, ``Multinomial`` by
conditional binomials, ``Wishart`` by the Bartlett decomposition, the LKJ
families by the C-vine through the port's own Beta sampler. The JAX
package's host loops over scipy and numpy draws are not ported.
"""
from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..config import floatX, intX, torch_floatX
from ..node import Node, as_node, apply, evaluate
from . import transforms
from .continuous import ChiSquared, Normal
from .dist_math import bound, clipped_beta_rvs, factln, logpow
from .distribution import (
    Continuous, Discrete, Distribution, draw_values, point_lead, rand_gamma,
    rand_normal, _align,
)
from .shape_utils import to_tuple
from .special import gammaln, multigammaln

__all__ = [
    "MvNormal", "MvStudentT", "Dirichlet", "Multinomial", "Wishart",
    "WishartBartlett", "LKJCorr", "LKJCholeskyCov", "MatrixNormal",
    "KroneckerNormal", "posdef",
]


def _an(x):
    if isinstance(x, (Node, torch.Tensor)):
        return as_node(x)
    return as_node(floatX(np.asarray(x)))


def _eye_like(m):
    return torch.eye(m.shape[-1], dtype=m.dtype, device=m.device)


def _chol_ok(cov):
    """Lower cholesky factor and a flag that it exists, with no host sync."""
    chol, info = torch.linalg.cholesky_ex(cov, check_errors=False)
    return chol, info == 0


def _chol_of_inverse(tau):
    """Lower cholesky of ``inv(tau)`` from the factor of ``tau``."""
    chol_tau, ok = _chol_ok(tau)
    inv = torch.linalg.solve_triangular(chol_tau, _eye_like(tau), upper=False)
    chol, ok2 = _chol_ok(inv.transpose(-1, -2) @ inv)
    return chol, ok & ok2


def _spd_chol(kind, value):
    """``(chol, ok)`` of a covariance given as ``cov``, ``chol`` or ``tau``."""
    if kind == "cov":
        return _chol_ok(value)
    if kind == "chol":
        return value, torch.ones((), dtype=torch.bool, device=value.device)
    return _chol_of_inverse(value)


def _batched_chol(chol, lead, size_t, core_ndim):
    """Line a factor with ``lead`` sample axes up with draws of shape
    ``size_t + core`` (``core_ndim`` axes, the last the event axis)."""
    n_batch = len(size_t) + core_ndim - 1
    return chol.reshape(tuple(chol.shape[:lead])
                        + (1,) * (n_batch - chol.ndim + 2)
                        + tuple(chol.shape[lead:]))


class _QuadFormBase(Continuous):
    """Shared cov/chol/tau quadratic-form machinery (cf. ``multivariate.py:46``)."""

    def __init__(self, mu=None, cov=None, chol=None, tau=None, lower=True,
                 *args, **kwargs):
        if len([i for i in [tau, cov, chol] if i is not None]) != 1:
            raise ValueError(
                "Incompatible parameterization. Specify exactly one of "
                "tau, cov, or chol.")
        self.mu = _an(mu if mu is not None else 0.0)
        self._cov_param = "cov" if cov is not None else (
            "chol" if chol is not None else "tau")
        if cov is not None:
            self.cov = _an(cov)
        elif chol is not None:
            node = _an(chol)
            if not lower:
                node = apply(lambda c: c.transpose(-1, -2), node)
            self.chol_cov = node
        else:
            self.tau = _an(tau)
        super().__init__(*args, **kwargs)

    def _cov_node(self):
        return {"cov": lambda: self.cov, "chol": lambda: self.chol_cov,
                "tau": lambda: self.tau}[self._cov_param]()

    def _chol(self, env, memo):
        """Lower cholesky of the covariance + ok flag (cf. ``:70-89``)."""
        chol, ok = _spd_chol(self._cov_param,
                             evaluate(self._cov_node(), env, memo))
        diag = torch.diagonal(chol, dim1=-2, dim2=-1)
        ok = ok & torch.isfinite(diag).all() & (diag > 0).all()
        return torch.where(ok, chol, _eye_like(chol)), ok

    def _quaddist(self, value, env, memo):
        """(squared Mahalanobis distance, logdet, ok) (cf. ``:91-106``)."""
        mu = evaluate(self.mu, env, memo)
        chol, ok = self._chol(env, memo)
        delta = value - mu
        squeeze = delta.ndim == 1
        if squeeze:
            delta = delta[None, :]
        sol = torch.linalg.solve_triangular(chol, delta.transpose(-1, -2),
                                            upper=False).transpose(-1, -2)
        quaddist = torch.sum(sol ** 2, dim=-1)
        logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)))
        if squeeze:
            quaddist = quaddist[0]
        return quaddist, logdet, ok

    def _draw_chol(self, point, size, gen):
        """The covariance's lower factor at ``point`` (with its lead)."""
        value, = draw_values([self._cov_node()], point=point, size=size,
                             gen=gen)
        if self._cov_param == "chol":
            return value
        if self._cov_param == "cov":
            return torch.linalg.cholesky(value)
        return _chol_of_inverse(value)[0]

    def _correlated(self, point, size, gen):
        """``(mu, L z)``: the mean and a zero-mean draw with the
        distribution's covariance, both broadcasting to ``size + shape``."""
        mu, = draw_values([self.mu], point=point, size=size, gen=gen)
        lead = point_lead(point)
        size_t = to_tuple(size)
        shape = size_t + tuple(self.shape)
        chol = _batched_chol(self._draw_chol(point, size, gen), lead, size_t,
                             len(self.shape))
        z = rand_normal(gen, shape)
        mu = _align(mu, lead, len(size_t), len(self.shape))
        return mu, (chol @ z[..., None])[..., 0]


def _mu_shape(mu, kwargs):
    if kwargs.get("shape") is None:
        kwargs.pop("shape", None)
        kwargs["shape"] = np.shape(mu.test_value if isinstance(mu, Node)
                                   else np.asarray(mu))


class MvNormal(_QuadFormBase):
    r"""Multivariate normal (cf. ``multivariate.py:120``)."""

    def __init__(self, mu, cov=None, tau=None, chol=None, lower=True,
                 *args, **kwargs):
        _mu_shape(mu, kwargs)
        super().__init__(mu=mu, cov=cov, tau=tau, chol=chol, lower=lower,
                         *args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        quaddist, logdet, ok = self._quaddist(value, env or {},
                                              {} if memo is None else memo)
        k = value.shape[-1]
        out = -0.5 * (k * math.log(2.0 * np.pi) + quaddist) - logdet
        return torch.where(ok, out, -torch.inf)

    def _random(self, point=None, size=None, gen=None):
        """``mu + L z`` with ``L`` the covariance's cholesky factor at each
        sample (cf. ``multivariate.py:140``)."""
        gen = self._generator(gen)
        mu, lz = self._correlated(point, size, gen)
        return mu + lz


class MvStudentT(_QuadFormBase):
    r"""Multivariate Student's t (cf. ``multivariate.py:162``)."""

    def __init__(self, nu, Sigma=None, mu=None, cov=None, tau=None, chol=None,
                 lower=True, *args, **kwargs):
        if Sigma is not None:
            if cov is not None:
                raise ValueError("Specify only one of cov and Sigma")
            cov = Sigma
        self.nu = _an(nu)
        _mu_shape(mu, kwargs)
        super().__init__(mu=mu, cov=cov, tau=tau, chol=chol, lower=lower,
                         *args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        nu = evaluate(self.nu, env, memo)
        quaddist, logdet, ok = self._quaddist(value, env, memo)
        k = value.shape[-1]
        norm = (gammaln((nu + k) / 2.0) - gammaln(nu / 2.0)
                - 0.5 * k * torch.log(nu * np.pi))
        inner = -(nu + k) / 2.0 * torch.log1p(quaddist / nu)
        return torch.where(ok, norm + inner - logdet, -torch.inf)

    def _random(self, point=None, size=None, gen=None):
        """``mu + L z / sqrt(chi2_nu / nu)``, the chi-square as twice a
        float64 gamma draw (cf. ``multivariate.py:190``)."""
        gen = self._generator(gen)
        nu, = draw_values([self.nu], point=point, size=size, gen=gen)
        mu, lz = self._correlated(point, size, gen)
        size_t = to_tuple(size)
        batch = size_t + tuple(self.shape)[:-1]
        nu = _align(nu, point_lead(point), len(size_t), len(self.shape) - 1)
        chi2 = 2.0 * rand_gamma(gen, batch, nu / 2.0) / nu.double()
        return mu + lz / torch.sqrt(chi2).to(lz.dtype)[..., None]


class Dirichlet(Continuous):
    r"""Dirichlet over the simplex (cf. ``multivariate.py:206``); its default
    transform is the JAX package's Stan stick breaking."""

    def __init__(self, a, transform=transforms.stick_breaking, *args,
                 **kwargs):
        self.a = _an(a)
        if kwargs.get("shape") is None:
            kwargs["shape"] = tuple(np.shape(self.a.test_value))
        self.mean = apply(lambda a: a / torch.sum(a, dim=-1, keepdim=True),
                          self.a)
        self.mode = apply(
            lambda a: torch.where(torch.all(a > 1),
                                  (a - 1.0) / torch.sum(a - 1.0, dim=-1,
                                                        keepdim=True),
                                  torch.nan), self.a)
        kwargs.setdefault("transform", transform)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        a, = self._ev_params(("a",), env, memo)
        gl = torch.special.gammaln
        lp = torch.sum(logpow(value, a - 1.0) - gl(a), dim=-1) \
            + gl(torch.sum(a, dim=-1))
        return bound(lp,
                     torch.all(value >= 0, dim=-1),
                     torch.all(value <= 1, dim=-1),
                     torch.all(a > 0, dim=-1),
                     broadcast_conditions=False)

    def _random(self, point=None, size=None, gen=None):
        """Normalized float64 gamma draws (``torch._sample_dirichlet``)
        (cf. ``multivariate.py:237``)."""
        gen = self._generator(gen)
        a, = draw_values([self.a], point=point, size=size, gen=gen)
        size_t = to_tuple(size)
        shape = size_t + tuple(self.shape)
        a = _align(a, point_lead(point), len(size_t), len(self.shape))
        a = torch.broadcast_to(a.double(), shape).contiguous()
        return torch._sample_dirichlet(a, generator=gen).to(
            getattr(torch, str(self.dtype)))


def _n_times_p(n, p):
    return n[..., None] * p if n.ndim else n * p


class Multinomial(Discrete):
    r"""Multinomial (cf. ``multivariate.py:252``)."""

    def __init__(self, n, p, *args, **kwargs):
        self.n = _an(n)
        self.p = apply(lambda p: p / torch.sum(p, dim=-1, keepdim=True),
                       _an(p))
        if kwargs.get("shape") is None:
            kwargs["shape"] = tuple(np.broadcast_shapes(
                np.shape(self.p.test_value),
                np.shape(self.n.test_value)
                + (np.shape(self.p.test_value)[-1],)))
        self.mean = apply(_n_times_p, self.n, self.p)
        self.mode = apply(lambda n, p: torch.floor(_n_times_p(n, p)).to(
            getattr(torch, intX())), self.n, self.p)
        super().__init__(*args, **kwargs)

    def logp(self, value, env=None, memo=None):
        n, p = self._ev_params(("n", "p"), env, memo)
        value = value.to(p.dtype)
        lp = factln(n) + torch.sum(-factln(value) + logpow(p, value), dim=-1)
        return bound(lp,
                     torch.all(value >= 0, dim=-1),
                     torch.sum(value, dim=-1) == n,
                     torch.all(p <= 1, dim=-1),
                     torch.abs(torch.sum(p, dim=-1) - 1.0) < 1e-4,
                     broadcast_conditions=False)

    def _random(self, point=None, size=None, gen=None):
        """One binomial per category, each on what the ones before it
        left, in float64 (cf. ``multivariate.py:284``)."""
        gen = self._generator(gen)
        n, p = draw_values([self.n, self.p], point=point, size=size, gen=gen)
        lead = point_lead(point)
        size_t = to_tuple(size)
        shape = size_t + tuple(self.shape)
        p = torch.broadcast_to(_align(p, lead, len(size_t), len(self.shape)),
                               shape).double()
        left = torch.broadcast_to(
            _align(n, lead, len(size_t), len(self.shape) - 1),
            shape[:-1]).double().contiguous()
        p_left = torch.ones_like(left)
        out = []
        for j in range(shape[-1] - 1):
            prob = torch.clamp(p[..., j] / torch.clamp(p_left, min=1e-300),
                               0.0, 1.0)
            x = torch.binomial(left, prob.contiguous(), generator=gen)
            out.append(x)
            left = left - x
            p_left = p_left - p[..., j]
        out.append(left)
        return torch.stack(out, dim=-1).to(getattr(torch, str(self.dtype)))


def posdef(matrix):
    """True if the matrix is positive definite (host-side, cf.
    ``multivariate.py:307``)."""
    try:
        np.linalg.cholesky(np.asarray(matrix))
        return True
    except np.linalg.LinAlgError:
        return False


def _bartlett(gen, size_t, p, nu, chol):
    """Wishart draws ``(L A)(L A)ᵀ`` with ``A`` lower triangular, its
    diagonal the roots of chi-squares on ``nu - i`` degrees of freedom and
    standard normals below it; ``nu`` lines up with ``size_t``."""
    dof = nu[..., None] - torch.arange(p, dtype=nu.dtype, device=nu.device)
    c = _f32(2.0 * rand_gamma(gen, size_t + (p,), dof / 2.0))
    z = torch.tril(rand_normal(gen, size_t + (p, p)), diagonal=-1)
    LA = chol @ (torch.diag_embed(torch.sqrt(c)) + z)
    return LA @ LA.transpose(-1, -2)


def _f32(x):
    return x.to(torch_floatX())


class Wishart(Continuous):
    r"""Wishart on covariance matrices (cf. ``multivariate.py:317``). As in
    the reference, sampling a Wishart prior by MCMC is discouraged: use
    :class:`LKJCholeskyCov` or :func:`WishartBartlett`."""

    def __init__(self, nu, V, *args, **kwargs):
        warnings.warn(
            "The Wishart distribution can currently not be used for MCMC "
            "sampling. Use LKJCholeskyCov or WishartBartlett instead.",
            UserWarning)
        self.nu = _an(nu)
        self.V = _an(V)
        self.p = p = int(np.shape(self.V.test_value)[-1])
        if kwargs.get("shape") is None:
            kwargs["shape"] = (p, p)
        self.mean = apply(lambda nu, V: nu * V, self.nu, self.V)
        self.mode = apply(
            lambda nu, V: torch.where(nu >= p + 1, (nu - p - 1) * V,
                                      torch.nan), self.nu, self.V)
        super().__init__(defaults=("mean",), *args, **kwargs)

    def logp(self, value, env=None, memo=None):
        nu, V = self._ev_params(("nu", "V"), env, memo)
        p = self.p
        sign_x, logdet_x = torch.linalg.slogdet(value)
        _, logdet_v = torch.linalg.slogdet(V)
        trace = torch.diagonal(torch.linalg.solve(V, value), dim1=-2,
                               dim2=-1).sum(-1)
        lp = ((nu - p - 1.0) / 2.0 * logdet_x - 0.5 * trace
              - nu * p / 2.0 * math.log(2.0) - nu / 2.0 * logdet_v
              - multigammaln(nu / 2.0, p))
        return bound(lp, sign_x > 0, nu > p - 1, broadcast_conditions=False)

    def _random(self, point=None, size=None, gen=None):
        """Bartlett decomposition on the device (cf. ``multivariate.py:357``)."""
        gen = self._generator(gen)
        nu, V = draw_values([self.nu, self.V], point=point, size=size,
                            gen=gen)
        lead = point_lead(point)
        size_t = to_tuple(size)
        nu = torch.broadcast_to(_align(nu.double(), lead, len(size_t), 0),
                                size_t)
        chol = _align(torch.linalg.cholesky(V), lead, len(size_t), 2)
        return _bartlett(gen, size_t, self.p, nu, chol)


def WishartBartlett(name, S, nu, is_cholesky=False, return_cholesky=False,
                    testval=None, model=None):
    """Bartlett-decomposed Wishart prior (cf. ``multivariate.py:369``):
    chi-squared diagonal and normal off-diagonal free variables composed
    into a Wishart draw, which MCMC can sample."""
    from ..model import Deterministic, modelcontext

    model = modelcontext(model)
    S = np.asarray(S)
    nu_val = int(np.asarray(nu))
    n = S.shape[0]
    L = np.linalg.cholesky(S) if not is_cholesky else S

    diag_testval = tril_testval = None
    if testval is not None:
        diag_testval = np.sqrt(np.diagonal(testval))
        tril_testval = testval[np.tril_indices(n, -1)]

    c = ChiSquared("%s_c" % name, nu=nu_val - np.arange(2, 2 + n) + 2,
                   shape=n, testval=diag_testval)
    z = Normal("%s_z" % name, 0.0, 1.0, shape=(n * (n - 1) // 2,),
               testval=tril_testval)
    # where each cell of A reads from [sqrt(c), z, 0]
    pos = np.full((n, n), n + n * (n - 1) // 2, np.int64)
    pos[np.arange(n), np.arange(n)] = np.arange(n)
    pos[np.tril_indices(n, -1)] = n + np.arange(n * (n - 1) // 2)

    def _assemble(c, z, L):
        flat = torch.cat([torch.sqrt(c), z, torch.zeros_like(c[:1])])
        LA = L @ flat[torch.as_tensor(pos, device=c.device)]
        return LA if return_cholesky else LA @ LA.T

    return Deterministic(name, apply(_assemble, c, z, _an(L)), model=model)


def _lkj_normalizing_constant(eta, n):
    """log c_n(eta) of the normalized LKJ density p(R) = c_n(eta)
    det(R)^(eta - 1), host-side (cf. ``multivariate.py:407``, with the
    repo's sign fix: the closed form below is log Z, and the density adds
    -log Z)."""
    eta, n = float(eta), int(n)
    lg = math.lgamma
    if eta == 1:
        log_z = sum(lg(2.0 * k) for k in range(1, (n - 1) // 2 + 1))
        if n % 2 == 1:
            log_z += (0.25 * (n ** 2 - 1) * math.log(math.pi)
                      - 0.25 * (n - 1) ** 2 * math.log(2.0)
                      - (n - 1) * lg((n + 1) / 2))
        else:
            log_z += (0.25 * n * (n - 2) * math.log(math.pi)
                      + 0.25 * (3 * n ** 2 - 4 * n) * math.log(2.0)
                      + n * lg(n / 2) - (n - 1) * lg(n))
    else:
        log_z = -(n - 1) * lg(eta + 0.5 * (n - 1))
        log_z += sum(0.5 * k * math.log(math.pi) + lg(eta + 0.5 * (n - 1 - k))
                     for k in range(1, n))
    return -log_z


def _lkj_vine(gen, size_t, n, eta):
    """The upper factor ``P`` (``R = Pᵀ P``) of LKJ(eta) correlation
    matrices by the C-vine, ``(size_t..., n, n)``: the first partial
    correlation from Beta(b, b) with b = eta - 1 + n/2, then each further
    column a uniform direction scaled by the root of a Beta draw."""
    dt = torch_floatX()
    P = torch.eye(n, dtype=dt, device=gen.device).repeat(size_t + (1, 1))
    if n < 2:
        return P

    def beta(a, b):
        def full(v):
            return torch.full(size_t, v, dtype=torch.float64,
                              device=gen.device)
        return clipped_beta_rvs(full(a), full(b), size=size_t, gen=gen)
    beta0 = eta - 1.0 + n / 2.0
    r12 = 2.0 * beta(beta0, beta0) - 1.0
    P[..., 0, 1] = r12
    P[..., 1, 1] = torch.sqrt(1.0 - r12 ** 2)
    for mp1 in range(2, n):
        beta0 -= 0.5
        y = beta(mp1 / 2.0, beta0)
        u = rand_normal(gen, size_t + (mp1,))
        u = u / torch.linalg.vector_norm(u, dim=-1, keepdim=True)
        P[..., :mp1, mp1] = torch.sqrt(y)[..., None] * u
        P[..., mp1, mp1] = torch.sqrt(1.0 - y)
    return P


class LKJCholeskyCov(Continuous):
    r"""Packed cholesky factor of a covariance with an LKJ prior on the
    correlations and ``sd_dist`` on the standard deviations
    (cf. ``multivariate.py:440``). The free variable is the packed lower
    factor (row-major, n(n+1)/2 values) with a log-transformed diagonal."""

    def __init__(self, eta, n, sd_dist, *args, **kwargs):
        self.n = int(n)
        self.eta = float(eta)
        if not isinstance(sd_dist, Distribution):
            raise TypeError("sd_dist must be a Distribution instance "
                            "(use .dist())")
        self.sd_dist = sd_dist
        self.diag_idxs = np.arange(1, self.n + 1).cumsum() - 1
        kwargs["shape"] = (self.n * (self.n + 1) // 2,)
        kwargs.setdefault("transform", transforms.CholeskyCovPacked(self.n))
        super().__init__(*args, **kwargs)
        tv = np.zeros(self.n * (self.n + 1) // 2, dtype=floatX())
        tv[self.diag_idxs] = 1.0
        self.testval = tv
        self._norm_const = _lkj_normalizing_constant(self.eta, self.n)

    def logp(self, value, env=None, memo=None):
        x = value
        n, eta = self.n, self.eta
        di = torch.as_tensor(self.diag_idxs, device=x.device)
        cumsum = torch.cumsum(x ** 2, dim=-1)
        # variance_i = sum of squares of row i of L
        var = torch.cat([cumsum[..., di[:1]],
                         cumsum[..., di[1:]] - cumsum[..., di[:-1]]], dim=-1)
        sd_vals = torch.sqrt(var)
        logp_sd = torch.sum(self.sd_dist.logp(sd_vals, env, memo))
        corr_diag = x[..., di] / sd_vals
        idx = torch.arange(n, dtype=x.dtype, device=x.device)
        logp_lkj = torch.sum((2.0 * eta - 3.0 + n - idx)
                             * torch.log(corr_diag))
        # log|J| of (sd, correlation factor) -> covariance factor
        det_invjac = torch.sum(torch.log(corr_diag)
                               - idx * torch.log(sd_vals))
        return self._norm_const + logp_lkj + logp_sd + det_invjac

    def _random(self, point=None, size=None, gen=None):
        """The C-vine correlation factor scaled row-wise by draws of
        ``sd_dist`` (cf. ``multivariate.py:490``)."""
        gen = self._generator(gen)
        size_t = to_tuple(size)
        n = self.n
        C = _lkj_vine(gen, size_t, n, self.eta).transpose(-1, -2)
        sd_size = size_t + ((n,) if not self.sd_dist.shape else ())
        sds = self.sd_dist._random(point=point, size=sd_size, gen=gen)
        L = sds.reshape(size_t + (n,))[..., :, None].to(C.dtype) * C
        rows, cols = np.tril_indices(n)
        return L[..., torch.as_tensor(rows), torch.as_tensor(cols)]


class LKJCorr(Continuous):
    r"""LKJ prior over correlation matrices, stored as the flattened strict
    upper triangle (cf. ``multivariate.py:522``)."""

    def __init__(self, eta=None, n=None, p=None, transform="interval",
                 *args, **kwargs):
        if (p is not None) and (n is not None) and (eta is None):
            eta, n = n, p  # legacy (n, p) argument order
        self.n = int(n)
        self.eta = float(eta)
        n_elem = self.n * (self.n - 1) // 2
        self.mean = as_node(floatX(np.zeros(n_elem)))
        self.tri_index = np.zeros((self.n, self.n), dtype=int)
        self.tri_index[np.triu_indices(self.n, k=1)] = np.arange(n_elem)
        self.tri_index[np.triu_indices(self.n, k=1)[::-1]] = np.arange(n_elem)
        kwargs["shape"] = (n_elem,)
        if transform == "interval":
            transform = transforms.interval(-1.0, 1.0)
        kwargs.setdefault("transform", transform)
        super().__init__(defaults=("mean",), *args, **kwargs)
        self._norm_const = _lkj_normalizing_constant(self.eta, self.n)

    def _to_matrix(self, x):
        X = x[..., torch.as_tensor(self.tri_index, device=x.device)]
        eye = _eye_like(X)
        return X * (1.0 - eye) + eye

    def logp(self, value, env=None, memo=None):
        X = self._to_matrix(value)
        ok = torch.all(torch.linalg.eigvalsh(X) > 0)
        safe = torch.where(ok, X, _eye_like(X))
        _, logdet = torch.linalg.slogdet(safe)
        lp = self._norm_const + (self.eta - 1.0) * logdet
        return bound(lp, ok, torch.all(torch.abs(value) <= 1),
                     broadcast_conditions=False)

    def _random(self, point=None, size=None, gen=None):
        """The C-vine on the device (cf. ``multivariate.py:560``)."""
        gen = self._generator(gen)
        size_t = to_tuple(size)
        P = _lkj_vine(gen, size_t, self.n, self.eta)
        C = P.transpose(-1, -2) @ P
        rows, cols = np.triu_indices(self.n, k=1)
        return C[..., torch.as_tensor(rows), torch.as_tensor(cols)]


class MatrixNormal(Continuous):
    r"""Matrix-variate normal with Kronecker-structured covariance
    (cf. ``multivariate.py:587``)."""

    def __init__(self, mu=0, rowcov=None, rowchol=None, rowtau=None,
                 colcov=None, colchol=None, coltau=None, shape=None,
                 *args, **kwargs):
        self.mu = _an(mu)
        self._row = self._setup_side(rowcov, rowchol, rowtau, "row")
        self._col = self._setup_side(colcov, colchol, coltau, "col")
        if shape is None:
            shape = np.shape(self.mu.test_value)
        kwargs["shape"] = shape
        self.m, self.n_ = int(shape[-2]), int(shape[-1])
        super().__init__(*args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    @staticmethod
    def _setup_side(cov, chol, tau, label):
        given = [i for i in (cov, chol, tau) if i is not None]
        if len(given) != 1:
            raise ValueError(
                f"Specify exactly one of {label}cov, {label}chol, {label}tau.")
        if cov is not None:
            return ("cov", _an(cov))
        if chol is not None:
            return ("chol", _an(chol))
        return ("tau", _an(tau))

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        mu = evaluate(self.mu, env, memo)
        kr, node_r = self._row
        kc, node_c = self._col
        chol_r, ok_r = _spd_chol(kr, evaluate(node_r, env, memo))
        chol_c, ok_c = _spd_chol(kc, evaluate(node_c, env, memo))
        delta = value - mu
        # U^-1 delta V^-T by two triangular solves
        a = torch.linalg.solve_triangular(chol_r, delta, upper=False)
        b = torch.linalg.solve_triangular(chol_c, a.transpose(-1, -2),
                                          upper=False)
        m, n = self.m, self.n_
        out = (-0.5 * m * n * math.log(2.0 * np.pi)
               - n * torch.sum(torch.log(torch.diagonal(chol_r)))
               - m * torch.sum(torch.log(torch.diagonal(chol_c)))
               - 0.5 * torch.sum(b ** 2))
        return torch.where(ok_r & ok_c, out, -torch.inf)

    def _random(self, point=None, size=None, gen=None):
        """``mu + L_r Z L_cᵀ`` on the device (cf. ``multivariate.py:646``)."""
        gen = self._generator(gen)
        mu, side_r, side_c = draw_values(
            [self.mu, self._row[1], self._col[1]], point=point, size=size,
            gen=gen)
        lead = point_lead(point)
        size_t = to_tuple(size)
        chol_r = _align(_spd_chol(self._row[0], side_r)[0], lead,
                        len(size_t), 2)
        chol_c = _align(_spd_chol(self._col[0], side_c)[0], lead,
                        len(size_t), 2)
        z = rand_normal(gen, size_t + (self.m, self.n_))
        return _align(mu, lead, len(size_t), 2) \
            + chol_r @ z @ chol_c.transpose(-1, -2)


def _kron_rotate(QTs, x):
    """Apply kron(Q_1ᵀ, ..., Q_Dᵀ) to the rows of ``x: (batch, N)``
    (cf. ``multivariate.py:727``)."""
    batch, n = x.shape
    res = x
    for QT in QTs:
        kn = QT.shape[0]
        r = torch.einsum("ij,bjk->bik", QT, res.reshape(batch, kn, n // kn))
        res = r.movedim(1, 2).reshape(batch, n)
    return res


class KroneckerNormal(Continuous):
    r"""MvNormal with covariance kron(K_1, ..., K_D) + sigma² I
    (cf. ``multivariate.py:658``), through one eigendecomposition per
    factor: the Kronecker product is never formed for the logp."""

    def __init__(self, mu, covs=None, chols=None, evds=None, sigma=None,
                 *args, **kwargs):
        self.mu = _an(mu)
        if covs is not None:
            self.covs = [_an(c) for c in covs]
        elif chols is not None:
            self.covs = [apply(lambda L: L @ L.transpose(-1, -2), _an(L))
                         for L in chols]
        elif evds is not None:
            raise NotImplementedError("pass covs or chols")
        else:
            raise ValueError("Specify covs or chols")
        self.sigma = None if sigma is None else _an(sigma)
        self.sizes = [int(np.shape(c.test_value)[-1]) for c in self.covs]
        self.N = int(np.prod(self.sizes))
        if kwargs.get("shape") is None:
            kwargs["shape"] = (self.N,)
        super().__init__(*args, **kwargs)
        self.mean = self.median = self.mode = self.mu

    def logp(self, value, env=None, memo=None):
        env, memo = env or {}, {} if memo is None else memo
        mu = evaluate(self.mu, env, memo)
        eigs, QTs = [], []
        for c in self.covs:
            w, Q = torch.linalg.eigh(evaluate(c, env, memo))
            eigs.append(w)
            QTs.append(Q.T)
        lam = eigs[0]
        for w in eigs[1:]:
            lam = (lam[:, None] * w[None, :]).reshape(-1)
        if self.sigma is not None:
            lam = lam + evaluate(self.sigma, env, memo) ** 2
        delta = value - mu
        d = delta if delta.ndim > 1 else delta[None, :]
        quad = torch.sum(_kron_rotate(QTs, d) ** 2 / lam, dim=-1)
        out = -0.5 * (self.N * math.log(2.0 * np.pi)
                      + torch.sum(torch.log(lam)) + quad)
        return out[0] if delta.ndim == 1 else out

    def _random(self, point=None, size=None, gen=None):
        """Draws through the cholesky factor of the full covariance, on the
        device (cf. ``multivariate.py:709``)."""
        gen = self._generator(gen)
        params = self.covs + ([self.sigma] if self.sigma is not None else [])
        vals = draw_values([self.mu] + params, point=point, size=size,
                           gen=gen)
        lead = point_lead(point)
        mu, covs = vals[0], vals[1:1 + len(self.covs)]
        K = covs[0]
        for C in covs[1:]:
            K = (K[..., :, None, :, None] * C[..., None, :, None, :]).reshape(
                K.shape[:-2] + (K.shape[-2] * C.shape[-2],
                                K.shape[-1] * C.shape[-1]))
        if self.sigma is not None:
            s = vals[-1]
            K = K + (s ** 2)[..., None, None] * _eye_like(K)
        size_t = to_tuple(size)
        chol = _batched_chol(torch.linalg.cholesky(K), lead, size_t, 1)
        z = rand_normal(gen, size_t + (self.N,))
        return _align(mu, lead, len(size_t), 1) + (chol @ z[..., None])[..., 0]
