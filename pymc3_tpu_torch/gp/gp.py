"""Gaussian process implementations (cf. ``pymc3_tpu/gp/gp.py``).

``Latent`` and ``TP`` (reparameterised priors and their conditionals),
``Marginal`` (conjugate regression and prediction), ``MarginalSparse``
(FITC, VFE and DTC), ``LatentKron`` and ``MarginalKron``. The algebra is
symbolic node math over ``torch.linalg`` Cholesky factors and triangular
solves; every covariance enters it as a node argument, so a covariance whose
hyperparameters are random variables is evaluated at the point the sampler
proposes. (The JAX package's ``MarginalSparse`` and the Kronecker
conditionals evaluate their covariances with an empty environment, at the
hyperparameters' test values, whatever the sampler proposes; the port does
not copy that.) The five stationary kinds reach the fused covariance kernel,
``K(X, Xnew)`` and ``K(Xnew)`` at their full width.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import floatX, torch_floatX
from ..node import Node, apply as node_apply, as_node
from .cov import Constant, Covariance, Kron, WhiteNoise
from .mean import Zero
from . import util
from .util import (
    cholesky, conditioned_vars, infer_shape, solve_lower, stabilize,
)

__all__ = ["Latent", "Marginal", "TP", "MarginalSparse", "LatentKron",
           "MarginalKron"]


class Base:
    """Base class for GP objects (cf. ``gp.py:34``)."""

    def __init__(self, mean_func=None, cov_func=None):
        self.mean_func = mean_func if mean_func is not None else Zero()
        self.cov_func = cov_func if cov_func is not None else Constant(0.0)

    def __add__(self, other):
        same_attrs = set(self.__dict__.keys()) == set(other.__dict__.keys())
        if not isinstance(self, type(other)) or not same_attrs:
            raise TypeError("Cannot add different GP types")
        mean_total = self.mean_func + other.mean_func
        cov_total = self.cov_func + other.cov_func
        return self.__class__(mean_total, cov_total)

    def prior(self, name, X, *args, **kwargs):
        raise NotImplementedError

    def marginal_likelihood(self, name, X, *args, **kwargs):
        raise NotImplementedError

    def conditional(self, name, Xnew, *args, **kwargs):
        raise NotImplementedError

    def predict(self, Xnew, point=None, given=None, diag=False):
        raise NotImplementedError


def _as_noise(noise):
    return noise if isinstance(noise, Covariance) else WhiteNoise(noise)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _f64(*values):
    """Tensors in float64 (numbers pass through)."""
    return [v.to(torch.float64) if isinstance(v, torch.Tensor) else v
            for v in values]


def _tri(L, b, upper=False):
    """Triangular solve of a matrix or a vector right-hand side."""
    vec = b.ndim == 1
    out = torch.linalg.solve_triangular(L, b[:, None] if vec else b,
                                        upper=upper)
    return out[:, 0] if vec else out


def _chol_ok(K):
    """Lower Cholesky factor and a flag that it exists, with no host sync;
    where it does not, the identity stands in so that nothing downstream is
    NaN (the caller masks its result with the flag)."""
    L, info = torch.linalg.cholesky_ex(K, check_errors=False)
    ok = info == 0
    return torch.where(ok, L, _eye(K.shape[-1], K)), ok


def _split(out):
    """The (mean, covariance) pair of a node that returns both."""
    return node_apply(lambda t: t[0], out), node_apply(lambda t: t[1], out)


def _predict(mu, cov, point):
    """Numpy mean and covariance at ``point`` (the model's test point when
    None): one evaluation on the model's device, one copy to the host."""
    from ..model import modelcontext
    model = modelcontext(None)
    return tuple(model.makefn([mu, cov])(
        point if point is not None else model.test_point))


@conditioned_vars(["X", "f"])
class Latent(Base):
    r"""Latent (non-conjugate) GP (cf. ``gp.py:60``): ``prior`` places a
    rotated, whitened normal over f, ``conditional`` extends it to new
    inputs."""

    def _build_prior(self, name, X, reparameterize=True, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        mu = self.mean_func(X)
        cov = stabilize(self.cov_func(X))
        shape = infer_shape(X, kwargs.pop("shape", None))
        if reparameterize:
            v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0,
                            shape=shape, **kwargs)
            return Deterministic(name, mu + node_apply(
                lambda L, v_: L @ v_, cholesky(cov), v))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def prior(self, name, X, reparameterize=True, **kwargs):
        X = as_node(X)
        f = self._build_prior(name, X, reparameterize, **kwargs)
        self.X = X
        self.f = f
        return f

    def _get_given_vals(self, given):
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "f"]):
            X, f = as_node(given["X"]), given["f"]
        else:
            X, f = self.X, self.f
        return X, f, cov_total, mean_total

    def _build_conditional(self, Xnew, X, f, cov_total, mean_total):
        Kxx = cov_total(X)
        Kxs = self.cov_func(X, Xnew)
        L = cholesky(stabilize(Kxx))
        A = solve_lower(L, Kxs)
        v = solve_lower(L, f - mean_total(X))
        mu = self.mean_func(Xnew) + node_apply(lambda A_, v_: A_.T @ v_, A, v)
        Kss = self.cov_func(Xnew)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        return mu, cov

    def conditional(self, name, Xnew, given=None, **kwargs):
        """The GP at new inputs, given f at X, as an MvNormal random
        variable of the model (cf. ``gp.py:156``)."""
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)


@conditioned_vars(["X", "f", "nu"])
class TP(Latent):
    r"""Student-T process (cf. ``gp.py:226``)."""

    def __init__(self, mean_func=None, cov_func=None, nu=None):
        if nu is None:
            raise ValueError("Student's T process requires a degrees of "
                             "freedom parameter, 'nu'")
        self.nu = nu
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        raise TypeError("Student's T processes aren't additive")

    def _build_prior(self, name, X, reparameterize=True, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        mu = self.mean_func(X)
        cov = stabilize(self.cov_func(X))
        shape = infer_shape(X, kwargs.pop("shape", None))
        if reparameterize:
            chi2 = dist.ChiSquared(name + "_chi2_", self.nu)
            v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0,
                            shape=shape, **kwargs)
            return Deterministic(name, mu + node_apply(
                lambda nu_, chi2_, L, v_:
                (nu_ ** 0.5 / torch.sqrt(chi2_)) * (L @ v_),
                self.nu, chi2, cholesky(cov), v))
        return dist.MvStudentT(name, nu=self.nu, mu=mu, cov=cov, shape=shape,
                               **kwargs)

    def _build_conditional(self, Xnew, X, f):
        Kxx = self.cov_func(X)
        Kxs = self.cov_func(X, Xnew)
        Kss = self.cov_func(Xnew)
        L = cholesky(stabilize(Kxx))
        A = solve_lower(L, Kxs)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        v = solve_lower(L, f - self.mean_func(X))
        mu = self.mean_func(Xnew) + node_apply(lambda A_, v_: A_.T @ v_, A, v)
        beta = node_apply(lambda v_: v_ @ v_, v)
        n = infer_shape(X)
        nu2 = node_apply(lambda nu_: nu_ + n, self.nu)
        covT = node_apply(
            lambda nu_, b_, cov_: (nu_ + b_ - 2) / (nu_ + n - 2) * cov_,
            self.nu, beta, cov)
        return nu2, mu, covT

    def conditional(self, name, Xnew, **kwargs):
        """cf. ``gp.py:187``."""
        from .. import distributions as dist
        nu2, mu, cov = self._build_conditional(as_node(Xnew), self.X, self.f)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvStudentT(name, nu=nu2, mu=mu, cov=stabilize(cov),
                               shape=shape, **kwargs)


@conditioned_vars(["X", "y", "noise"])
class Marginal(Base):
    r"""Conjugate marginal GP regression (cf. ``gp.py:344``)."""

    def _build_marginal_likelihood(self, X, noise):
        mu = self.mean_func(X)
        cov = self.cov_func(X) + noise(X)
        return mu, cov

    def marginal_likelihood(self, name, X, y, noise, is_observed=True,
                            **kwargs):
        """MvNormal with K(X) + Σ_noise, observed at ``y``
        (cf. ``gp/gp.py:197-223``)."""
        from .. import distributions as dist
        X = as_node(X)
        noise = _as_noise(noise)
        mu, cov = self._build_marginal_likelihood(X, noise)
        self.X = X
        self.y = y if isinstance(y, Node) else as_node(y)
        self.noise = noise
        if is_observed:
            return dist.MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)
        shape = infer_shape(X, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def _get_given_vals(self, given):
        """The data and the total covariance to condition on: this GP's own,
        or those handed over in ``given`` (``gp`` for the sum this GP is a
        term of; ``X``, ``y`` and ``noise`` together)."""
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "y", "noise"]):
            X, y = as_node(given["X"]), as_node(given["y"])
            noise = _as_noise(given["noise"])
        else:
            X, y, noise = self.X, self.y, self.noise
        return X, y, noise, cov_total, mean_total

    def _build_conditional(self, Xnew, pred_noise, diag, X, y, noise,
                           cov_total, mean_total):
        """The conditional mean and (co)variance at ``Xnew``
        (cf. ``gp.py:243``)."""
        Kxx = cov_total(X)
        Kxs = self.cov_func(X, Xnew)
        Knx = noise(X)
        rxx = y - mean_total(X)
        L = cholesky(stabilize(Kxx) + Knx)
        A = solve_lower(L, Kxs)
        v = solve_lower(L, rxx)
        mu = self.mean_func(Xnew) + node_apply(
            lambda A_, v_: A_.T @ v_, A, v)
        if diag:
            Kss = self.cov_func(Xnew, diag=True)
            var = node_apply(
                lambda Kss_, A_: Kss_ - torch.sum(A_ ** 2, dim=0), Kss, A)
            if pred_noise:
                var = var + noise(Xnew, diag=True)
            return mu, var
        Kss = self.cov_func(Xnew)
        cov = node_apply(lambda Kss_, A_: Kss_ - A_.T @ A_, Kss, A)
        if pred_noise:
            cov = cov + noise(Xnew)
        return mu, cov if pred_noise else stabilize(cov)

    def conditional(self, name, Xnew, pred_noise=False, given=None,
                    **kwargs):
        """The GP at new inputs, given the observations, as an MvNormal
        random variable of the model (cf. ``gp.py:268``)."""
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, False,
                                          *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=cov, shape=shape, **kwargs)

    def predict(self, Xnew, point=None, diag=False, pred_noise=False,
                given=None):
        """Predictive mean and covariance (variance with ``diag``) at a
        point, or at the model's test point, as numpy arrays
        (cf. ``gp.py:277``). The arithmetic runs on the model's device; the
        two results are copied to the host once, at the end."""
        return _predict(*self.predictt(Xnew, diag, pred_noise, given),
                        point)

    def predictt(self, Xnew, diag=False, pred_noise=False, given=None):
        """Symbolic predictive mean and covariance (cf. ``gp.py:289``)."""
        givens = self._get_given_vals(given)
        return self._build_conditional(as_node(Xnew), pred_noise, diag,
                                       *givens)


@conditioned_vars(["X", "Xu", "y", "sigma"])
class MarginalSparse(Marginal):
    r"""Sparse approximate marginal GP (cf. ``gp.py:298``): FITC, VFE and
    DTC inducing-point approximations.

    ``Kuu``, ``Kuf``, the diagonal of ``Kff`` and, for the conditional,
    ``Kus`` and ``Kss`` are node arguments of the logp and of the
    conditional, so their hyperparameters are those of the point being
    evaluated. The formulas are the JAX package's (``gp.py:317-360``,
    ``:392-423``), which evaluates these covariances at the test values
    instead (``_eval_cov``, ``gp.py:467-481``), with two changes for the
    amplitude's far tail, which an SMC run's prior draws reach:
    - the algebra after the covariances runs in float64: in float32 the
      condition number of I + A Λ⁻¹ Aᵀ reaches 1e8 there, c·c outgrows
      rᵀ Λ⁻¹ r and the logp went to +5e5 on the card;
    - ``Kuu``'s jitter grows with its diagonal where the covariance's own
      rounding needs it (:meth:`_factors`).
    Both leave the logp at ordinary hyperparameters as the JAX package's."""

    _available_approx = ("FITC", "VFE", "DTC")

    def __init__(self, mean_func=None, cov_func=None, approx="FITC"):
        if approx not in self._available_approx:
            raise NotImplementedError(approx)
        self.approx = approx
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        new_gp = super().__add__(other)
        if not self.approx == other.approx:
            raise TypeError("Cannot add GPs with different approximations")
        new_gp.approx = self.approx
        return new_gp

    def _factors(self, Kuu, Kuf, Kffd, sigma, eps):
        """Luu, A = Luu⁻¹ Kuf, the diagonal Λ, L_B = chol(I + A Λ⁻¹ Aᵀ) and
        the flag that both factors exist, from float64 inputs whose
        covariances were computed with machine epsilon ``eps``.

        ``Kuu``'s jitter is the JAX package's 5e-4, or m eps max(diag Kuu)
        where that is larger: the rounding of ``Kuu``'s entries moves its
        eigenvalues by up to that much, and below it the factor is rounding
        noise. (At m = 20 in float32 this takes over above eta = 14.5.)"""
        sigma2 = sigma ** 2
        m = Kuu.shape[0]
        jitter = torch.clamp(m * eps * torch.diagonal(Kuu).max(),
                             min=util._default_jitter())
        Luu, ok = _chol_ok(Kuu + jitter * _eye(m, Kuu))
        A = _tri(Luu, Kuf)
        Qffd = torch.sum(A * A, dim=0)
        if self.approx == "FITC":
            Lamd = torch.clamp(Kffd - Qffd, min=0.0) + sigma2
        else:
            Lamd = torch.ones_like(Qffd) * sigma2
        L_B, ok_B = _chol_ok(_eye(Kuu.shape[0], Kuu) + (A / Lamd) @ A.T)
        return Luu, A, Qffd, Lamd, L_B, ok & ok_B

    def _build_marginal_logp(self, X, Xu, y, sigma):
        """The approximate log marginal likelihood (cf. ``gp.py:317-360``);
        -inf where a factor does not exist."""
        approx = self.approx

        def logp(Kuu, Kuf, Kffd, y_, sigma_, mu_):
            eps = torch.finfo(Kuu.dtype).eps
            Kuu, Kuf, Kffd, y_, sigma_, mu_ = _f64(Kuu, Kuf, Kffd, y_,
                                                   sigma_, mu_)
            Luu, A, Qffd, Lamd, L_B, ok = self._factors(Kuu, Kuf, Kffd,
                                                        sigma_, eps)
            if approx == "VFE":
                trace = (-0.5 / sigma_ ** 2) * (torch.sum(Kffd)
                                                - torch.sum(Qffd))
            else:
                trace = 0.0
            r = y_ - mu_
            r_l = r / Lamd
            c = _tri(L_B, A @ r_l)
            n = r.shape[0]
            constant = 0.5 * n * np.log(2.0 * np.pi)
            logdet = 0.5 * torch.sum(torch.log(Lamd)) + torch.sum(
                torch.log(torch.diagonal(L_B)))
            quadratic = 0.5 * (torch.dot(r, r_l) - torch.dot(c, c))
            lp = -1.0 * (constant + logdet + quadratic) + trace
            return torch.where(ok, lp, -torch.inf).to(torch_floatX())
        Kffd = self.cov_func(X, diag=True) if approx != "DTC" else 0.0
        return node_apply(logp, self.cov_func(Xu), self.cov_func(Xu, X),
                          Kffd, y, sigma, self.mean_func(X))

    def marginal_likelihood(self, name, X, Xu, y, noise=None, sigma=None,
                            is_observed=True, **kwargs):
        """The approximate marginal likelihood as a ``Potential``
        (cf. ``gp.py:362``)."""
        from ..model import Potential
        if sigma is None and noise is None:
            raise ValueError("Must provide a value or prior for the noise "
                             "standard deviation")
        if sigma is None:
            sigma = noise
        self.X = as_node(X)
        self.Xu = as_node(Xu)
        self.y = as_node(y)
        self.sigma = sigma
        return Potential(name, self._build_marginal_logp(
            self.X, self.Xu, self.y, sigma))

    def _build_conditional(self, Xnew, pred_noise, diag, X, Xu, y, sigma,
                           cov_total, mean_total):
        """The conditional mean and (co)variance at ``Xnew``
        (cf. ``gp.py:392-423``)."""
        approx = self.approx

        def cond(Kuu, Kuf, Kffd, Kus, Kss, y_, sigma_, mu_, ms_):
            eps = torch.finfo(Kuu.dtype).eps
            Kuu, Kuf, Kffd, Kus, Kss, y_, sigma_, mu_, ms_ = _f64(
                Kuu, Kuf, Kffd, Kus, Kss, y_, sigma_, mu_, ms_)
            Luu, A, _, Lamd, L_B, _ = self._factors(Kuu, Kuf, Kffd, sigma_,
                                                    eps)
            r = y_ - mu_
            c = _tri(L_B, A @ (r / Lamd))
            As = _tri(Luu, Kus)
            mus = ms_ + As.T @ _tri(L_B.T, c, upper=True)
            C = _tri(L_B, As)
            sigma2 = sigma_ ** 2
            if diag:
                cov = Kss - torch.sum(As ** 2, dim=0) + torch.sum(C ** 2,
                                                                  dim=0)
                if pred_noise:
                    cov = cov + sigma2
            else:
                cov = Kss - As.T @ As + C.T @ C
                if pred_noise:
                    cov = cov + sigma2 * _eye(cov.shape[0], cov)
            return mus.to(torch_floatX()), cov.to(torch_floatX())

        Kffd = self.cov_func(X, diag=True) if approx == "FITC" else 0.0
        return _split(node_apply(
            cond, self.cov_func(Xu), self.cov_func(Xu, X), Kffd,
            self.cov_func(Xu, Xnew), self.cov_func(Xnew, diag=diag), y,
            sigma, mean_total(X), mean_total(Xnew)))

    def _get_given_vals(self, given):
        if given is None:
            given = {}
        if "gp" in given:
            cov_total = given["gp"].cov_func
            mean_total = given["gp"].mean_func
        else:
            cov_total = self.cov_func
            mean_total = self.mean_func
        if all(val in given for val in ["X", "Xu", "y", "sigma"]):
            X, Xu = as_node(given["X"]), as_node(given["Xu"])
            y, sigma = as_node(given["y"]), given["sigma"]
        else:
            X, Xu, y, sigma = self.X, self.Xu, self.y, self.sigma
        return X, Xu, y, sigma, cov_total, mean_total

    def conditional(self, name, Xnew, pred_noise=False, given=None,
                    **kwargs):
        """cf. ``gp.py:446``."""
        from .. import distributions as dist
        givens = self._get_given_vals(given)
        mu, cov = self._build_conditional(as_node(Xnew), pred_noise, False,
                                          *givens)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)


def _kron_mv(v, mats):
    """(M_1 ⊗ ... ⊗ M_k) v without forming the product
    (cf. ``gp.py:523-530``)."""
    out = v
    for M in reversed(mats):
        out = (out.reshape(-1, M.shape[0]) @ M.T).T.reshape(-1)
    return out


def _mode_product(T, M, k):
    """T x_k M: mode ``k`` of the tensor ``T`` multiplied by the matrix
    ``M`` (out[..., a, ...] = sum_b M[a, b] T[..., b, ...])."""
    return torch.movedim(torch.tensordot(M, T, dims=([1], [k])), 0, k)


def _outer(vecs, skip=None):
    """The outer product of ``vecs`` as a tensor of their lengths, with the
    vector ``skip`` taken as ones."""
    out = None
    for k, v in enumerate(vecs):
        shape = [1] * len(vecs)
        shape[k] = -1
        term = (torch.ones_like(v) if k == skip else v).reshape(shape)
        out = term if out is None else out * term
    return out


class _KronMarginalLogp(torch.autograd.Function):
    """log N(r | 0, K_1 ⊗ ... ⊗ K_k + s2 I) through the eigendecompositions
    K_l = Q_l diag(λ_l) Q_lᵀ (cf. ``gp.py:595-620``): with D = ⊗λ + s2 and
    A = (⊗Q)ᵀ r, -(N log 2π + Σ log D + Σ A²/D) / 2.

    The backward never differentiates the eigenvectors, which autograd
    through ``eigh`` does (dividing by λ_i - λ_j: NaN where a factor's
    spectrum is degenerate, as a smooth kernel's is at the jitter). With
    v = (K + s2 I)⁻¹ r as a tensor V: d/dr = -v, d/ds2 = -(Σ 1/D - Σ
    A²/D²) / 2, and d/dK_k = (unfold_k(V) unfold_k(V x_{l≠k} K_l)ᵀ - Q_k
    diag(h_k) Q_kᵀ) / 2 with h_k[i] = Σ over the other indices of
    Π_{l≠k} λ_l / D: both are invariant to the choice of eigenvectors of a
    repeated eigenvalue."""

    generate_vmap_rule = True

    @staticmethod
    def _parts(r, s2, Ks):
        lams, Qs = zip(*(torch.linalg.eigh(K) for K in Ks))
        D = _outer(lams) + s2
        A = r.reshape(D.shape)
        for k, Q in enumerate(Qs):
            A = _mode_product(A, Q.transpose(-1, -2), k)
        return lams, Qs, D, A

    @staticmethod
    def forward(r, s2, *Ks):
        _, _, D, A = _KronMarginalLogp._parts(r, s2, Ks)
        return -0.5 * (r.shape[0] * np.log(2 * np.pi)
                       + torch.sum(torch.log(D)) + torch.sum(A * A / D))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        r, s2, *Ks = ctx.saved_tensors
        lams, Qs, D, A = _KronMarginalLogp._parts(r, s2, Ks)
        B = A / D
        V = B
        for k, Q in enumerate(Qs):
            V = _mode_product(V, Q, k)
        grads = [-g * V.reshape(-1),
                 -0.5 * g * (torch.sum(1.0 / D) - torch.sum(B * B))]
        for k in range(len(Ks)):
            W = V
            for l, K in enumerate(Ks):
                if l != k:
                    W = _mode_product(W, K, l)
            n = D.shape[k]
            Vk = torch.movedim(V, k, 0).reshape(n, -1)
            Wk = torch.movedim(W, k, 0).reshape(n, -1)
            h = torch.sum(_outer(lams, skip=k) / D,
                          dim=[l for l in range(len(Ks)) if l != k])
            Qk = Qs[k]
            grads.append(0.5 * g * (Vk @ Wk.transpose(-1, -2)
                                    - (Qk * h) @ Qk.transpose(-1, -2)))
        return tuple(grads)


def _kron(mats):
    K = mats[0]
    for M in mats[1:]:
        K = torch.kron(K, M)
    return K


def _grid_values(Xs):
    return [X.test_value if isinstance(X, Node) else X for X in Xs]


def _cartesian(Xs):
    """Cartesian product of grid inputs, rows in the Kronecker order
    (cf. ``gp.py:680``)."""
    arrs = [np.asarray(X) for X in _grid_values(Xs)]
    arrs = [a.reshape(a.shape[0], -1) for a in arrs]
    out = arrs[0]
    for a in arrs[1:]:
        out = np.concatenate([np.repeat(out, a.shape[0], axis=0),
                              np.tile(a, (out.shape[0], 1))], axis=1)
    return out.astype(floatX())


class _KronBase(Base):
    def __init__(self, mean_func=None, cov_funcs=(Constant(0.0),)):
        try:
            self.cov_funcs = list(cov_funcs)
        except TypeError:
            self.cov_funcs = [cov_funcs]
        super().__init__(mean_func, Kron(self.cov_funcs))

    def __add__(self, other):
        raise TypeError("Additive, Kronecker-structured processes not "
                        "implemented")

    def _grid_covs(self, Xs):
        """One stabilised covariance node per grid dimension."""
        return [stabilize(f(as_node(X))) for f, X in zip(self.cov_funcs, Xs)]


@conditioned_vars(["Xs", "f"])
class LatentKron(_KronBase):
    r"""Latent GP on a Cartesian grid with a Kronecker-structured
    covariance (cf. ``gp.py:484``). Its conditional takes ``K(X, Xnew)`` and
    ``K(Xnew)`` as node arguments (the JAX package evaluates them at the
    test values, ``gp.py:546,552``)."""

    def _build_prior(self, name, Xs, **kwargs):
        from .. import distributions as dist
        from ..model import Deterministic
        self.N = int(np.prod([np.shape(X)[0] for X in _grid_values(Xs)]))
        mu = self.mean_func(_cartesian(Xs))
        chols = [cholesky(K) for K in self._grid_covs(Xs)]
        v = dist.Normal(name + "_rotated_", mu=0.0, sigma=1.0, shape=self.N,
                        **kwargs)
        return Deterministic(name, mu + node_apply(
            lambda v_, *Ls: _kron_mv(v_, Ls), v, *chols))

    def prior(self, name, Xs, **kwargs):
        """cf. ``gp.py:529``."""
        if len(Xs) != len(self.cov_funcs):
            raise ValueError("Must provide a covariance function for each X")
        f = self._build_prior(name, Xs, **kwargs)
        self.Xs = [as_node(X) for X in Xs]
        self.f = f
        return f

    def _build_conditional(self, Xnew):
        X = as_node(_cartesian(self.Xs))
        Xnew = as_node(Xnew)

        def cond(delta, ms, Kxs, Kss, *Ks):
            L = torch.linalg.cholesky_ex(_kron(Ks), check_errors=False)[0]
            A = _tri(L, Kxs)
            v = _tri(L, delta)
            return ms + A.T @ v, Kss - A.T @ A
        return _split(node_apply(
            cond, self.f - self.mean_func(X), self.mean_func(Xnew),
            self.cov_func(X, Xnew), self.cov_func(Xnew),
            *self._grid_covs(self.Xs)))

    def conditional(self, name, Xnew, **kwargs):
        """cf. ``gp.py:561``."""
        from .. import distributions as dist
        mu, cov = self._build_conditional(Xnew)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)

    def conditional_mean_cov(self, Xnew):
        return self._build_conditional(Xnew)


@conditioned_vars(["Xs", "y", "sigma"])
class MarginalKron(_KronBase):
    r"""Marginal GP on a Cartesian grid (cf. ``gp.py:579``): the exact
    marginal likelihood through the eigendecomposition of each grid
    dimension's covariance, with a gradient that stays finite where a
    factor's spectrum is degenerate (:class:`_KronMarginalLogp`; the JAX
    package differentiates ``eigh``). Its conditional takes ``K(X, Xnew)``
    and ``K(Xnew)`` as node arguments (the JAX package evaluates them at the
    test values, ``gp.py:646,652``)."""

    def _build_marginal_likelihood_logp(self, y, Xs, sigma):
        """cf. ``gp.py:595-620``."""
        def logp(y_, sigma_, mu_, *Ks):
            r = y_.to(torch_floatX()) - mu_
            s2 = torch.as_tensor(sigma_, dtype=r.dtype,
                                 device=r.device) ** 2
            return _KronMarginalLogp.apply(r, s2, *Ks)
        return node_apply(logp, y, sigma, self.mean_func(_cartesian(Xs)),
                          *self._grid_covs(Xs))

    def marginal_likelihood(self, name, Xs, y, sigma, is_observed=True,
                            **kwargs):
        """The exact marginal likelihood as a ``Potential``
        (cf. ``gp.py:622``)."""
        from ..model import Potential
        self.Xs = [as_node(X) for X in Xs]
        self.y = as_node(y)
        self.sigma = sigma
        return Potential(name, self._build_marginal_likelihood_logp(
            self.y, Xs, sigma))

    def _build_conditional(self, Xnew, pred_noise, diag):
        X = as_node(_cartesian(self.Xs))
        Xnew = as_node(Xnew)

        def cond(y_, sigma_, mu_, ms_, Kxs, Kss, *Ks):
            K = _kron(Ks)
            sigma2 = sigma_ ** 2
            L = torch.linalg.cholesky_ex(K + sigma2 * _eye(K.shape[0], K),
                                         check_errors=False)[0]
            A = _tri(L, Kxs)
            v = _tri(L, y_.to(torch_floatX()) - mu_)
            cov = Kss - A.T @ A
            if pred_noise:
                cov = cov + sigma2 * _eye(cov.shape[0], cov)
            return ms_ + A.T @ v, cov
        return _split(node_apply(
            cond, self.y, self.sigma, self.mean_func(X), self.mean_func(Xnew),
            self.cov_func(X, Xnew), self.cov_func(Xnew),
            *self._grid_covs(self.Xs)))

    def conditional(self, name, Xnew, pred_noise=False, **kwargs):
        """cf. ``gp.py:660``."""
        from .. import distributions as dist
        mu, cov = self._build_conditional(Xnew, pred_noise, False)
        shape = infer_shape(Xnew, kwargs.pop("shape", None))
        return dist.MvNormal(name, mu=mu, cov=stabilize(cov), shape=shape,
                             **kwargs)

    def predict(self, Xnew, point=None, diag=False, pred_noise=False):
        """Numpy mean and covariance at a point (cf. ``gp.py:667``)."""
        return _predict(*self._build_conditional(Xnew, pred_noise, diag),
                        point)
