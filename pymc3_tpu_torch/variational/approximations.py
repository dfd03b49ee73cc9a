"""Variational families (cf. ``pymc3_tpu/variational/approximations.py``).

MeanField, FullRank, Empirical and NormalizingFlow as parametric samplers
over the flat unconstrained space, reparameterized so that objectives
differentiate straight through their noise.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import floatX
from ..model import modelcontext
from .opvi import Approximation, Group
from .updates import tree_map

__all__ = ["MeanField", "FullRank", "Empirical", "NormalizingFlow",
           "MeanFieldGroup", "FullRankGroup", "EmpiricalGroup",
           "NormalizingFlowGroup", "sample_approx"]

_LOG2PI = float(np.log(2 * np.pi))


def _sigma2rho(sigma):
    """The inverse of ``sigma = softplus(rho)``."""
    sigma = np.asarray(sigma, dtype=np.float64)
    return np.log(np.expm1(np.maximum(sigma, 1e-10)))


def _std_normal_logq(eps):
    return torch.sum(-0.5 * (_LOG2PI + eps ** 2), dim=-1)


class MeanFieldGroup(Group):
    """Fully factorized Gaussian q, ``sigma = softplus(rho)``
    (cf. ``approximations.py:42``).

    With ``local=True`` it is the AEVB group (cf. ``approximations.py:
    40-135``): its parameters come from the user, either trainable arrays,
    ``params=dict(mu=..., rho=...)``, or an amortizing encoder,
    ``params=dict(encoder=fn, aux={name: array})``. The optimizer trains
    ``aux`` as a dict of tensors. The encoder is called once for each
    Monte-Carlo sample, under ``torch.func.vmap``, as ``fn(aux, draw) ->
    (mu, rho)``: ``draw`` is that sample's minibatch draw, ``{noise_key:
    tensor}``, the very entry from which the model's ``Minibatch`` views
    take their rows, so ``x_mini.indices(draw)`` gives the rows that the
    likelihood sees in that sample (the port's counterpart of the JAX
    package's ``fn(aux, mb_key)``). Outside a step (``mean``, ``std``,
    ``logq``) ``draw`` is None: the rows of the test value. A local group's
    logq is scaled by ``scale_vec``, as the model's logp term of its
    variables is.
    """

    short_name = "mean_field"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        encoder = (self.user_params or {}).get("encoder")
        self._encoder = encoder if self.local and callable(encoder) else None
        self._scale = self._tensor(self.scale_vec)

    def init_params(self, start=None):
        if self._encoder is not None:
            return {"aux": tree_map(self._tensor,
                                    self.user_params.get("aux", {}))}
        if self.user_params is not None:
            mu = np.asarray(self.user_params["mu"], floatX()).ravel()
            rho = np.asarray(self.user_params["rho"], floatX()).ravel()
            if mu.size != self.ndim or rho.size != self.ndim:
                raise ValueError(
                    f"user params must have {self.ndim} elements, got "
                    f"mu:{mu.size} rho:{rho.size}")
        else:
            mu = self._start_vector(start)
            rho = np.full(self.ndim, _sigma2rho(1.0), dtype=floatX())
        return {"mu": self._tensor(mu), "rho": self._tensor(rho)}

    def _encode(self, aux, draw):
        mu, rho = self._encoder(aux, draw)
        return mu.reshape(-1), rho.reshape(-1)

    def _mu_rho(self, params, draws=None, size=None):
        """``(mu, rho)``: the trainable ones, or the encoder's, one row a
        sample when ``draws`` is given."""
        if self._encoder is None:
            return params["mu"], params["rho"]
        if draws:
            return torch.func.vmap(lambda d: self._encode(params["aux"], d))(
                draws)
        mu, rho = self._encode(params["aux"], None)
        if size is None:
            return mu, rho
        return mu.expand(size, -1), rho.expand(size, -1)

    def _reduce_logq(self, elem):
        """Sum the elementwise logq, scaled for a local group."""
        if self.local:
            return elem @ self._scale
        return torch.sum(elem, dim=-1)

    def sample_q(self, params, eps, draws=None):
        mu, rho = self._mu_rho(params, draws, eps.shape[0])
        sigma = F.softplus(rho)
        z = mu + sigma * eps
        return z, self._reduce_logq(
            -0.5 * (_LOG2PI + 2 * torch.log(sigma) + eps ** 2))

    def logq(self, params, z):
        mu, rho = self._mu_rho(params)
        sigma = F.softplus(rho)
        return self._reduce_logq(-0.5 * (_LOG2PI + 2 * torch.log(sigma)
                                         + ((z - mu) / sigma) ** 2))

    def mean(self, params):
        return self._mu_rho(params)[0]

    def std(self, params):
        return F.softplus(self._mu_rho(params)[1])


class FullRankGroup(Group):
    """Full-rank Gaussian q with a packed lower-triangular factor ``L``
    whose diagonal is ``softplus`` of its packed entries
    (cf. ``approximations.py:140``).

    ``rowwise=True`` factorizes q over the leading axis of its one
    variable (cf. ``approximations.py:144-245``): one full-rank Gaussian
    of ``row_dim`` dimensions for each of ``rows`` rows, so the covariance
    is block diagonal, exactly zero off the blocks."""

    short_name = "full_rank"

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        d = self.ndim
        if self.rowwise:
            if len(self.group_vars) != 1:
                raise ValueError("rowwise groups take exactly one variable")
            shape = np.shape(self.group_vars[0].test_value)
            if len(shape) < 1 or shape[0] < 1:
                raise ValueError("rowwise groups need a leading batch axis")
            self.rows = int(shape[0])
            d = self.row_dim = self.ndim // self.rows
        ii, jj = np.tril_indices(d)
        self._tril = (torch.as_tensor(ii, device=self.device),
                      torch.as_tensor(jj, device=self.device))
        self._tril_flat = torch.as_tensor(ii * d + jj, device=self.device)

    def init_params(self, start=None):
        mu = self._tensor(self._start_vector(start))
        if self.rowwise:
            d = self.row_dim
            tril = np.tile(np.eye(d, dtype=floatX())[np.tril_indices(d)],
                           (self.rows, 1))
            return {"mu": mu, "L_tril": self._tensor(tril)}
        tril = np.eye(self.ndim, dtype=floatX())[np.tril_indices(self.ndim)]
        return {"mu": mu, "L_tril": self._tensor(tril)}

    def _L(self, params):
        """``L`` from the packed vector, with a positive diagonal: one
        ``(row_dim, row_dim)`` factor for each row when ``rowwise``."""
        tril = params["L_tril"]
        if self.rowwise:
            d = self.row_dim
            L = tril.new_zeros((self.rows, d * d)).index_copy(
                1, self._tril_flat, tril).reshape(self.rows, d, d)
        else:
            L = tril.new_zeros((self.ndim, self.ndim)).index_put(self._tril,
                                                                 tril)
        diag = torch.diagonal(L, dim1=-2, dim2=-1)
        return L - torch.diag_embed(diag) + torch.diag_embed(F.softplus(diag))

    def _logdet(self, L):
        return torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)))

    def sample_q(self, params, eps, draws=None):
        L = self._L(params)
        if self.rowwise:
            size = eps.shape[0]
            eps_r = eps.reshape(size, self.rows, self.row_dim)
            z = params["mu"].reshape(self.rows, self.row_dim) + torch.einsum(
                "rij,srj->sri", L, eps_r)
            z = z.reshape(size, self.ndim)
        else:
            z = params["mu"] + eps @ L.T
        return z, _std_normal_logq(eps) - self._logdet(L)

    def logq(self, params, z):
        """The density at ``z`` through a triangular solve."""
        L = self._L(params)
        dz = z - params["mu"]
        dz = dz.reshape(self.rows, self.row_dim, 1) if self.rowwise \
            else dz[:, None]
        w = torch.linalg.solve_triangular(L, dz, upper=False)
        return torch.sum(-0.5 * (_LOG2PI + w ** 2)) - self._logdet(L)

    def mean(self, params):
        return params["mu"]

    def std(self, params):
        return torch.sqrt(torch.sum(self._L(params) ** 2, dim=-1)).reshape(
            self.ndim)

    def cov(self, params):
        L = self._L(params)
        if self.rowwise:
            return torch.block_diag(*(Li @ Li.T for Li in L))
        return L @ L.T


class EmpiricalGroup(Group):
    """A histogram of particles (SVGD, or a trace), cf.
    ``approximations.py:251``. Its noise is ``size`` particle indices."""

    short_name = "empirical"
    has_logq = False

    def __init__(self, *args, size=100, jitter=1, **kwargs):
        self.size = size
        self.jitter = jitter
        super().__init__(*args, **kwargs)

    def init_params(self, start=None):
        """The start point plus ``jitter`` times draws from numpy's global
        generator, as the JAX package does."""
        mu = self._start_vector(start)
        particles = mu[None, :] + self.jitter * np.random.randn(
            self.size, self.ndim).astype(floatX())
        return {"particles": self._tensor(particles)}

    def draw_noise(self, gen, size):
        return torch.randint(0, self.size, (size,), generator=gen,
                             device=self.device)

    def sample_q(self, params, idx, draws=None):
        particles = params["particles"]
        return particles[idx], particles.new_zeros(idx.shape[0])

    def mean(self, params):
        return torch.mean(params["particles"], dim=0)

    def std(self, params):
        return torch.std(params["particles"], dim=0, unbiased=False)

    def cov(self, params):
        p = params["particles"]
        c = p - p.mean(dim=0, keepdim=True)
        return (c.T @ c) / p.shape[0]

    @classmethod
    def from_trace(cls, trace, model=None, **kwargs):
        model = modelcontext(model)
        qs = np.stack([model.dict_to_array(trace.point(i, chain=c))
                       for c in trace.chains for i in range(len(trace))])
        grp = cls(None, size=qs.shape[0], model=model, **kwargs)
        return grp, {"particles": grp._tensor(qs.astype(floatX()))}


class NormalizingFlowGroup(Group):
    """A standard normal pushed through a chain of flows built from a
    formula (``flows.py``), cf. ``approximations.py:300``."""

    short_name = "flow"
    default_flow = "scale-loc"

    def __init__(self, *args, flow=None, **kwargs):
        from .flows import Formula
        self.formula = Formula(flow if flow is not None else
                               self.default_flow)
        super().__init__(*args, **kwargs)

    def init_params(self, start=None):
        self.flows = self.formula.build(self.ndim)
        return {f"f{i}_{k}": self._tensor(v)
                for i, fl in enumerate(self.flows)
                for k, v in fl.init_params().items()}

    def _apply_flows(self, params, z0):
        logdet = z0.new_zeros(z0.shape[:-1])
        z = z0
        for i, fl in enumerate(self.flows):
            prefix = f"f{i}_"
            p = {k[len(prefix):]: v for k, v in params.items()
                 if k.startswith(prefix)}
            z, ld = fl.forward(p, z)
            logdet = logdet + ld
        return z, logdet

    def sample_q(self, params, eps, draws=None):
        z, logdet = self._apply_flows(params, eps)
        return z, _std_normal_logq(eps) - logdet

    def _moments_sample(self, params):
        gen = torch.Generator(device=self.device).manual_seed(0)
        return self.sample_q(params, self._normal(gen, 1000))[0]

    def mean(self, params):
        return torch.mean(self._moments_sample(params), dim=0)

    def std(self, params):
        return torch.std(self._moments_sample(params), dim=0, unbiased=False)


class MeanField(Approximation):
    """cf. ``approximations.py:351``."""

    def __init__(self, *args, model=None, start=None, **kwargs):
        super().__init__(MeanFieldGroup(None, model=model), model=model)
        if start is not None:
            self.params[0] = self.groups[0].init_params(start)


class FullRank(Approximation):
    """cf. ``approximations.py:360``."""

    def __init__(self, *args, model=None, start=None, **kwargs):
        super().__init__(FullRankGroup(None, model=model), model=model)
        if start is not None:
            self.params[0] = self.groups[0].init_params(start)


class Empirical(Approximation):
    """cf. ``approximations.py:366``."""

    def __init__(self, trace=None, size=None, model=None, **kwargs):
        model = modelcontext(model)
        if trace is not None:
            grp, params = EmpiricalGroup.from_trace(trace, model=model)
            super().__init__(grp, model=model)
            self.params[0] = params
        else:
            super().__init__(EmpiricalGroup(None, size=size or 100,
                                            model=model), model=model)

    @property
    def histogram(self):
        return self.params[0]["particles"].detach().cpu().numpy()


class NormalizingFlow(Approximation):
    """cf. ``approximations.py:382``."""

    def __init__(self, flow="scale-loc", model=None, **kwargs):
        super().__init__(NormalizingFlowGroup(None, flow=flow, model=model),
                         model=model)


def sample_approx(approx, draws=100, include_transformed=True,
                  random_seed=None):
    """Draws from a variational posterior as a MultiTrace
    (cf. ``approximations.py:388``)."""
    if not isinstance(approx, Approximation):
        raise TypeError(f"Need Approximation instance, got {type(approx)}")
    return approx.sample(draws=draws, include_transformed=include_transformed,
                         random_seed=random_seed)
