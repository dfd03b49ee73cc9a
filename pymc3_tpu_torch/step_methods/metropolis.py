"""Metropolis samplers (cf. ``pymc3_tpu/step_methods/metropolis.py``).

Every stepper advances all chains at once: ``q`` is ``(chains, n)``, the
acceptance test is one ``(chains,)`` comparison, and the model's logp is the
batched gradient-free function (``Model.make_logp_fn``). The random numbers
come from the ``noise`` object (``arraystep.GeneratorNoise``): a proposal
``(chains, dim)``, an acceptance uniform ``(chains,)``, flips, a permutation
per chain, category jumps, population and history indices.

What lives where: proposal scales, acceptance counts and the DEMetropolisZ
history are per-chain tensors on the device; the tuning schedule
(``since_tune`` and whether this draw tunes) depends on the draw index
alone and is a host integer, so no transition reads a value back from the
device.

The Gibbs scans (``BinaryGibbsMetropolis``, ``CategoricalGibbsMetropolis``)
call the batched logp once per coordinate, in a Python loop over
coordinates with the whole chain batch in each call. With ``order="random"``
every chain visits its coordinates in its own random order, as in the JAX
package (one permutation per chain, gathered per step).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..config import floatX, torch_floatX
from ..model import modelcontext
from ..vartypes import continuous_types, discrete_types
from .arraystep import (
    ArrayStepShared, Competence, TuneContext, metrop_select,
)

__all__ = [
    "Metropolis", "BinaryMetropolis", "BinaryGibbsMetropolis",
    "CategoricalGibbsMetropolis", "DEMetropolis", "DEMetropolisZ",
    "NormalProposal", "UniformProposal", "CauchyProposal", "LaplaceProposal",
    "PoissonProposal", "MultivariateNormalProposal", "tune_scaling",
]


# ---------------------------------------------------------------------------
# Proposal distributions (cf. metropolis.py:35-84)
# ---------------------------------------------------------------------------
class Proposal:
    """A proposal of scale ``s``; ``sample(noise, dim)`` gives one jump per
    chain, ``(chains, dim)``, from the noise object's draws."""

    def __init__(self, s):
        self.s = np.asarray(s)
        self._on = {}

    def _scale(self, device, what="s"):
        """The scale as a tensor on ``device``, copied there once."""
        key = (what, device)
        if key not in self._on:
            self._on[key] = torch.as_tensor(floatX(getattr(self, what)),
                                            device=device)
        return self._on[key]


class NormalProposal(Proposal):
    def sample(self, noise, dim):
        return noise.normal(dim) * self._scale(noise.device)


class UniformProposal(Proposal):
    def sample(self, noise, dim):
        return (2.0 * noise.uniform(dim) - 1.0) * self._scale(noise.device)


class CauchyProposal(Proposal):
    def sample(self, noise, dim):
        u = noise.uniform(dim)
        return torch.tan(math.pi * (u - 0.5)) * self._scale(noise.device)


class LaplaceProposal(Proposal):
    def sample(self, noise, dim):
        # inverse CDF on u - 1/2, kept off the end where log(0) waits
        v = torch.clamp(noise.uniform(dim) - 0.5, min=-0.5 + 1e-7)
        x = -torch.sign(v) * torch.log1p(-2.0 * torch.abs(v))
        return x * self._scale(noise.device)


class PoissonProposal(Proposal):
    def sample(self, noise, dim):
        lam = torch.broadcast_to(self._scale(noise.device), (dim,))
        return noise.poisson(lam) - lam


class MultivariateNormalProposal(Proposal):
    def __init__(self, s):
        n, m = np.asarray(s).shape
        if n != m:
            raise ValueError("Covariance matrix is not symmetric.")
        super().__init__(s)
        self.n = n
        self.chol = np.linalg.cholesky(s)

    def sample(self, noise, dim=None):
        return noise.normal(self.n) @ self._scale(noise.device, "chol").T


# ---------------------------------------------------------------------------
# Scaling-tune table (cf. metropolis.py:90)
# ---------------------------------------------------------------------------
def tune_scaling(scale, acc_rate):
    """Proposal-scale tuning from the acceptance rate over the last
    ``tune_interval`` draws, branchless on the device (cf. ``tune``,
    ``metropolis.py:90``): the first matching row of

        < 0.001: x0.1   < 0.05: x0.5   < 0.2: x0.9
        > 0.95: x10     > 0.75: x2     > 0.5: x1.1     else x1
    """
    factor = torch.ones_like(acc_rate)
    for cond, f in ((acc_rate > 0.5, 1.1), (acc_rate > 0.75, 2.0),
                    (acc_rate > 0.95, 10.0), (acc_rate < 0.2, 0.9),
                    (acc_rate < 0.05, 0.5), (acc_rate < 0.001, 0.1)):
        factor = torch.where(cond, f, factor)
    return scale * factor


def _metropolis_ratio(logp_prop, logp0):
    mr = logp_prop - logp0
    return torch.where(torch.isnan(mr), -torch.inf, mr)


def _full(value, like, dtype=None):
    """A host value as one entry per chain."""
    return torch.full(like.shape[:1], value, dtype=dtype, device=like.device)


class MetropolisState(NamedTuple):
    logp: torch.Tensor        # (chains,)
    scaling: torch.Tensor     # (chains,)
    accept_sum: torch.Tensor  # accepted draws since the last tune (chains,)
    since_tune: int           # draws since the last tune


class Metropolis(ArrayStepShared):
    """Random-walk Metropolis (cf. ``metropolis.py:109``). Proposals for
    discrete coordinates are rounded; a 2-d ``S`` is a covariance and gives
    a :class:`MultivariateNormalProposal`."""

    name = "metropolis"
    default_blocked = False
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, scaling=1.0,
                 tune=True, tune_interval=100, model=None, mode=None,
                 blocked=False, **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.free_RVs
        self._setup_vars(vars, model)
        self.blocked = blocked

        if S is None:
            S = np.ones(self.dim)
        if proposal_dist is not None:
            self.proposal_dist = proposal_dist(S)
        elif np.asarray(S).ndim == 1:
            self.proposal_dist = NormalProposal(S)
        elif np.asarray(S).ndim == 2:
            self.proposal_dist = MultivariateNormalProposal(S)
        else:
            raise ValueError(f"Invalid rank for variance: {np.asarray(S).ndim}")

        self.scaling = float(np.atleast_1d(scaling)[0])
        self.tune = bool(tune)
        self.tune_interval = int(tune_interval)

        # which of our coordinates are discrete (cf. metropolis.py:146)
        disc = np.zeros(self.dim, dtype=bool)
        off = 0
        for v in self.vars:
            n = int(np.prod(v.unconstrained_shape, dtype=int))
            if str(np.dtype(v.distribution.dtype)) in discrete_types:
                disc[off:off + n] = True
            off += n
        self.discrete = disc
        self.any_discrete = bool(disc.any())
        self.all_discrete = bool(disc.all())
        self._disc_mask = torch.as_tensor(disc, device=model.device)

        self._logp_fn = model.make_logp_fn()

    def kernel_init(self, q0):
        logp = self._logp_fn(q0)
        return MetropolisState(
            logp=logp, scaling=torch.full_like(logp, self.scaling),
            accept_sum=torch.zeros_like(logp), since_tune=0)

    def kernel_step(self, q, state: MetropolisState, tctx: TuneContext,
                    noise):
        logp0 = self._refresh_logp(q, state.logp)
        delta = self.proposal_dist.sample(noise, self.dim) \
            * state.scaling[:, None]
        x_prop = self._sub(q) + delta
        if self.any_discrete:
            x_prop = torch.where(self._disc_mask, torch.round(x_prop), x_prop)
        q_prop = self._scatter(q, x_prop)

        logp_prop = self._logp_fn(q_prop)
        mr = _metropolis_ratio(logp_prop, logp0)
        q_new, accepted = metrop_select(mr, q_prop, q, noise.uniform())
        logp_new = torch.where(accepted, logp_prop, logp0)

        # scale tuning every tune_interval draws while tuning
        since = state.since_tune + 1
        acc_sum = state.accept_sum + accepted.to(logp0.dtype)
        scaling = state.scaling
        if tctx.tune and self.tune and since >= self.tune_interval:
            scaling = tune_scaling(scaling, acc_sum / since)
            since, acc_sum = 0, torch.zeros_like(acc_sum)

        stats = {
            "accept": torch.exp(torch.clamp(mr, max=0.0)),
            "accepted": accepted,
            "tune": _full(tctx.tune, accepted),
            "scaling": scaling,
        }
        return q_new, MetropolisState(logp_new, scaling, acc_sum, since), stats

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.COMPATIBLE


class BinaryState(NamedTuple):
    logp: torch.Tensor


def _require_binary(vars, name):
    for v in vars:
        if not _is_binary(v):
            raise ValueError(f"All variables must be Bernoulli for {name}")


class BinaryMetropolis(ArrayStepShared):
    """Metropolis for binary variables (cf. ``metropolis.py:221``): flips
    each of its coordinates with probability ``p_jump``."""

    name = "binary_metropolis"
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "tune": bool,
        "p_jump": np.float64,
    }]

    def __init__(self, vars, scaling=1.0, tune=True, tune_interval=100,
                 model=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self.scaling = float(scaling)
        self.tune = bool(tune)
        self._logp_fn = model.make_logp_fn()
        _require_binary(self.vars, "BinaryMetropolis")

    def kernel_init(self, q0):
        return BinaryState(logp=self._logp_fn(q0))

    def kernel_step(self, q, state, tctx, noise):
        p_jump = min(0.5, self.scaling / self.dim) * 2
        flips = noise.uniform(self.dim) < p_jump
        sub = self._sub(q)
        q_prop = self._scatter(q, torch.where(flips, 1.0 - sub, sub))
        logp0 = self._refresh_logp(q, state.logp)
        logp_prop = self._logp_fn(q_prop)
        mr = _metropolis_ratio(logp_prop, logp0)
        q_new, accepted = metrop_select(mr, q_prop, q, noise.uniform())
        logp_new = torch.where(accepted, logp_prop, logp0)
        stats = {
            "accept": torch.exp(torch.clamp(mr, max=0.0)),
            "tune": _full(tctx.tune, accepted),
            "p_jump": _full(p_jump, mr),
        }
        return q_new, BinaryState(logp_new), stats

    @staticmethod
    def competence(var, has_grad=False):
        if _is_binary(var):
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE


class _GibbsScan(ArrayStepShared):
    """What the two coordinate scans share: the visiting order and the loop
    that proposes one coordinate per chain, calls the batched logp and
    accepts per chain."""

    generates_stats = True
    stats_dtypes = [{"tune": bool}]

    def _setup_scan(self, vars, model, order):
        self._setup_vars(vars, model)
        self.shuffle = isinstance(order, str) and order == "random"
        self._order = np.arange(self.dim) if self.shuffle \
            else np.asarray(order)
        self._order_t = torch.as_tensor(self._order, device=model.device)
        self._logp_fn = model.make_logp_fn()

    def kernel_init(self, q0):
        return BinaryState(logp=self._logp_fn(q0))

    def _visit_order(self, noise, chains):
        """(chains, n_visits) indices into this stepper's coordinates."""
        if self.shuffle:
            return noise.permutation(self.dim)
        return self._order_t.expand(chains, -1)

    def _propose(self, curr, local, noise):
        """Proposed values ``(chains,)`` for the coordinates ``local`` now
        at ``curr``, and which chains propose at all."""
        raise NotImplementedError

    def kernel_step(self, q, state, tctx, noise):
        logp = self._refresh_logp(q, state.logp)
        order = self._visit_order(noise, q.shape[0])
        for i in range(order.shape[1]):
            local = order[:, i]
            gidx = self._sub_idx[local][:, None]
            curr = q.gather(1, gidx)[:, 0]
            prop, do_prop = self._propose(curr, local, noise)
            q_prop = q.scatter(1, gidx, prop[:, None])
            logp_prop = self._logp_fn(q_prop)
            mr = _metropolis_ratio(logp_prop, logp)
            accepted = do_prop & (torch.log(noise.uniform()) < mr)
            q = torch.where(accepted[:, None], q_prop, q)
            logp = torch.where(accepted, logp_prop, logp)
        return q, BinaryState(logp), {"tune": _full(tctx.tune, logp,
                                                    torch.bool)}


class BinaryGibbsMetropolis(_GibbsScan):
    """Gibbs-style scan over binary coordinates, each flipped with
    probability ``transit_p`` and then accepted or not
    (cf. ``metropolis.py:279``)."""

    name = "binary_gibbs_metropolis"

    def __init__(self, vars, order="random", transit_p=0.8, model=None,
                 **kwargs):
        model = modelcontext(model)
        self._setup_scan(vars, model, order)
        self.transit_p = float(transit_p)
        _require_binary(self.vars, "BinaryGibbsMetropolis")

    def _propose(self, curr, local, noise):
        do_prop = noise.uniform() < self.transit_p
        return torch.where(do_prop, 1.0 - curr, curr), do_prop

    @staticmethod
    def competence(var, has_grad=False):
        if _is_binary(var):
            return Competence.IDEAL
        return Competence.INCOMPATIBLE


class CategoricalGibbsMetropolis(_GibbsScan):
    """Gibbs scan over categorical coordinates; each proposal is a uniform
    jump to one of the other categories (cf. ``metropolis.py:339``). A
    binary variable counts as two categories."""

    name = "categorical_gibbs_metropolis"

    def __init__(self, vars, proposal="uniform", order="random", model=None,
                 **kwargs):
        model = modelcontext(model)
        self._setup_scan(vars, model, order)
        # categories per flat coordinate
        ks = []
        for v in self.vars:
            dist = _effective_dist(v)
            k = 2 if _is_binary(v) else _cat_k(dist)
            if k < 2:
                raise ValueError("All variables must be categorical or "
                                 "binary for CategoricalGibbsMetropolis")
            ks.extend([k] * int(np.prod(v.unconstrained_shape, dtype=int)))
        self._k = np.asarray(ks, dtype=np.int64)
        self.max_k = int(self._k.max()) if len(ks) else 2
        self._k_t = torch.as_tensor(self._k, device=model.device)
        self.proposal = proposal

    def _propose(self, curr, local, noise):
        k_cat = self._k_t[local]
        jump = 1 + noise.randint(1, self.max_k) % (k_cat - 1)
        prop = (curr.long() + jump) % k_cat
        return prop.to(curr.dtype), torch.ones_like(curr, dtype=torch.bool)

    @staticmethod
    def competence(var, has_grad=False):
        dist = _effective_dist(var)
        if type(dist).__name__ == "Categorical":
            k = _cat_k(dist) or 3
            return Competence.IDEAL if k > 2 else Competence.COMPATIBLE
        if _is_binary(var):
            return Competence.COMPATIBLE
        return Competence.INCOMPATIBLE


def _effective_dist(var_or_dist):
    """The distribution that decides a sampler's competence: an imputation
    placeholder (``NoDistribution``) defers to its parent."""
    dist = getattr(var_or_dist, "distribution", var_or_dist)
    parent = getattr(dist, "parent_dist", None)
    return parent if parent is not None else dist


def _is_binary(var):
    dist = _effective_dist(var)
    return type(dist).__name__ == "Bernoulli" or \
        (type(dist).__name__ == "Categorical" and _cat_k(dist) == 2)


def _cat_k(dist):
    k = getattr(dist, "k", None)
    try:
        return int(np.asarray(k if not hasattr(k, "test_value")
                              else k.test_value).item())
    except (TypeError, ValueError):
        return 0


def _continuous_competence(var):
    dist = getattr(var, "distribution", None)
    dtype = getattr(dist, "dtype", None) or getattr(var, "dtype", None)
    if str(np.dtype(dtype)) in continuous_types:
        return Competence.COMPATIBLE
    return Competence.INCOMPATIBLE


# ---------------------------------------------------------------------------
# Differential evolution (population) methods
# ---------------------------------------------------------------------------
def _check_tune_target(tune):
    if tune not in {None, "scaling", "lambda"}:
        raise ValueError(
            'The parameter "tune" must be one of {None, scaling, lambda}')


class DEMState(NamedTuple):
    logp: torch.Tensor        # (chains,)
    scaling: torch.Tensor     # one value for the population, 0-d
    accept_sum: torch.Tensor  # 0-d
    since_tune: int


class DEMetropolis(ArrayStepShared):
    """Differential-evolution Metropolis over a chain population
    (cf. ``metropolis.py:457``).

    ``population_kernel_step`` steps the whole population at once: it is
    one ``(chains, n)`` tensor on the device and the crossover is a gather
    along the chain dimension.
    """

    name = "DEMetropolis"
    population_based = True
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
        "lambda": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None,
                 scaling=0.001, tune=None, tune_interval=100, model=None,
                 **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        self.scaling = float(np.atleast_1d(scaling)[0])
        if lamb is None:
            lamb = 2.38 / np.sqrt(2 * self.dim)
        self.lamb = float(lamb)
        _check_tune_target(tune)
        self.tune_target = tune
        self.tune = True
        self.tune_interval = int(tune_interval)
        self._logp_fn = model.make_logp_fn()
        self._mask = _own_columns(self, model)

    def kernel_init(self, Q0):
        logp = self._logp_fn(Q0)
        zero = torch.zeros((), dtype=logp.dtype, device=logp.device)
        return DEMState(logp=logp, scaling=zero + self.scaling,
                        accept_sum=zero, since_tune=0)

    def population_kernel_step(self, Q, state: DEMState, tctx: TuneContext,
                               noise):
        """Step all chains at once; ``Q`` is ``(chains, n)``."""
        nchains = Q.shape[0]
        # two random other chains per chain
        i = torch.arange(nchains, device=Q.device)
        r1 = noise.randint(0, nchains - 1)
        r1 = torch.where(r1 >= i, r1 + 1, r1)
        r2 = noise.randint(0, nchains - 1)
        r2 = torch.where(r2 >= i, r2 + 1, r2)

        eps = noise.normal(Q.shape[1]) * state.scaling
        delta = self.lamb * (Q[r1] - Q[r2]) + eps
        Q_prop = Q + delta * self._mask

        logp0 = self._refresh_logp(Q, state.logp)
        logp_prop = self._logp_fn(Q_prop)
        mr = _metropolis_ratio(logp_prop, logp0)
        Q_new, accepted = metrop_select(mr, Q_prop, Q, noise.uniform())
        logp_new = torch.where(accepted, logp_prop, logp0)

        since = state.since_tune + 1
        acc_sum = state.accept_sum + accepted.to(logp0.dtype).mean()
        scaling = state.scaling
        if tctx.tune and self.tune_target == "scaling" \
                and since >= self.tune_interval:
            scaling = tune_scaling(scaling, acc_sum / since)
            since, acc_sum = 0, torch.zeros_like(acc_sum)

        stats = {
            "accept": torch.exp(torch.clamp(mr, max=0.0)),
            "accepted": accepted,
            "tune": _full(tctx.tune, accepted),
            "scaling": scaling.expand(nchains),
            "lambda": _full(self.lamb, mr),
        }
        return Q_new, DEMState(logp_new, scaling, acc_sum, since), stats

    @staticmethod
    def competence(var, has_grad=False):
        return _continuous_competence(var)


def _own_columns(step, model):
    """1 on the stepper's columns of the flat vector, 0 elsewhere."""
    mask = torch.zeros(model.ordering.size, dtype=torch_floatX(),
                       device=model.device)
    mask[step._sub_idx] = 1.0
    return mask


class DEMZState(NamedTuple):
    logp: torch.Tensor        # (chains,)
    scaling: torch.Tensor     # (chains,)
    lamb: torch.Tensor        # (chains,)
    accept_sum: torch.Tensor  # (chains,)
    since_tune: int
    history: torch.Tensor     # (capacity, chains, n) ring of past points
    hist_len: int             # points written so far


class DEMetropolisZ(ArrayStepShared):
    """DE-MCMC-Z: differential evolution against each chain's own history
    (cf. ``metropolis.py:573``).

    The history is a ring of ``history_capacity`` points per chain, one
    ``(capacity, chains, n)`` tensor on the device. A transition writes its
    slot in place: a state handed to ``kernel_step`` is spent.
    """

    name = "DEMetropolisZ"
    generates_stats = True
    stats_dtypes = [{
        "accept": np.float64,
        "accepted": bool,
        "tune": bool,
        "scaling": np.float64,
        "lambda": np.float64,
    }]

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None,
                 scaling=0.001, tune="lambda", tune_interval=100,
                 tune_drop_fraction=0.9, model=None, history_capacity=5000,
                 **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        self.scaling = float(np.atleast_1d(scaling)[0])
        if lamb is None:
            lamb = 2.38 / np.sqrt(2 * self.dim)
        self.lamb = float(lamb)
        _check_tune_target(tune)
        self.tune_target = tune
        self.tune = True
        self.tune_interval = int(tune_interval)
        self.tune_drop_fraction = float(tune_drop_fraction)
        self.capacity = int(history_capacity)
        self._logp_fn = model.make_logp_fn()
        self._mask = _own_columns(self, model)

    def kernel_init(self, q0):
        logp = self._logp_fn(q0)
        return DEMZState(
            logp=logp, scaling=torch.full_like(logp, self.scaling),
            lamb=torch.full_like(logp, self.lamb),
            accept_sum=torch.zeros_like(logp), since_tune=0,
            history=q0.new_zeros((self.capacity,) + tuple(q0.shape)),
            hist_len=0)

    def kernel_step(self, q, state: DEMZState, tctx: TuneContext, noise):
        chains = q.shape[0]
        eps = noise.normal(q.shape[1]) * state.scaling[:, None]
        # the DE jump from two random points of the chain's history, once
        # it holds two
        filled = min(state.hist_len, self.capacity)
        i1 = noise.randint(0, max(filled, 1))
        i2 = noise.randint(0, max(filled, 1))
        delta = eps
        if state.hist_len >= 2:
            lane = torch.arange(chains, device=q.device)
            z1 = state.history[i1, lane]
            z2 = state.history[i2, lane]
            delta = state.lamb[:, None] * (z1 - z2) + eps
        q_prop = q + delta * self._mask

        logp0 = self._refresh_logp(q, state.logp)
        logp_prop = self._logp_fn(q_prop)
        mr = _metropolis_ratio(logp_prop, logp0)
        q_new, accepted = metrop_select(mr, q_prop, q, noise.uniform())
        logp_new = torch.where(accepted, logp_prop, logp0)

        state.history[state.hist_len % self.capacity] = q_new
        hist_len = min(state.hist_len + 1, 2 ** 30)

        since = state.since_tune + 1
        acc_sum = state.accept_sum + accepted.to(logp0.dtype)
        scaling, lamb = state.scaling, state.lamb
        if tctx.tune and since >= self.tune_interval:
            if self.tune_target == "scaling":
                scaling = tune_scaling(scaling, acc_sum / since)
            elif self.tune_target == "lambda":
                lamb = tune_scaling(lamb, acc_sum / since)
            since, acc_sum = 0, torch.zeros_like(acc_sum)

        stats = {
            "accept": torch.exp(torch.clamp(mr, max=0.0)),
            "accepted": accepted,
            "tune": _full(tctx.tune, accepted),
            "scaling": scaling,
            "lambda": lamb,
        }
        return q_new, DEMZState(logp_new, scaling, lamb, acc_sum, since,
                                state.history, hist_len), stats

    @staticmethod
    def competence(var, has_grad=False):
        return _continuous_competence(var)
