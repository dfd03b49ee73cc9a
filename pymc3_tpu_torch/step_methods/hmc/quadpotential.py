"""Mass matrices (cf. ``pymc3_tpu/step_methods/hmc/quadpotential.py``).

The adaptive diagonal potential keeps two Welford variance estimators
(foreground / background) per chain, the foreground refreshed from the
background every ``adaptation_window`` tuning draws. The adaptive dense
potential does the same with covariance estimators and Stan-style doubling
windows. Pooled adaptation merges the per-chain ``(w, mean, M2)`` triples
exactly; where the JAX package used ``psum`` over the vmapped chain axis,
here the chains are dim 0 and the merge is a sum over it.

A kernel threads the inverse mass through its leapfrogs as one tensor
(:func:`kernel_mass`): the diagonal ``(chains, n)``, or a dense ``(1, n, n)``
(one matrix for every chain: fixed, or pooled) or ``(chains, n, n)`` (per
chain). :func:`mass_velocity` tells them apart by rank. A dense momentum
solves ``Lᵀ p = z`` for the standard normal ``z`` the kernel's noise gives.

The dense update guards against a covariance estimate that is not positive
definite without a host sync: ``cholesky_ex`` reports it in ``info``, and
``torch.where`` keeps the previous factor for that chain (the branchless
analog of the reference catching ``LinAlgError``).

The fixed potentials (``QuadPotentialDiag``, ``QuadPotentialFull``,
``QuadPotentialFullInv``) and the adaptive ones keep the JAX package's
host-side methods of one chain (``velocity``, ``energy``, ``random``,
``update``, and for the adaptive diagonal ``raise_ok`` and ``reset``), which
work on numpy arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import default_device, floatX, torch_floatX

__all__ = [
    "QuadPotential", "QuadPotentialDiag", "QuadPotentialDiagAdapt",
    "QuadPotentialDiagAdaptGrad", "QuadPotentialFull", "QuadPotentialFullInv", "QuadPotentialFullAdapt",
    "quad_potential", "PositiveDefiniteError", "isquadpotential",
    "WelfordState", "welford_init", "welford_add", "welford_var",
    "welford_merge_pooled", "welford_merge_psum",
    "DiagAdaptState", "diag_adapt_init", "diag_adapt_update",
    "diag_velocity", "diag_kinetic", "diag_random",
    "WelfordCovState", "welford_cov_init", "welford_cov_add",
    "welford_cov_merge_pooled", "welford_cov_merge_psum",
    "DenseState", "DenseAdaptState", "dense_adapt_init",
    "dense_adapt_update", "mass_velocity", "dense_random", "kernel_mass",
    "kernel_momentum", "kernel_update",
]


class PositiveDefiniteError(ValueError):
    """cf. ``quadpotential.py:35``."""

    def __init__(self, msg, idx):
        super().__init__(msg)
        self.idx = idx
        self.msg = msg

    def __str__(self):
        return f"Scaling is not positive definite: {self.msg}. Check indexes {self.idx}."


def partial_check_positive_definite(C):
    """A simple but partial positive-definiteness check (cf.
    ``quadpotential.py:47``)."""
    C_ = np.asarray(C)
    d = C_ if C_.ndim == 1 else np.diag(C_)
    (i,) = np.nonzero(np.logical_or(np.isnan(d), d <= 0))
    if len(i):
        raise PositiveDefiniteError(
            "Simple check failed. Diagonal contains negatives", i)


# -- diagonal ----------------------------------------------------------------
class WelfordState(NamedTuple):
    w: torch.Tensor      # total weight (chains,)
    mean: torch.Tensor   # running mean (chains, n)
    m2: torch.Tensor     # sum of squared deviations (chains, n)


def welford_zeros(chains, n, device):
    return welford_init(n, torch.zeros((chains, n), dtype=torch_floatX(),
                                       device=device))


def _init_tensors(n, init_mean, init_m2, init_weight, shape):
    """``(w, mean, m2)``: ``mean`` of ``(n,)`` (one chain) or ``(chains,
    n)``, on ``init_mean``'s device or the configured one."""
    dt = torch_floatX()
    device = init_mean.device if torch.is_tensor(init_mean) \
        else default_device()
    mean = torch.zeros(n, dtype=dt, device=device) if init_mean is None \
        else torch.as_tensor(init_mean, dtype=dt, device=device).clone()
    batch = tuple(mean.shape[:-1])
    m2 = torch.zeros(batch + shape, dtype=dt, device=device) \
        if init_m2 is None else (torch.as_tensor(
            init_m2, dtype=dt, device=device) * init_weight).expand(
                batch + shape).clone()
    return (torch.full(batch, float(init_weight), dtype=dt, device=device),
            mean, m2)


def welford_init(n, init_mean=None, init_var=None, init_weight=0.0):
    """A Welford variance state of ``n`` coordinates (cf.
    ``quadpotential.py:68``): of one chain, as in the JAX package, or of
    ``chains`` when ``init_mean`` is ``(chains, n)``."""
    return WelfordState(*_init_tensors(n, init_mean, init_var, init_weight,
                                       (n,)))


def welford_add(state: WelfordState, x, weight=1.0) -> WelfordState:
    """cf. ``_WeightedVariance.add_sample`` (``quadpotential.py:336-342``)."""
    w = state.w + weight
    prop = (weight / w)[..., None]
    delta = x - state.mean
    mean = state.mean + prop * delta
    m2 = state.m2 + weight * delta * (x - mean)
    return WelfordState(w, mean, m2)


def _chains_sum(x, mesh=None):
    """``x`` summed over dim 0 in float64 and, with ``mesh``, over the
    ranks. Float64 makes the float32 result independent, but in the rare
    case of a tie at a rounding boundary, of how the chains are split
    among the ranks."""
    total = x.to(torch.float64).sum(0)
    return total if mesh is None else mesh.sum(total)


def welford_merge_pooled(state: WelfordState, mesh=None) -> WelfordState:
    """Exact pooled merge over all chains (dim 0), and over the ranks of
    ``mesh``, broadcast back to every chain (cf. ``welford_merge_psum``,
    quadpotential.py:93-101): the global weight and weighted mean first,
    then ``M2 + w (mean - mean_tot)^2``, each summed."""
    dtype = state.mean.dtype
    first = _chains_sum(torch.cat([state.w[:, None],
                                 state.w[:, None] * state.mean], 1), mesh)
    w_tot = first[0]
    mean_tot = (first[1:] / w_tot).to(dtype)
    m2_tot = _chains_sum(state.m2 + state.w[:, None]
                       * (state.mean - mean_tot) ** 2, mesh).to(dtype)
    return WelfordState(w_tot.to(dtype).expand_as(state.w),
                        mean_tot.expand_as(state.mean),
                        m2_tot.expand_as(state.m2))


def welford_var(state: WelfordState):
    """The variance estimate ``m2 / w`` (cf. ``quadpotential.py:88``)."""
    return state.m2 / state.w[..., None]


def _axis_mesh(axis_name):
    """The mesh that a merge over ``axis_name`` reduces over besides the
    chains of dim 0: a name other than ``parallel.LOCAL_CHAIN_AXIS`` (see
    ``parallel.pooled_axes``) is this process's chain axis over its ranks
    (the identity outside a process group)."""
    from ...parallel import LOCAL_CHAIN_AXIS, make_mesh
    names = axis_name if isinstance(axis_name, (tuple, list)) \
        else (axis_name,)
    ranks = [n for n in names if n != LOCAL_CHAIN_AXIS]
    return make_mesh(axis_name=ranks[0]) if ranks else None


def welford_merge_psum(state: WelfordState, axis_name) -> WelfordState:
    """The JAX package's exact pooled merge over the named axis (cf.
    ``quadpotential.py:93``): every chain of dim 0, and with a rank axis
    every rank's, gets the pooled state (:func:`welford_merge_pooled`)."""
    return welford_merge_pooled(state, _axis_mesh(axis_name))


def _promote(window_end, a, b):
    """Lane-wise ``window_end ? a : b`` over the fields of two states."""
    def sel(x, y):
        we = window_end.reshape(window_end.shape + (1,) * (x.ndim - 1))
        return torch.where(we, x, y)
    return type(a)(*map(sel, a, b))


class DiagAdaptState(NamedTuple):
    """QuadPotentialDiagAdapt state, one row per chain."""

    var: torch.Tensor        # current M^{-1} diagonal (chains, n)
    inv_stds: torch.Tensor   # 1/sqrt(var), for momentum draws
    fg: WelfordState
    bg: WelfordState
    n_samples: torch.Tensor  # tuning draws seen (chains,) int32


def diag_adapt_init(initial_mean, initial_diag, initial_weight,
                    chains) -> DiagAdaptState:
    """cf. ``QuadPotentialDiagAdapt.__init__`` (``quadpotential.py:140``);
    ``initial_mean``/``initial_diag``: ``(n,)`` tensors."""
    n = initial_mean.shape[-1]
    device = initial_mean.device
    fg = welford_init(n, initial_mean.expand(chains, n), initial_diag,
                      initial_weight)
    var = welford_var(fg)
    return DiagAdaptState(
        var=var, inv_stds=1.0 / torch.sqrt(var),
        fg=fg, bg=welford_zeros(chains, n, device),
        n_samples=torch.zeros(chains, dtype=torch.int32, device=device))


def _pooled_from_axis_name(axis_name, pooled):
    """``pooled`` given the JAX package's ``axis_name``: a name means
    pooled over the chain axis, as its ``psum`` over the vmapped chains;
    ``None`` leaves ``pooled`` (unpooled by default). A name with
    ``pooled=False`` disagrees and raises."""
    if axis_name is None:
        return bool(pooled)
    if pooled is not None and not pooled:
        raise ValueError(f"axis_name={axis_name!r} pools over the chains; "
                         "pooled=False disagrees")
    return True


def diag_adapt_update(state: DiagAdaptState, sample, tune: bool,
                      adaptation_window=101, axis_name=None, pooled=None,
                      mesh=None) -> DiagAdaptState:
    """One adaptation step (cf. ``diag_adapt_update``, quadpotential.py:136):
    add the sample to both estimators, refresh ``var`` from the foreground
    (pooled over chains with ``pooled`` or an ``axis_name``, and over the
    ranks of ``mesh``), and at window ends promote the background to the
    foreground."""
    pooled = _pooled_from_axis_name(axis_name, pooled)
    if not tune:
        return state
    fg = welford_add(state.fg, sample)
    bg = welford_add(state.bg, sample)
    fg_for_var = welford_merge_pooled(fg, mesh) if pooled else fg
    var = fg_for_var.m2 / fg_for_var.w[:, None]

    n = state.n_samples + 1
    window_end = (n % adaptation_window) == 0
    if pooled:
        # early promotions at n = 3/10/25 once the pooled sample count
        # clears 1024 (as in the JAX package): the global chain count
        chains = sample.shape[0] * (1 if mesh is None else mesh.world_size)
        early = (n == 3) | (n == 10) | (n == 25)
        window_end = window_end | (early & (chains * n.to(var.dtype) >= 1024.0))
    zero = welford_zeros(*sample.shape, sample.device)
    return DiagAdaptState(var=var, inv_stds=1.0 / torch.sqrt(var),
                          fg=_promote(window_end, bg, fg),
                          bg=_promote(window_end, zero, bg), n_samples=n)


def diag_velocity(var, p):
    """v = M^{-1} p for the diagonal ``var`` (cf. ``quadpotential.py:191``)."""
    return var * p


def diag_kinetic(var, p):
    """0.5 pᵀ M^{-1} p for the diagonal ``var`` (cf.
    ``quadpotential.py:196``)."""
    return 0.5 * torch.sum(p * (var * p), dim=-1)


def diag_random(gen, inv_stds):
    """Momentum p ~ N(0, M) (cf. ``quadpotential.py:200``), drawn by the
    ``torch.Generator`` ``gen`` (the JAX package takes a key)."""
    return inv_stds * torch.randn(inv_stds.shape, generator=gen,
                                  dtype=inv_stds.dtype,
                                  device=inv_stds.device)


# -- dense -------------------------------------------------------------------
class WelfordCovState(NamedTuple):
    """Weighted covariance accumulator (cf. ``_WeightedCovariance``,
    ``quadpotential.py:241``)."""

    w: torch.Tensor      # (chains,)
    mean: torch.Tensor   # (chains, n)
    m2: torch.Tensor     # sum of outer products of deviations (chains, n, n)


def welford_cov_zeros(chains, n, device):
    return welford_cov_init(n, torch.zeros((chains, n), dtype=torch_floatX(),
                                           device=device))


def welford_cov_init(n, init_mean=None, init_cov=None, init_weight=0.0):
    """A weighted covariance state of ``n`` coordinates (cf.
    ``quadpotential.py:251``): of one chain, or of ``chains`` when
    ``init_mean`` is ``(chains, n)``."""
    return WelfordCovState(*_init_tensors(n, init_mean, init_cov,
                                          init_weight, (n, n)))


def welford_cov_add(state: WelfordCovState, x, weight=1.0):
    """cf. ``welford_cov_add`` (``quadpotential.py:260``)."""
    w = state.w + weight
    delta = x - state.mean
    mean = state.mean + (weight / w)[..., None] * delta
    m2 = state.m2 + weight * delta[..., :, None] * (x - mean)[..., None, :]
    return WelfordCovState(w, mean, m2)


def welford_cov_merge_pooled(state: WelfordCovState,
                             mesh=None) -> WelfordCovState:
    """Exact pooled covariance merge over all chains (dim 0), and over the
    ranks of ``mesh``, with the rank-1 mean-shift term (cf.
    ``welford_cov_merge_psum``, quadpotential.py:268-274). Returns one
    accumulator, a leading dim of 1."""
    dtype = state.mean.dtype
    first = _chains_sum(torch.cat([state.w[:, None],
                                 state.w[:, None] * state.mean], 1), mesh)
    w_tot = first[:1]
    mean_tot = (first[1:] / first[0]).to(dtype)[None]
    d = state.mean - mean_tot
    m2_tot = _chains_sum(state.m2 + state.w[:, None, None] * d[:, :, None]
                       * d[:, None, :], mesh).to(dtype)[None]
    return WelfordCovState(w_tot.to(dtype), mean_tot, m2_tot)


def welford_cov_merge_psum(state: WelfordCovState,
                           axis_name) -> WelfordCovState:
    """The JAX package's exact pooled covariance merge over the named axis
    (cf. ``welford_cov_merge_psum``): :func:`welford_cov_merge_pooled`
    over :func:`welford_merge_psum`'s axes, its one accumulator given to
    every chain."""
    merged = welford_cov_merge_pooled(state, _axis_mesh(axis_name))
    return WelfordCovState(*(m.expand_as(s) for m, s in zip(merged, state)))


class DenseState(NamedTuple):
    """A fixed dense potential: one matrix for every chain."""

    cov: torch.Tensor   # M^{-1} (1, n, n)
    chol: torch.Tensor  # lower cholesky of cov (momentum draws solve Lᵀp=z)


class DenseAdaptState(NamedTuple):
    """QuadPotentialFullAdapt state (Stan-style doubling windows,
    cf. ``quadpotential.py:278``). ``cov``/``chol`` are ``(1, n, n)`` while
    every chain shares them (at the start, and under pooled adaptation),
    else ``(chains, n, n)``; the rest is per chain."""

    cov: torch.Tensor
    chol: torch.Tensor
    fg: WelfordCovState
    bg: WelfordCovState
    window: torch.Tensor       # current adaptation window length (chains,)
    prev_update: torch.Tensor  # n_samples at the last promotion (chains,)
    n_samples: torch.Tensor    # tuning draws seen (chains,)


def dense_adapt_init(initial_mean, initial_cov, initial_weight, chains,
                     adaptation_window=101) -> DenseAdaptState:
    """cf. ``dense_adapt_init`` (``quadpotential.py:291``);
    ``initial_mean: (n,)``, ``initial_cov: (n, n)`` tensors."""
    n = initial_mean.shape[-1]
    device = initial_mean.device
    fg = welford_cov_init(n, initial_mean.expand(chains, n), initial_cov,
                          initial_weight)

    def ints(v):
        return torch.full((chains,), int(v), dtype=torch.int32,
                          device=device)
    return DenseAdaptState(
        cov=initial_cov[None], chol=torch.linalg.cholesky(initial_cov)[None],
        fg=fg, bg=welford_cov_zeros(chains, n, device),
        window=ints(adaptation_window), prev_update=ints(0),
        n_samples=ints(0))


def dense_adapt_update(state: DenseAdaptState, sample, tune: bool,
                       window_multiplier=2.0, axis_name=None, pooled=None,
                       mesh=None) -> DenseAdaptState:
    """One dense-adaptation step (cf. ``dense_adapt_update``,
    quadpotential.py:311): add the sample to both covariance estimators,
    refresh ``cov``/``chol`` from the foreground (pooled over chains with
    ``pooled`` or an ``axis_name``, and over the ranks of ``mesh``), and at
    window ends promote the background and double the window. Where the
    estimate is not positive definite, or has weight 2 or less, the chain
    keeps its previous factor."""
    pooled = _pooled_from_axis_name(axis_name, pooled)
    if not tune:
        return state
    fg = welford_cov_add(state.fg, sample)
    bg = welford_cov_add(state.bg, sample)
    delta = state.n_samples - state.prev_update

    fg_est = welford_cov_merge_pooled(fg, mesh) if pooled else fg
    cov_est = fg_est.m2 / torch.clamp(fg_est.w - 1.0, min=1.0)[:, None, None]
    chol_est, info = torch.linalg.cholesky_ex(cov_est)
    ok = (fg_est.w > 2.0) & (info == 0) \
        & torch.isfinite(chol_est).all(-1).all(-1)
    ok = ok[:, None, None]
    cov = torch.where(ok, cov_est, state.cov)
    chol = torch.where(ok, chol_est, state.chol)

    window_end = delta >= state.window
    zero = welford_cov_zeros(*sample.shape, sample.device)
    window = torch.where(
        window_end,
        (state.window.to(sample.dtype) * window_multiplier).to(torch.int32),
        state.window)
    return DenseAdaptState(
        cov=cov, chol=chol, fg=_promote(window_end, bg, fg),
        bg=_promote(window_end, zero, bg), window=window,
        prev_update=torch.where(window_end, state.n_samples,
                                state.prev_update),
        n_samples=state.n_samples + 1)


# -- what a kernel threads through its leapfrogs -----------------------------
def mass_velocity(mass, p):
    """v = M^{-1} p. ``mass`` of the same rank as ``p`` is a diagonal;
    one rank more, a dense matrix (batched ``(1 | chains, n, n)`` against
    ``p: (chains, n)``, or ``(n, n)`` against one ``p: (n,)``)."""
    if mass.ndim == p.ndim + 1:
        return (mass @ p.unsqueeze(-1)).squeeze(-1)  # M^{-1} symmetric
    return p * mass


def dense_random(chol, z):
    """Momentum p ~ N(0, M) with M = cov^{-1} and cov = L Lᵀ from standard
    normal ``z``: p = L^{-T} z (cf. ``dense_random``,
    ``quadpotential.py:217``)."""
    return torch.linalg.solve_triangular(
        chol.transpose(-1, -2), z.unsqueeze(-1), upper=True).squeeze(-1)


def kernel_mass(pot_state):
    """The inverse mass of a potential's kernel state: the ``(chains, n)``
    diagonal or the dense matrix (cf. ``quadpotential.py:225``)."""
    if isinstance(pot_state, (DenseState, DenseAdaptState)):
        return pot_state.cov
    return pot_state.var


def kernel_momentum(pot_state, z):
    """The momenta for standard normal ``z: (chains, n)``, dispatching on
    the kernel state's type (cf. ``quadpotential.py:233``)."""
    if isinstance(pot_state, (DenseState, DenseAdaptState)):
        return dense_random(pot_state.chol, z)
    return pot_state.inv_stds * z


def kernel_update(potential, pot_state, sample, tune: bool, pooled: bool,
                  mesh=None):
    """The potential's adaptation step after a draw at ``sample``: none for
    a fixed potential, the dense or the diagonal update otherwise (cf.
    ``nuts.py:586-600``); a pooled one reduces over the ranks of ``mesh``
    too."""
    if not getattr(potential, "adapts", False):
        return pot_state
    if isinstance(pot_state, DenseAdaptState):
        return dense_adapt_update(
            pot_state, sample, tune,
            window_multiplier=getattr(
                potential, "adaptation_window_multiplier", 2.0),
            pooled=pooled, mesh=mesh)
    return diag_adapt_update(
        pot_state, sample, tune,
        adaptation_window=getattr(potential, "adaptation_window", 101),
        pooled=pooled, mesh=mesh)


# -- class wrappers ----------------------------------------------------------
class QuadPotential:
    """Interface (cf. ``quadpotential.py:363``)."""

    dtype = None
    adapts = False

    def velocity(self, x, out=None):
        raise NotImplementedError

    def energy(self, x, velocity=None):
        raise NotImplementedError

    def random(self):
        raise NotImplementedError

    def velocity_energy(self, x, v_out):
        raise NotImplementedError

    def update(self, sample, grad, tune):
        pass

    def raise_ok(self, vmap=None):
        pass

    def reset(self):
        pass


def isquadpotential(value):
    return isinstance(value, QuadPotential)


class _HostPotentialMixin:
    """numpy-facing helpers shared by the class wrappers (cf.
    ``_JaxPotentialMixin``, ``quadpotential.py:394``)."""

    def velocity(self, x, out=None):
        v = np.asarray(self._velocity(np.asarray(x, dtype=floatX())))
        if out is not None:
            np.copyto(out, v)
            return None
        return v

    def energy(self, x, velocity=None):
        x = np.asarray(x, dtype=floatX())
        if velocity is None:
            velocity = self.velocity(x)
        return 0.5 * float(np.dot(x, velocity))

    def velocity_energy(self, x, v_out):
        self.velocity(x, out=v_out)
        return 0.5 * float(np.dot(x, v_out))


def _t(x, device):
    return torch.as_tensor(np.asarray(x), dtype=torch_floatX(), device=device)


class QuadPotentialDiag(_HostPotentialMixin, QuadPotential):
    """Fixed diagonal M^{-1} = v (cf. ``quadpotential.py:415``)."""

    adapts = False

    def __init__(self, v, dtype=None):
        self.dtype = dtype or floatX()
        v = np.asarray(v)
        partial_check_positive_definite(v)
        self.v = v.astype(self.dtype)
        self.s = np.sqrt(v).astype(self.dtype)
        self.inv_s = (1.0 / self.s).astype(self.dtype)

    def _velocity(self, x):
        return self.v * x

    def random(self):
        return (np.random.normal(size=self.s.shape)
                * self.inv_s).astype(self.dtype)

    def init_kernel_state(self, chains, device) -> DiagAdaptState:
        n = self.v.shape[-1]
        return DiagAdaptState(
            var=_t(self.v, device).expand(chains, n),
            inv_stds=_t(self.inv_s, device).expand(chains, n),
            fg=welford_zeros(chains, n, device),
            bg=welford_zeros(chains, n, device),
            n_samples=torch.zeros(chains, dtype=torch.int32, device=device))


class QuadPotentialDiagAdapt(QuadPotential):
    """Adaptive diagonal potential (cf. ``quadpotential.py:443``)."""

    adapts = True

    def __init__(self, n, initial_mean, initial_diag=None, initial_weight=0,
                 adaptation_window=101, dtype=None):
        if initial_diag is not None and np.ndim(initial_diag) != 1:
            raise ValueError("Initial diagonal must be one-dimensional.")
        if np.ndim(initial_mean) != 1:
            raise ValueError("Initial mean must be one-dimensional.")
        if initial_diag is not None and len(initial_diag) != n:
            raise ValueError(f"Wrong shape for initial_diag: expected {n} got "
                             f"{len(initial_diag)}")
        if len(initial_mean) != n:
            raise ValueError(f"Wrong shape for initial_mean: expected {n} got "
                             f"{len(initial_mean)}")
        self.dtype = dtype or floatX()
        self.n = n
        self.adaptation_window = int(adaptation_window)
        self._initial_mean = np.asarray(initial_mean, dtype=self.dtype)
        if initial_diag is None:
            self._initial_diag = np.ones(n, dtype=self.dtype)
            self._initial_weight = 1.0
        else:
            self._initial_diag = np.asarray(initial_diag, dtype=self.dtype)
            self._initial_weight = float(initial_weight)
        self.reset()

    def init_kernel_state(self, chains, device) -> DiagAdaptState:
        return diag_adapt_init(_t(self._initial_mean, device),
                               _t(self._initial_diag, device),
                               self._initial_weight, chains)

    # -- the host-side API of one chain (cf. quadpotential.py:469-509) -------
    def reset(self):
        self._state = self.init_kernel_state(1, "cpu")

    def _var(self):
        return self._state.var[0].numpy()

    def _velocity(self, x):
        return self._var() * np.asarray(x, self.dtype)

    def velocity(self, x, out=None):
        v = self._velocity(x)
        if out is not None:
            np.copyto(out, v)
            return None
        return v

    def energy(self, x, velocity=None):
        if velocity is None:
            velocity = self.velocity(x)
        return 0.5 * float(np.dot(np.asarray(x, self.dtype), velocity))

    def random(self):
        return (np.random.normal(size=self.n)
                * self._state.inv_stds[0].numpy()).astype(self.dtype)

    def update(self, sample, grad, tune):
        if not tune:
            return
        self._state = diag_adapt_update(
            self._state, _t(sample, "cpu")[None], True,
            self.adaptation_window)

    def raise_ok(self, vmap=None):
        """Raise a ``ValueError`` naming the variable of every zero or
        non-finite entry of the mass matrix (cf. ``quadpotential.py:490``);
        ``vmap`` is the ordering's list of ``VarMap``."""
        var = self._var()
        for bad, what, adj in ((var == 0, "zeros", "zero"),
                               (~np.isfinite(var), "non-finite values",
                                "non-finite")):
            if bad.any():
                msg = [f"Mass matrix contains {what} on the diagonal. "]
                msg += [f"The derivative of RV `{_name_for_index(vmap, i)}`"
                        f".ravel()[{i}] is {adj}." for i in np.where(bad)[0]]
                raise ValueError("\n".join(msg))


def _name_for_index(vmap, i):
    """The variable whose slice of the flat vector holds entry ``i``."""
    for vm in vmap or ():
        if vm.slc.start <= i < vm.slc.stop:
            return vm.var
    return "?"


class QuadPotentialDiagAdaptGrad(QuadPotentialDiagAdapt):
    """Diagonal adaptation that also tracks the squared gradients
    (cf. ``quadpotential.py:521``). As in the JAX package the mass matrix
    comes from the samples; the gradient estimate is kept beside it."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self._grad_state = welford_zeros(1, self.n, "cpu")

    def update(self, sample, grad, tune):
        if not tune:
            return
        self._grad_state = welford_add(self._grad_state,
                                       _t(grad, "cpu")[None] ** 2)
        super().update(sample, grad, tune)


class QuadPotentialFull(_HostPotentialMixin, QuadPotential):
    """Fixed dense mass matrix with M^{-1} = A (cf. ``quadpotential.py:541``)."""

    adapts = False

    def __init__(self, A, dtype=None):
        self.dtype = dtype or floatX()
        self._set_cov(A)
        self._n = len(self._cov)

    def _set_cov(self, cov):
        self._cov = np.asarray(cov, self.dtype)
        self._chol = np.linalg.cholesky(self._cov.astype(np.float64)).astype(
            self.dtype)

    def _velocity(self, x):
        return np.dot(self._cov, x)

    def random(self):
        import scipy.linalg
        vals = np.random.normal(size=self._n).astype(self.dtype)
        return scipy.linalg.solve_triangular(self._chol.T, vals,
                                             overwrite_b=True)

    def init_kernel_state(self, chains, device) -> DenseState:
        return DenseState(cov=_t(self._cov, device)[None],
                          chol=_t(self._chol, device)[None])


class QuadPotentialFullInv(QuadPotentialFull):
    """Fixed dense mass matrix M = A (cf. ``quadpotential.py:573``)."""

    def __init__(self, A, dtype=None):
        A = np.asarray(A, dtype=np.float64)
        L = np.linalg.cholesky(A)
        Linv = np.linalg.solve(L, np.eye(len(A)))
        super().__init__(Linv.T @ Linv, dtype=dtype)


class QuadPotentialFullAdapt(QuadPotentialFull):
    """Adapt a dense mass matrix from the sample covariance
    (cf. ``quadpotential.py:589``), Stan-style doubling windows.

    Two updates, as in the JAX package: the kernel's
    :func:`dense_adapt_update` (what ``sample()`` runs, no shrinkage) and
    the host-side ``update`` of one chain, which shrinks the estimate
    towards ``1e-3 I`` by ``w / (w + 5)`` when a window ends."""

    adapts = True

    def __init__(self, n, initial_mean, initial_cov=None, initial_weight=0,
                 adaptation_window=101, adaptation_window_multiplier=2,
                 update_window=1, dtype=None):
        if initial_cov is not None and np.ndim(initial_cov) != 2:
            raise ValueError("Initial covariance must be two-dimensional.")
        if np.ndim(initial_mean) != 1:
            raise ValueError("Initial mean must be one-dimensional.")
        self.dtype = dtype or floatX()
        self._n = n
        if initial_cov is None:
            initial_cov = np.eye(n, dtype=self.dtype)
            initial_weight = 1
        self._initial_mean = np.asarray(initial_mean, self.dtype)
        self._initial_cov = np.asarray(initial_cov, self.dtype)
        self._initial_weight = initial_weight
        self.adaptation_window = int(adaptation_window)
        self.adaptation_window_multiplier = float(adaptation_window_multiplier)
        self._update_window = int(update_window)
        self.reset()

    def reset(self):
        self._window = self.adaptation_window
        self._previous_update = 0
        self._cov_mean = np.array(self._initial_mean, copy=True)
        self._cov_w = float(self._initial_weight)
        self._cov_m2 = self._initial_cov * self._initial_weight
        self._set_cov(self._initial_cov)
        self._n_samples = 0

    def init_kernel_state(self, chains, device) -> DenseAdaptState:
        return dense_adapt_init(_t(self._initial_mean, device),
                                _t(self._initial_cov, device),
                                self._initial_weight, chains,
                                adaptation_window=self.adaptation_window)

    def update(self, sample, grad, tune):
        """cf. ``quadpotential.py:633``."""
        if not tune:
            return
        x = np.asarray(sample, self.dtype)
        self._cov_w += 1
        delta = x - self._cov_mean
        self._cov_mean += delta / self._cov_w
        self._cov_m2 += np.outer(delta, x - self._cov_mean)

        if self._n_samples - self._previous_update >= self._window and \
                self._n_samples % self._update_window == 0:
            w = self._cov_w
            cov = self._cov_m2 / (w - 1 + 1e-8)
            shrink = w / (w + 5.0)
            cov = shrink * cov + (1 - shrink) * 1e-3 * np.eye(self._n)
            self._set_cov(cov)
            self._cov_mean = np.array(x, copy=True)
            self._cov_w = 1.0
            self._cov_m2 = np.zeros_like(self._cov_m2)
            self._previous_update = self._n_samples
            self._window = int(self._window
                               * self.adaptation_window_multiplier)
        self._n_samples += 1


def quad_potential(C, is_cov):
    """A potential from a scaling array (cf. ``quadpotential.py:661``)."""
    partial_check_positive_definite(C)
    C = np.asarray(C)
    if C.ndim == 1:
        return QuadPotentialDiag(C if is_cov else 1.0 / C)
    return QuadPotentialFull(C) if is_cov else QuadPotentialFullInv(C)
