"""Sequential Monte Carlo kernel (cf. ``pymc3_tpu/smc/smc.py``).

Tempered-posterior SMC with the particle state on the device for the whole
run: the ``(particles, dim)`` positions, their prior and likelihood terms,
the acceptance of each particle's chain and its proposal scaling. A stage
reads three numbers back to the host, as the JAX package does: the new
inverse temperature β (with the evidence increment, in one copy), whether
the proposal covariance has a Cholesky factor, and the mean acceptance.

- The β bisection (target ESS = threshold·N) is a fixed count of halvings
  carried by ``torch.where``, which stops where the JAX package's
  ``lax.while_loop`` stops (:func:`_beta_stage`).
- Systematic resampling is one uniform, a cumulative sum in the weights'
  dtype (``floatX``) and ``torch.searchsorted``, then one gather per
  array.
- The proposal covariance is the particles' centred Gram matrix and its
  ``cholesky_ex``.
- The mutation is an independent-Metropolis chain per particle, ``n_steps``
  steps, each one batched evaluation of the prior and the likelihood over
  every particle (``torch.func.vmap`` of the model's point functions); the
  proposal noise and the uniforms come from one ``torch.Generator`` on the
  device.

``devices=``/``mesh=`` shard the particles over the ranks of a process
group (``parallel``; cf. ``smc.py:195-209``): each rank holds its block of
particles on its own device, draws them and their mutations from its own
generator, and runs the likelihood on them alone. What spans the particles
is a collective: the β bisection's ESS and the evidence through a global
logsumexp (a MAX, then a SUM), the proposal covariance (a SUM of the
particles, then of their centred Gram matrices), the acceptance rate and
the scalings' mean (a SUM). Systematic resampling gathers the weights
whole (4 MB at 1M particles), each rank searches its own output rows, and
the source rows are gathered, as the JAX package replicates the weights
and the source and keeps the indices sharded (``smc.py:95-153``). The
offset uniform comes from a generator every rank seeds alike. The host
reads per stage stay three.
"""
from __future__ import annotations

import logging

import numpy as np
import torch

from ..config import floatX, torch_floatX
from ..distributions.distribution import make_generator
from ..model import modelcontext
from ..node import _ev
from ..parallel import ChainMesh, make_mesh, rank_seed
from ..torchf import batched_value

_log = logging.getLogger("pymc3_tpu_torch")

__all__ = ["SMC"]

#: Halvings of the β bisection: it starts at [β, 2], and 22 halvings bring
#: any such interval below the JAX package's 1e-6 stopping width.
BISECTION_STEPS = 22

#: Particles whose simulator output came from a numpy simulator called on
#: the host (SMC-ABC's host path); a torch simulator never moves it.
HOST_SIMULATOR_CALLS = 0

#: The mesh of one process: every collective is the identity.
_ALONE = ChainMesh()


def _beta_stage(ll_raw, old_beta, rN, mesh=_ALONE):
    """The next inverse temperature, the normalised importance weights and
    the log-evidence increment (cf. ``_beta_stage``, ``smc.py:51``), all on
    the device.

    ``old_beta`` is a scalar tensor in the dtype of ``ll_raw`` (``floatX``),
    ``rN`` the target ESS as an int. Each of :data:`BISECTION_STEPS` halvings runs only while the JAX
    package's loop would (``up - low > 1e-6`` and the integer ESS not yet
    ``rN``); afterwards ``torch.where`` keeps the state, so the result is
    that loop's with no host read. The ESS is floored in the dtype of
    ``ll_raw`` and cast to int32, as there.

    The particles are this rank's of ``mesh`` and the sums span every
    rank: with ``M`` the global max of the log weights, ``S1`` and ``S2``
    the global sums of ``exp(lw - M)`` and ``exp(2 (lw - M))`` (float64),
    the ESS is ``S1^2 / S2`` (one MAX and one SUM a halving) and the
    weights returned are this rank's rows. One process takes the JAX
    package's ESS, ``exp(-logsumexp(2 lw))`` in the dtype of ``ll_raw``,
    whose floor the float64 sums of several ranks can cross in float32."""
    ll = torch.where(torch.isfinite(ll_raw), ll_raw,
                     torch.full_like(ll_raw, -1e30))
    n = ll.shape[0] * mesh.world_size
    alone = mesh.group is None
    rN = torch.tensor(int(rN), dtype=torch.int32, device=ll.device)

    def global_sums(lw_un):
        m = mesh.max(lw_un.max())
        d = (lw_un - m).to(torch.float64)
        return m, mesh.sum(torch.stack([torch.exp(d).sum(),
                                        torch.exp(2.0 * d).sum()]))

    def ess_int(nb):
        lw_un = (nb - old_beta) * ll
        if alone:
            lw = lw_un - torch.logsumexp(lw_un, 0)
            return torch.floor(torch.exp(-torch.logsumexp(2.0 * lw, 0))).to(
                torch.int32)
        _, sums = global_sums(lw_un)
        return torch.floor((sums[0] ** 2 / sums[1]).to(ll.dtype)).to(
            torch.int32)

    low = old_beta.clone()
    up = torch.full_like(old_beta, 2.0)
    mid = old_beta.clone()
    e = torch.full_like(rN, -1)
    for _ in range(BISECTION_STEPS):
        active = ((up - low) > 1e-6) & (e != rN)
        m = 0.5 * (low + up)
        em = ess_int(m)
        low = torch.where(active & (em > rN), m, low)
        up = torch.where(active & (em < rN), m, up)
        mid = torch.where(active, m, mid)
        e = torch.where(active, em, e)

    new_beta = torch.where(mid >= 1.0, torch.ones_like(mid), mid)
    lw_un = (new_beta - old_beta) * ll
    if alone:
        lse = torch.logsumexp(lw_un, 0)
    else:
        m, sums = global_sums(lw_un)
        lse = (m + torch.log(sums[0])).to(ll.dtype)
    w = torch.exp(lw_un - lse)
    return new_beta, w / mesh.sum(w.sum()), lse - np.log(n)


def _systematic_indices(u, weights, rows=None):
    """Systematic resampling indices from one uniform ``u`` (a scalar
    tensor): positions (u + i) / N against the normalised cumulative sum in
    the weights' dtype, searched from the left as ``jnp.searchsorted``
    (cf. ``smc.py:99``); ``rows`` (a slice) picks the output rows to
    search, all by default."""
    n = weights.shape[0]
    rows = rows if rows is not None else slice(0, n)
    positions = (u + torch.arange(rows.start, rows.stop, dtype=weights.dtype,
                                  device=weights.device)) / n
    cum = torch.cumsum(weights, 0)
    cum = cum / cum[-1]
    idx = torch.searchsorted(cum, positions)
    return torch.clamp(idx, 0, n - 1)


def _resample_gather(u, weights, arrays, mesh=_ALONE):
    """Every per-particle array gathered through the systematic indices
    (cf. ``smc.py:131``): the weights of every rank of ``mesh`` gathered
    whole, this rank's output rows searched, and the source rows of every
    rank gathered (one SUM for all the arrays, packed side by side) before
    the local gather."""
    local = weights.shape[0]
    idx = _systematic_indices(u, mesh.gather_rows(weights),
                              mesh.local_rows(local * mesh.world_size))
    packed = torch.cat([a.reshape(local, -1) for a in arrays], 1)
    src = mesh.gather_rows(packed)[idx]
    out, start = [], 0
    for a in arrays:
        width = int(np.prod(a.shape[1:], dtype=np.int64))
        out.append(src[:, start:start + width].reshape(a.shape))
        start += width
    return tuple(out)


def _particle_cov_chol(X, mesh=_ALONE):
    """The particles' covariance (the centred Gram matrix over N, plus 1e-6
    on the diagonal), its lower Cholesky factor, and a flag that both are
    finite and the factorisation succeeded (cf. ``smc.py:158``).
    ``cholesky_ex`` reports a failure in ``info`` where the JAX package's
    factor holds NaN. The particles of every rank of ``mesh`` count: a SUM
    of the particles and their count, then one of the Gram matrices."""
    sums = mesh.sum(torch.cat([X.sum(0), X.new_tensor([X.shape[0]])]))
    Xc = X - sums[:-1] / sums[-1]
    cov = mesh.sum(Xc.T @ Xc) / sums[-1]
    cov = cov + 1e-6 * torch.eye(X.shape[1], dtype=X.dtype, device=X.device)
    chol, info = torch.linalg.cholesky_ex(cov, check_errors=False)
    ok = torch.isfinite(cov).all() & torch.isfinite(chol).all() & (info == 0)
    return cov, chol, ok


def _global_mean(xs, mesh):
    """The means of the 1-d tensors ``xs`` over the particles of every rank
    of ``mesh``: one SUM."""
    n = xs[0].shape[0]
    sums = mesh.sum(torch.stack([x.sum() for x in xs]
                                + [xs[0].new_tensor(float(n))]))
    return sums[:-1] / sums[-1]


def _tune_scalings(scalings, acc_per_chain, mesh=_ALONE):
    """Each particle's proposal scale moved toward an acceptance of 0.234
    (cf. ``smc.py:177``); the means span every rank of ``mesh``."""
    target = 0.234
    mean_scale, mean_acc = _global_mean([scalings, acc_per_chain], mesh)
    ave = torch.exp(torch.log(mean_scale) + (mean_acc - target))
    return 0.5 * (ave + torch.exp(torch.log(scalings)
                                  + (acc_per_chain - target)))


def _mutation_step(q, pl, ll, beta, chol, scalings, z, u, logp_fn):
    """One independent-Metropolis step of every particle's chain
    (cf. ``particle_chain``, ``smc.py:269-285``), given its standard normals
    ``z (N, dim)`` and uniforms ``u (N,)``. Returns the new ``q``, prior and
    likelihood terms, and the accept flags."""
    q_prop = q + (z @ chol.T) * scalings[:, None]
    pl_p, ll_p = logp_fn(q_prop)
    mr = (pl_p + beta * ll_p) - (pl + beta * ll)
    mr = torch.where(torch.isnan(mr), -torch.inf, mr)
    accept = torch.log(u) < mr
    return (torch.where(accept[:, None], q_prop, q),
            torch.where(accept, pl_p, pl), torch.where(accept, ll_p, ll),
            accept)


class SMC:
    """cf. ``smc/smc.py:186``.

    ``dist_func`` and ``sum_stat`` are accepted for the JAX package's
    signature and ignored, as there: SMC-ABC's distance is always the
    Gaussian kernel over the mean squared difference of the simulated and
    observed data, with no summary statistic (:func:`_make_abc_loglike`).
    ``parallel``, ``cores`` and ``progressbar`` are ignored too: every
    particle runs in one batch on the model's device, or, with
    ``devices``/``mesh`` (a ``parallel.ChainMesh`` or the list of every
    rank's device), each rank's block of them on its own; ``draws`` must
    be a multiple of the rank count."""

    def __init__(self, draws=1000, kernel="metropolis", n_steps=25,
                 parallel=False, start=None, cores=None, tune_steps=True,
                 p_acc_rate=0.99, threshold=0.5, epsilon=1.0, dist_func=None,
                 sum_stat=False, progressbar=False, model=None,
                 random_seed=-1, devices=None, mesh=None):
        self.draws = int(draws)
        if mesh is not None and not isinstance(mesh, ChainMesh):
            raise TypeError(f"mesh must be a parallel.ChainMesh, not "
                            f"{type(mesh).__name__}")
        # without either, this process alone, even inside a process group
        self.mesh = make_mesh(mesh if mesh is not None else devices) \
            if devices is not None or mesh is not None else _ALONE
        if self.draws % self.mesh.world_size != 0:
            raise ValueError(
                f"draws ({self.draws}) must be a multiple of the device "
                f"count ({self.mesh.world_size}) for particle sharding")
        self.local = self.draws // self.mesh.world_size
        self.kernel = kernel
        self.n_steps = int(n_steps)
        self.start = start
        self.tune_steps = tune_steps
        self.p_acc_rate = p_acc_rate
        self.threshold = threshold
        self.epsilon = epsilon
        self.model = modelcontext(model)
        self.device = self.model.device
        seed = None if random_seed in (-1, None) else int(random_seed)
        self.gen = self.shared_gen = make_generator(self.device, seed)
        if self.mesh.group is not None:
            if seed is None:
                seed = self.mesh.host_broadcast(
                    int(np.random.randint(0, 2 ** 30)))
            # this rank's particles from its own generator; the resampling
            # offset from one every rank seeds alike
            self.gen = make_generator(self.device,
                                      rank_seed(seed, self.mesh))
            self.shared_gen = make_generator(self.device, seed)

        self.beta = 0.0
        self.max_steps = n_steps
        self.proposed = self.draws * self.n_steps
        self.acc_rate = 1.0
        dtype = torch_floatX()
        self.acc_per_chain = torch.ones(self.local, dtype=dtype,
                                        device=self.device)
        self.dimension = self.model.ndim
        self.scalings = torch.full((self.local,),
                                   min(1, 2.38 ** 2 / self.dimension),
                                   dtype=dtype, device=self.device)
        self.log_marginal_likelihood = 0.0

    def _uniform(self, shape=(), gen=None):
        return torch.rand(shape, generator=gen or self.gen,
                          dtype=torch_floatX(), device=self.device)

    # -- stages (cf. smc.py:218-405) ----------------------------------------
    def initialize_population(self):
        """The initial particles: prior draws of the free variables from
        the port's forward sampler, on the device, or ``start``
        (cf. ``smc.py:218``); this rank's rows of them."""
        model = self.model
        if self.start is not None:
            pts = self.start if isinstance(self.start, list) else \
                [self.start] * self.draws
            pts = pts[self.mesh.local_rows(self.draws, "draws")]
            q = np.stack([model.dict_to_array(
                {k: p[k] for k in model.ordering.by_name}) for p in pts])
            self.posterior = torch.as_tensor(q, dtype=torch_floatX(),
                                             device=self.device)
            return
        fwd = model.sample_forward(self.local, gen=self.gen, observed=False)
        self.posterior = torch.cat(
            [fwd[vm.var].reshape(self.local, -1).to(torch_floatX())
             for vm in model.ordering.vmap], dim=1)

    def setup_kernel(self):
        """The batched prior and likelihood terms (cf. ``smc.py:235``):
        for the Metropolis kernel one ``vmap`` over the particles returns
        both; for ABC the likelihood is the simulator's pseudo-likelihood
        (:func:`_make_abc_loglike`), a batched call of its own."""
        model = self.model
        ordering = model.ordering
        if self.kernel.lower() == "abc":
            prior = model.varlogpt_fn()
            like = _make_abc_loglike(model, self.epsilon)
            self._logp_fn = lambda q: (prior(q), like(q))
        else:
            self._logp_fn = batched_value(lambda q: (
                model.varlogpt_point(q, ordering),
                model.datalogpt_point(q, ordering)))

    def initialize_logp(self):
        """cf. ``smc.py:285``; the terms stay on the device."""
        self.prior_logp, self.likelihood_logp = self._logp_fn(self.posterior)

    def update_weights_beta(self):
        """The next β and the weights (cf. ``smc.py:291``): β and the
        evidence increment come back to the host in one copy."""
        rN = int(self.draws * self.threshold)
        new_beta, self.weights, lml_inc = _beta_stage(
            self.likelihood_logp,
            torch.tensor(self.beta, dtype=torch_floatX(), device=self.device),
            rN, self.mesh)
        beta, inc = torch.stack([new_beta, lml_inc]).tolist()
        self.beta = float(beta)
        self.log_marginal_likelihood += float(inc)

    def resample(self):
        """Systematic resampling on the device (cf. ``smc.py:303``)."""
        (self.posterior, self.prior_logp, self.likelihood_logp,
         self.acc_per_chain, self.scalings) = _resample_gather(
            self._uniform(gen=self.shared_gen), self.weights,
            (self.posterior, self.prior_logp, self.likelihood_logp,
             self.acc_per_chain, self.scalings), self.mesh)

    def update_proposal(self):
        """The proposal covariance and its factor (cf. ``smc.py:314``); one
        host read of the flag."""
        _, self.chol, ok = _particle_cov_chol(self.posterior, self.mesh)
        if not bool(ok):
            raise ValueError('Sample covariances not valid! Likely "draws" '
                             "is too small!")

    def tune(self):
        """The scalings on the device, ``n_steps`` on the host
        (cf. ``smc.py:322``: acceptance target 0.234)."""
        self.scalings = _tune_scalings(self.scalings, self.acc_per_chain,
                                       self.mesh)
        if self.tune_steps:
            acc_rate = max(1.0 / self.proposed, self.acc_rate)
            self.n_steps = min(
                self.max_steps,
                max(2, int(np.log(1 - self.p_acc_rate) /
                           np.log(1 - acc_rate))))
        self.proposed = self.draws * self.n_steps

    def mutate(self):
        """``n_steps`` independent-Metropolis steps of every particle
        (cf. ``smc.py:333``); the mean acceptance is the one host read."""
        q, pl, ll = self.posterior, self.prior_logp, self.likelihood_logp
        accs = torch.zeros_like(pl)
        shape = (self.local, self.dimension)
        for _ in range(self.n_steps):
            z = torch.randn(shape, generator=self.gen, dtype=torch_floatX(),
                            device=self.device)
            u = self._uniform((self.local,))
            q, pl, ll, accept = _mutation_step(
                q, pl, ll, self.beta, self.chol, self.scalings, z, u,
                self._logp_fn)
            accs = accs + accept.to(accs.dtype)
        self.posterior, self.prior_logp, self.likelihood_logp = q, pl, ll
        self.acc_per_chain = accs / self.n_steps
        self.acc_rate = _global_mean([self.acc_per_chain],
                                     self.mesh)[0].item()

    def posterior_to_trace(self):
        """The particles decoded into every unobserved variable, copied to
        the host once, as one ``NDArray`` (cf. ``smc.py:350``); every
        rank's, in rank order, over the mesh's host group."""
        from ..backends.base import MultiTrace
        from ..backends.ndarray import NDArray
        model = self.model
        unobserved = model.unobserved_RVs
        ordering = model.ordering

        def decode(q):
            env = model._env_from_q(q, ordering)
            memo = {}
            return [_ev(v, env, memo).reshape(-1) for v in unobserved]
        with torch.no_grad():
            vals = torch.func.vmap(decode)(self.posterior)
        widths = [v.shape[1] for v in vals]
        host = torch.cat([v.to(torch.float64) for v in vals], 1).cpu().numpy()
        host = np.concatenate(self.mesh.host_gather(host), axis=0)
        out, start = {}, 0
        for v, w in zip(unobserved, widths):
            shape = tuple(np.shape(v.test_value))
            out[v.name] = host[:, start:start + w].reshape(
                (self.draws,) + shape).astype(
                    np.dtype(getattr(v, "dtype", host.dtype)))
            start += w
        strace = NDArray(model=model, vars=unobserved)
        strace.setup(self.draws, 0)
        strace.record_batch(out, self.draws)
        strace.close()
        return MultiTrace([strace])


def _simulator_writes_torch(fn, params):
    """Whether the simulator returns a torch tensor when handed its
    parameters' test values as CPU tensors (a numpy simulator returns an
    array)."""
    vals = [torch.as_tensor(np.asarray(p.test_value)) if hasattr(
        p, "test_value") else p for p in params]
    return isinstance(fn(*vals), torch.Tensor)


def _make_abc_loglike(model, epsilon):
    """The Gaussian-kernel pseudo-likelihood over the simulator's distance
    to the data, -mean((sim - data)^2) / (2 epsilon^2) (cf. ``smc.py:408``),
    as a batched ``q: (particles, n) -> (particles,)``.

    A simulator written in torch runs batched over the particles under
    ``vmap``. One that returns numpy the JAX package calls through
    ``jax.pure_callback``; here the host calls it once per particle,
    counted in :data:`HOST_SIMULATOR_CALLS`."""
    from ..distributions.simulator import Simulator
    sims = [rv for rv in model.observed_RVs
            if isinstance(rv.distribution, Simulator)]
    if not sims:
        raise ValueError("SMC-ABC requires a pm.Simulator observed variable")
    rv = sims[0]
    dtype = torch_floatX()
    observed = torch.as_tensor(rv.data, dtype=dtype, device=model.device)
    fn = rv.distribution.function
    params = rv.distribution.params
    ordering = model.ordering

    def param_values(q):
        env = model._env_from_q(q, ordering)
        memo = {}
        return [_ev(p, env, memo) for p in params]

    def pseudo_loglike(sim):
        d2 = torch.mean((sim - observed) ** 2,
                        dim=tuple(range(sim.ndim - observed.ndim, sim.ndim)))
        return -d2 / (2.0 * epsilon ** 2)

    if _simulator_writes_torch(fn, params):
        return batched_value(lambda q: pseudo_loglike(
            torch.as_tensor(fn(*param_values(q)), dtype=dtype)))

    _log.warning("SMC-ABC: the simulator %s returns numpy; the host calls "
                 "it once per particle", getattr(fn, "__name__", fn))
    batched_params = torch.func.vmap(param_values)

    def batch_fn(q):
        global HOST_SIMULATOR_CALLS
        with torch.no_grad():
            vals = [v.cpu().numpy() for v in batched_params(q)]
        n = q.shape[0]
        sims = np.stack([np.asarray(fn(*[v[i] for v in vals]), floatX())
                         for i in range(n)])
        HOST_SIMULATOR_CALLS += n
        return pseudo_loglike(torch.as_tensor(sims, device=q.device))
    return batch_fn
