"""No-U-Turn Sampler over a batch of chains (cf. ``pymc3_tpu/step_methods/hmc/nuts.py``).

The JAX package runs the tree as ``lax.while_loop``s under ``vmap``. Torch
cannot batch data-dependent loops, so here NUTS is written explicitly over
``(chains, n)`` with per-lane masks:

- the doubling loop runs on the host, one depth per iteration; every lane
  still growing its tree has the same depth, so a subtree has ``2**depth``
  leaves for all of them. The loop asks the device once per depth whether
  any lane is still growing (at most ``max_treedepth`` syncs per draw);
- a subtree's leaves run in (even, odd) pairs with a trip count the host
  knows and with no sync; a lane that turned or diverged is frozen by a
  mask while the others go on. Because all growing lanes share the leaf
  index, the checkpoint row ``popcount(leaf >> 1)`` and the U-turn range
  of an odd leaf are host integers, so the O(log) checkpoint stack is a
  list of ``(chains, n)`` tensors indexed in Python;
- pooled adaptation (``axis_name`` given) reduces over dim 0, the chains,
  where the JAX package used ``psum``/``pmean``/``pmax``/``pmin``.

The random numbers of a transition come from a ``noise`` object: standard
normal momenta, and per depth the direction, merge and leaf-proposal
uniforms for all chains at once. ``arraystep.GeneratorNoise`` draws them
from one ``torch.Generator`` on the device; a test can hand in the JAX
package's own numbers instead and compare transitions exactly.

Over a subset of the flat vector (inside a ``CompoundStep``) the kernel
works on ``x = q[:, idx]``: logp and gradient come from the full batched
function with the other coordinates held at ``q``'s values and the gradient
cut to ``idx``, the cached logp and gradient are recomputed at the start of
each transition (another stepper has moved ``q`` since), and the result is
scattered back into ``q``. Potential, step size and momentum have the
subset's dimension.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ...config import floatX, torch_floatX
from ...distributions.distribution import make_generator
from ...model import modelcontext
from ..arraystep import Competence, GeneratorNoise, TuneContext
from ..step_sizes import DAState, da_init, da_update, da_current
from .base_hmc import BaseHMC
from .integration import IntegrationState, leapfrog
from .quadpotential import (
    QuadPotentialDiagAdapt, kernel_mass, kernel_momentum, kernel_update,
    mass_velocity, quad_potential,
)

__all__ = ["NUTS", "NutsKernelState", "nuts_draw", "find_reasonable_eps"]


def _select(mask, a, b):
    """Lane-wise ``mask ? a : b`` over NamedTuples of (chains, ...) tensors."""
    return type(a)(*[torch.where(mask if x.ndim == 1 else mask[:, None], x, y)
                     for x, y in zip(a, b)])


def _where(mask, a, b):
    return torch.where(mask if a.ndim == 1 else mask[:, None], a, b)


def _popcount(x: int) -> int:
    return bin(x).count("1")


def _trailing_ones(x: int) -> int:
    return (x ^ (x + 1)).bit_length() - 1


def _dot(a, b):
    return torch.sum(a * b, dim=-1)


def _is_turning(var, p_left, p_right, rho):
    """Generalized U-turn criterion (cf. ``nuts.py:299-307``)."""
    return (_dot(rho, mass_velocity(var, p_left)) <= 0) | \
        (_dot(rho, mass_velocity(var, p_right)) <= 0)


class _Proposal(NamedTuple):
    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    energy: torch.Tensor


def _proposal(edge: IntegrationState) -> _Proposal:
    return _Proposal(edge.q, edge.model_logp, edge.q_grad, edge.energy)


class _Subtree(NamedTuple):
    edge: IntegrationState        # trajectory endpoint
    prop: _Proposal               # subtree's multinomial proposal
    p_first: torch.Tensor         # momentum of the first leaf
    lsw: torch.Tensor             # log sum of leaf weights
    p_sum: torch.Tensor           # momentum sum over the leaves
    sum_accept: torch.Tensor      # sum of min(1, exp(-dE)) over leaves
    max_eerr: torch.Tensor        # signed dE with max |dE|
    leaf_idx: torch.Tensor        # leaves computed
    turning: torch.Tensor
    diverging: torch.Tensor


def _leaf_weight(edge, h0, emax):
    """(energy error, diverging, log weight, accept stat) of a leaf."""
    eerr = edge.energy - h0
    eerr = torch.where(torch.isnan(eerr), torch.inf, eerr)
    acc = torch.exp(torch.clamp(-eerr, max=0.0))
    return eerr, eerr > emax, -eerr, torch.where(torch.isnan(acc), 0.0, acc)


def _take_prop(u, lsw, lw, edge, prop, gate):
    """Progressive multinomial proposal update, masked by ``gate``."""
    new_lsw = torch.logaddexp(lsw, lw)
    if gate is not None:
        new_lsw = torch.where(gate, new_lsw, lsw)
    take = torch.log(u) < lw - new_lsw
    if gate is not None:
        take = take & gate
    return new_lsw, _select(take, _proposal(edge), prop)


def _build_subtree(u_take, edge0, eps, n_leaves, h0, var, logp_dlogp_fn,
                   emax, live):
    """Build one subtree of ``n_leaves`` leaves from ``edge0`` for the lanes
    in ``live`` (cf. ``_build_subtree``, nuts.py:100-209)."""
    C = edge0.q.shape[0]
    zeros = torch.zeros(C, dtype=edge0.energy.dtype, device=edge0.q.device)
    s = _Subtree(
        edge=edge0, prop=_proposal(edge0), p_first=edge0.p,
        lsw=torch.full_like(zeros, -torch.inf),
        p_sum=torch.zeros_like(edge0.p), sum_accept=zeros, max_eerr=zeros,
        leaf_idx=torch.zeros(C, dtype=torch.int32, device=zeros.device),
        turning=torch.zeros(C, dtype=torch.bool, device=zeros.device),
        diverging=torch.zeros(C, dtype=torch.bool, device=zeros.device))
    r_ckpts, s_ckpts = {}, {}
    for leaf in range(0, n_leaves, 2):
        # leaf A (even): stores its checkpoint, no U-turn possible
        edge_a = leapfrog(logp_dlogp_fn, var, eps, s.edge)
        eerr_a, div_a, lw_a, acc_a = _leaf_weight(edge_a, h0, emax)
        lsw, prop = _take_prop(u_take[leaf], s.lsw, lw_a, edge_a, s.prop,
                               None)
        p_sum_a = s.p_sum + edge_a.p
        p_first = edge_a.p if leaf == 0 else s.p_first
        row = _popcount(leaf >> 1)
        r_ckpts[row], s_ckpts[row] = edge_a.p, p_sum_a
        if leaf + 1 < n_leaves:
            # leaf B (odd): U-turn check against every complete
            # sub-subtree that ends here
            active_b = ~div_a
            edge_b = leapfrog(logp_dlogp_fn, var, eps, edge_a)
            eerr_b, div_b, lw_b, acc_b = _leaf_weight(edge_b, h0, emax)
            lsw, prop = _take_prop(u_take[leaf + 1], lsw, lw_b, edge_b, prop,
                                   active_b)
            p_sum_b = p_sum_a + edge_b.p
            v_r = mass_velocity(var, edge_b.p)
            turn = torch.zeros_like(active_b)
            for r in range(row - _trailing_ones(leaf + 1) + 1, row + 1):
                span = p_sum_b - s_ckpts[r] + r_ckpts[r]
                turn = turn | (_dot(span, mass_velocity(var, r_ckpts[r])) <= 0) \
                    | (_dot(span, v_r) <= 0)
            turning = active_b & turn
            edge = _select(active_b, edge_b, edge_a)
            p_sum = _where(active_b, p_sum_b, p_sum_a)
            eerr = torch.where(active_b & (eerr_b.abs() > eerr_a.abs()),
                               eerr_b, eerr_a)
            acc = acc_a + torch.where(active_b, acc_b, 0.0)
            n_new = 1 + active_b.to(torch.int32)
            diverging = div_a | (active_b & div_b)
        else:
            turning = torch.zeros_like(div_a)
            edge, p_sum, eerr, acc = edge_a, p_sum_a, eerr_a, acc_a
            n_new = 1
            diverging = div_a
        new = _Subtree(
            edge=edge, prop=prop, p_first=p_first, lsw=lsw, p_sum=p_sum,
            sum_accept=s.sum_accept + acc,
            max_eerr=torch.where(eerr.abs() > s.max_eerr.abs(), eerr,
                                 s.max_eerr),
            leaf_idx=s.leaf_idx + n_new, turning=turning, diverging=diverging)
        s = _Subtree(*[_select(live, a, b) if isinstance(a, tuple)
                       else _where(live, a, b) for a, b in zip(new, s)])
        live = live & ~s.turning & ~s.diverging
    return s


class _Tree(NamedTuple):
    prop: _Proposal
    depth: torch.Tensor
    n_leapfrog: torch.Tensor
    sum_accept: torch.Tensor
    max_eerr: torch.Tensor
    turning: torch.Tensor
    diverging: torch.Tensor


def nuts_draw(noise, start: IntegrationState, h0, step_size, var,
              logp_dlogp_fn, max_treedepth: int, emax: float,
              mesh=None) -> _Tree:
    """One NUTS transition per chain from ``start`` (momentum already in
    it), cf. ``nuts_draw`` (nuts.py:227-307). ``step_size``: ``(chains,)``.
    With ``mesh`` the doubling goes on while a lane of any rank grows, as
    it would in one process over all of them (the ranks of a pooled run
    wait for each other at every draw anyway)."""
    C = start.q.shape[0]
    device = start.q.device
    zeros = torch.zeros_like(start.energy)
    left = right = start
    prop = _proposal(start)
    lsw, rho = zeros, start.p
    depth = torch.zeros(C, dtype=torch.int32, device=device)
    n_leapfrog = torch.zeros_like(depth)
    sum_accept, max_eerr = zeros, zeros
    turning = torch.zeros(C, dtype=torch.bool, device=device)
    diverging = torch.zeros_like(turning)
    for d in range(max_treedepth):
        active = ~turning & ~diverging
        if d > 0:                               # the one sync of a depth
            growing = active.any()
            if mesh is not None:
                growing = mesh.max(growing.to(torch.int32)) > 0
            if not bool(growing):
                break
        n_leaves = 1 << d
        u_dir, u_swap, u_take = noise.depth(d, max(2, n_leaves))
        go_right = u_dir < 0.5
        eps_signed = torch.where(go_right, step_size, -step_size)
        sub = _build_subtree(u_take, _select(go_right, right, left),
                             eps_signed, n_leaves, h0, var, logp_dlogp_fn,
                             emax, active)

        ok = ~sub.turning & ~sub.diverging
        # biased progressive proposal merge across the doubling
        accept_p = torch.exp(torch.clamp(sub.lsw - lsw, max=0.0))
        swap = ok & (u_swap < accept_p)
        new_prop = _select(swap, sub.prop, prop)
        new_lsw = torch.where(ok, torch.logaddexp(lsw, sub.lsw), lsw)
        new_rho = rho + sub.p_sum
        new_left = _select(go_right, left, sub.edge)
        new_right = _select(go_right, sub.edge, right)

        # merged-tree U-turn checks: the three boundary combinations of the
        # old tree [left, right] and the new subtree, in trajectory order
        gr = go_right[:, None]
        p_near, p_far = sub.p_first, sub.edge.p
        p_ll = torch.where(gr, left.p, p_far)
        p_lr = torch.where(gr, right.p, p_near)
        p_rl = torch.where(gr, p_near, left.p)
        p_rr = torch.where(gr, p_far, right.p)
        rho_left = torch.where(gr, rho, sub.p_sum)
        rho_right = torch.where(gr, sub.p_sum, rho)
        merged = ok & (_is_turning(var, p_ll, p_rr, new_rho)
                       | _is_turning(var, p_ll, p_rl, rho_left + p_rl)
                       | _is_turning(var, p_lr, p_rr, rho_right + p_lr))

        prop = _select(active, new_prop, prop)
        lsw = torch.where(active, new_lsw, lsw)
        rho = _where(active, new_rho, rho)
        left = _select(active, new_left, left)
        right = _select(active, new_right, right)
        depth = depth + active.to(torch.int32)
        n_leapfrog = n_leapfrog + torch.where(active, sub.leaf_idx, 0)
        sum_accept = sum_accept + torch.where(active, sub.sum_accept, 0.0)
        max_eerr = torch.where(active & (sub.max_eerr.abs() > max_eerr.abs()),
                               sub.max_eerr, max_eerr)
        turning = torch.where(active, sub.turning | merged, turning)
        diverging = torch.where(active, sub.diverging, diverging)
    return _Tree(prop, depth, n_leapfrog, sum_accept, max_eerr, turning,
                 diverging)


def find_reasonable_eps(step, q0_batch, seed=None, noise=None):
    """Stan-style step-size probe (cf. ``find_reasonable_eps``,
    nuts.py:310): double or halve eps until the one-leapfrog acceptance,
    pooled over all chains (of every rank of ``step.mesh``), lands in
    [0.25, 0.9], so that every rank starts from the same eps. One host sync
    per probe (at most 30). A stepper over a subset of the flat vector is
    probed on its own coordinates, the others held at ``q0_batch``'s
    values. ``q0_batch`` is ``(chains, n)``, numpy or a tensor. The momenta
    come from ``noise`` (a ``GeneratorNoise``) or, as in the JAX package,
    from ``seed``: an int that seeds a generator on the model's device."""
    if (seed is None) == (noise is None):
        raise TypeError("find_reasonable_eps takes one of seed and noise")
    device = step.model.device
    q0 = torch.as_tensor(q0_batch, dtype=torch_floatX(), device=device)
    if noise is None:
        noise = GeneratorNoise(make_generator(device, seed), q0.shape[0],
                               device)
    pot = step.potential.init_kernel_state(q0.shape[0], q0.device)
    var = kernel_mass(pot)
    logp_fn = step._value_and_grad_at(q0)
    x0 = step._sub(q0)
    logp0, grad0 = logp_fn(x0)
    p0 = kernel_momentum(pot, noise.normal(step.dim))
    h0 = 0.5 * _dot(p0, mass_velocity(var, p0)) - logp0
    mesh = getattr(step, "mesh", None)

    def accept_at(eps):
        p_half = p0 + 0.5 * eps * grad0
        logp1, grad1 = logp_fn(x0 + eps * mass_velocity(var, p_half))
        p1 = p_half + 0.5 * eps * grad1
        de = h0 - (0.5 * _dot(p1, mass_velocity(var, p1)) - logp1)
        a = torch.where(torch.isfinite(de),
                        torch.exp(torch.clamp(de, max=0.0)), 0.0)
        total, count = _ranks_sum(torch.stack(
            [a.to(torch.float64).sum(), torch.tensor(
                float(a.shape[0]), dtype=torch.float64, device=a.device)]),
            mesh).tolist()
        return total / count

    # the initial step size in floatX, as the JAX package's probe starts
    eps = float(np.dtype(floatX()).type(step.step_size))
    a = accept_at(eps)
    it = 0
    while (a > 0.9 or a < 0.25) and it < 30 and 1e-10 < eps < 1e4:
        eps = eps * 2.0 if a > 0.9 else eps * 0.5
        a = accept_at(eps)
        it += 1
    if np.isfinite(eps) and 1e-10 < eps < 1e4:
        return eps
    return step.step_size


def _ranks_sum(x, mesh):
    """``x`` summed over the ranks of ``mesh`` (itself without one)."""
    return x if mesh is None else mesh.sum(x)


def _rescue(tctx, diverging, rescue_cnt, q, logp, grad, mesh=None):
    """Warmup stuck-lane rescue (cf. nuts.py:613-650): at the end of a
    100-draw tuning window, lanes with >= 90 divergences in it jump to the
    first lane, by global index over the ranks of ``mesh``, holding the
    best finite logp. The donor's ``q``/``logp``/``grad`` reach every rank
    by a SUM in which only the donor's rank writes them."""
    win, thresh = 100, 90
    if not tctx.tune:
        return q, logp, grad, torch.zeros_like(rescue_cnt), \
            torch.zeros_like(diverging)
    rescue_cnt = rescue_cnt + diverging.to(torch.int32)
    if (tctx.step_idx + 1) % win != 0:
        return q, logp, grad, rescue_cnt, torch.zeros_like(diverging)
    C = logp.shape[0]
    rank, world = (0, 1) if mesh is None else (mesh.rank, mesh.world_size)
    stuck = rescue_cnt >= thresh
    finite = torch.isfinite(logp)
    score = torch.where(finite, logp, -torch.inf)
    best = score.max()
    if mesh is not None:
        best = mesh.max(best)
    lanes = torch.arange(C, device=logp.device, dtype=torch.int64) + rank * C
    sentinel = C * world
    donor = torch.where(finite & (score == best), lanes, sentinel).min()
    if mesh is not None:
        donor = mesh.min(donor)
    apply = stuck & torch.isfinite(best) & (donor != sentinel)
    local = donor - rank * C
    mine = (local >= 0) & (local < C)
    take = local.clamp(0, C - 1).reshape(1)
    row = torch.cat([q.index_select(0, take)[0],
                     logp.index_select(0, take),
                     grad.index_select(0, take)[0]])
    row = torch.where(mine, row, torch.zeros_like(row))
    if mesh is not None:
        row = mesh.sum(row)
    n = q.shape[1]
    q = _where(apply, row[:n].expand_as(q), q)
    logp = torch.where(apply, row[n], logp)
    grad = _where(apply, row[n + 1:].expand_as(grad), grad)
    return q, logp, grad, torch.zeros_like(rescue_cnt), apply


class NutsKernelState(NamedTuple):
    """Per-chain NUTS state, each field with a leading chain dimension."""

    q: torch.Tensor             # the stepper's own coordinates (chains, dim)
    logp: torch.Tensor
    grad: torch.Tensor
    da: DAState
    pot: tuple                  # the potential's kernel state
    rescue_cnt: torch.Tensor    # divergences in the current tuning window
    eps_scale: torch.Tensor     # per-lane step-size multiplier (<= 1)


class NUTS(BaseHMC):
    """Adaptive No-U-Turn sampler (cf. ``nuts.py:390``).

    ``axis_name`` (any value) turns on pooled adaptation across all chains
    of the batch: one step size, one mass matrix, the per-lane step-size
    fallback and the stuck-lane rescue, as in the JAX package.
    ``step_rand`` is accepted and unused, as there.
    """

    name = "nuts"
    default_blocked = True
    generates_stats = True
    stats_dtypes = [{
        "depth": np.int64,
        "step_size": np.float64,
        "tune": bool,
        "mean_tree_accept": np.float64,
        "step_size_bar": np.float64,
        "tree_size": np.float64,
        "diverging": bool,
        "energy_error": np.float64,
        "energy": np.float64,
        "max_energy_error": np.float64,
        "model_logp": np.float64,
        "step_size_scale": np.float64,
        "rescued": bool,
    }]

    def __init__(self, vars=None, max_treedepth=10, early_max_treedepth=8,
                 target_accept=0.8, step_scale=0.25, Emax=1000,
                 adapt_step_size=True, step_rand=None, potential=None,
                 model=None, scaling=None, is_cov=False,
                 gamma=0.05, k=0.75, t0=10, axis_name=None,
                 rescue_stuck=True, **kwargs):
        model = modelcontext(model)
        kwargs.pop("blocked", None)
        super().__init__(vars, model=model, blocked=True, **kwargs)
        self.max_treedepth = int(max_treedepth)
        self.early_max_treedepth = int(early_max_treedepth)
        self.target_accept = float(target_accept)
        self.Emax = float(Emax)
        self.adapt_step_size = bool(adapt_step_size)
        self.gamma, self.k, self.t0 = gamma, k, t0
        self.tune = True
        self.axis_name = axis_name
        self.pooled = axis_name is not None
        self.rescue_stuck = bool(rescue_stuck)
        self.step_size = float(step_scale) / (self.dim ** 0.25)
        if scaling is not None:
            potential = quad_potential(scaling, is_cov)
        if potential is None:
            mean = np.concatenate([np.ravel(v.test_value) for v in self.vars])
            potential = QuadPotentialDiagAdapt(self.dim, floatX(mean))
        self.potential = potential

    def kernel_init(self, q0) -> NutsKernelState:
        x0 = self._sub(q0)
        logp, grad = self._value_and_grad_at(q0)(x0)
        C = q0.shape[0]
        da = da_init(torch.full((C,), self.step_size, dtype=q0.dtype,
                                device=q0.device))
        return NutsKernelState(
            q=x0, logp=logp, grad=grad, da=da,
            pot=self.potential.init_kernel_state(C, q0.device),
            rescue_cnt=torch.zeros(C, dtype=torch.int32, device=q0.device),
            eps_scale=torch.ones_like(logp))

    def _max_treedepth(self, tctx: TuneContext) -> int:
        """Depth cap of this draw (cf. nuts.py:518-545): 8 for the first
        200 tuning draws; pooled runs cap 5 for 32 draws, then 6, while the
        pooled mass matrix is still warming."""
        early = tctx.tune and tctx.step_idx < 200
        mtd = min(self.early_max_treedepth, self.max_treedepth) if early \
            else self.max_treedepth
        if self.pooled:
            if tctx.tune and tctx.step_idx < 32:
                mtd = min(5, self.max_treedepth)
            elif early:
                mtd = min(6, self.max_treedepth)
        return mtd

    def kernel_step(self, q, state: NutsKernelState, tctx: TuneContext,
                    noise):
        """One transition of every chain (cf. ``kernel_step``, nuts.py:483)."""
        tune = tctx.tune
        eps = da_current(state.da, tune) * state.eps_scale
        var = kernel_mass(state.pot)
        p0 = kernel_momentum(state.pot, noise.normal(self.dim))
        lp_fn = self._value_and_grad_at(q)
        x0 = self._sub(q)
        if self.is_partial:
            # other steppers moved the rest of q since our last call: the
            # cached logp and gradient no longer describe this point
            logp0, grad0 = lp_fn(x0)
        else:
            logp0, grad0 = state.logp, state.grad
        v0 = mass_velocity(var, p0)
        start = IntegrationState(q=x0, p=p0, v=v0, q_grad=grad0,
                                 energy=0.5 * _dot(p0, v0) - logp0,
                                 model_logp=logp0)
        h0 = start.energy
        tree = nuts_draw(noise, start, h0, eps, var, lp_fn,
                         self._max_treedepth(tctx), self.Emax,
                         self.mesh if self.pooled else None)

        n_leaf = torch.clamp(tree.n_leapfrog, min=1)
        mean_accept = tree.sum_accept / n_leaf.to(eps.dtype)
        da_accept = mean_accept
        if self.pooled:
            # pool over the lanes at the unscaled step size (a lane on the
            # per-lane fallback reports acceptance at a smaller eps), in
            # float64 and over every rank
            unscaled = state.eps_scale >= 1.0
            acc = mean_accept.to(torch.float64)
            n_unscaled, masked, total, count = _ranks_sum(torch.stack([
                unscaled.to(torch.float64).sum(),
                torch.where(unscaled, acc, 0.0).sum(), acc.sum(),
                torch.full_like(acc[0], float(acc.shape[0]))]), self.mesh)
            da_accept = torch.where(
                n_unscaled > 0, masked / torch.clamp(n_unscaled, min=1.0),
                total / count).to(eps.dtype).expand_as(mean_accept)
        da_new = da_update(state.da, da_accept, tune and self.adapt_step_size,
                           target=self.target_accept, gamma=self.gamma,
                           k=self.k, t0=self.t0)
        pot_new = kernel_update(self.potential, state.pot, tree.prop.q, tune,
                                self.pooled, self.mesh)

        new_q, new_logp, new_grad = tree.prop.q, tree.prop.logp, \
            tree.prop.grad
        eps_scale = state.eps_scale
        if self.pooled and tune:
            eps_scale = torch.clamp(
                torch.where(tree.diverging, eps_scale * 0.5, eps_scale * 1.12),
                2.0 ** -8, 1.0)
        rescue_cnt = state.rescue_cnt
        rescued = torch.zeros_like(tree.diverging)
        if self.pooled and self.rescue_stuck and not self.is_partial:
            new_q, new_logp, new_grad, rescue_cnt, rescued = _rescue(
                tctx, tree.diverging, rescue_cnt, new_q, new_logp, new_grad,
                self.mesh)

        new_state = NutsKernelState(q=new_q, logp=new_logp, grad=new_grad,
                                    da=da_new, pot=pot_new,
                                    rescue_cnt=rescue_cnt,
                                    eps_scale=eps_scale)
        stats = {
            "depth": tree.depth,
            "step_size": eps,
            "tune": torch.full_like(tree.diverging, tune),
            "mean_tree_accept": mean_accept,
            "step_size_bar": torch.exp(da_new.log_bar_step),
            "tree_size": tree.n_leapfrog.to(eps.dtype),
            "diverging": tree.diverging & (not tune),
            "energy_error": tree.prop.energy - h0,
            "energy": tree.prop.energy,
            "max_energy_error": tree.max_eerr,
            "model_logp": tree.prop.logp,
            "step_size_scale": eps_scale,
            "rescued": rescued,
        }
        return self._scatter(q, new_q), new_state, stats

    @staticmethod
    def competence(var, has_grad=False):
        """cf. ``nuts.py:195``."""
        from ...vartypes import continuous_types
        dtype = getattr(getattr(var, "distribution", None), "dtype", None)
        if str(np.dtype(dtype)) in continuous_types and has_grad:
            return Competence.IDEAL
        return Competence.INCOMPATIBLE

    def warnings(self):
        """cf. ``nuts.py:684``: the per-chain warnings go to the trace's
        report, none are kept here."""
        return []
