"""Univariate slice sampler (cf. ``pymc3_tpu/step_methods/slicer.py``).

Coordinate-wise slice sampling with stepping out and shrinkage (Neal 2003)
for all chains at once. The JAX package runs each coordinate's two loops as
bounded ``lax.while_loop``s under ``vmap``; here they are Python loops over
the whole chain batch with per-lane masks: a lane whose bracket has stopped
growing, or whose shrinkage has found its point, is frozen while the others
go on, and a loop ends when no lane is active (one ``.any()`` sync per
turn, beside that turn's one or two logp calls). The caps are the JAX
package's: at most ``max_steps`` steps out on each side and ``2 *
max_steps`` shrinkage draws per coordinate.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..model import modelcontext
from ..vartypes import continuous_types
from .arraystep import ArrayStepShared, Competence, TuneContext

__all__ = ["Slice"]


class SliceState(NamedTuple):
    logp: torch.Tensor      # (chains,)
    w: torch.Tensor         # step-out width per coordinate (chains, dim)
    n_tunes: int


class Slice(ArrayStepShared):
    """Univariate slice sampler step (cf. ``slicer.py:30``)."""

    name = "slice"
    default_blocked = False
    generates_stats = True
    stats_dtypes = [{"tune": bool, "nstep_out": np.int64,
                     "nstep_in": np.int64}]

    def __init__(self, vars=None, w=1.0, tune=True, model=None,
                 iter_limit=np.inf, max_steps=64, **kwargs):
        model = modelcontext(model)
        if vars is None:
            vars = model.cont_vars
        self._setup_vars(vars, model)
        self.w = float(np.atleast_1d(w)[0])
        self.tune = bool(tune)
        self.max_steps = int(min(max_steps, iter_limit)
                             if np.isfinite(iter_limit) else max_steps)
        self._logp_fn = model.make_logp_fn()

    def kernel_init(self, q0):
        logp = self._logp_fn(q0)
        return SliceState(logp=logp,
                          w=q0.new_full((q0.shape[0], self.dim), self.w),
                          n_tunes=0)

    def _step_out(self, lp_at, y, left, right, wi):
        """Grow the bracket by ``wi`` on each side while that end is still
        inside the slice, at most ``max_steps`` times a side
        (cf. ``slicer.py:83-102``). Returns the bracket and the two step
        counts per lane."""
        cap = self.max_steps
        nl = torch.zeros_like(y, dtype=torch.int32)
        nr = torch.zeros_like(nl)
        while True:
            grow_l = lp_at(left) > y
            grow_r = lp_at(right) > y
            active = (grow_l & (nl < cap)) | (grow_r & (nr < cap))
            if not bool(active.any()):
                return left, right, nl, nr
            left = torch.where(active & grow_l & (nl < cap), left - wi, left)
            right = torch.where(active & grow_r & (nr < cap), right + wi,
                                right)
            nl = nl + (active & grow_l).to(torch.int32)
            nr = nr + (active & grow_r).to(torch.int32)

    def _shrink(self, lp_at, y, x0, logp0, left, right, noise):
        """Draw from the bracket and shrink it towards ``x0`` on a miss, at
        most ``2 * max_steps`` times (cf. ``slicer.py:105-123``); a lane
        that never hits keeps ``x0``. Returns the new coordinate, its logp
        and the draws per lane."""
        x, logp = x0, logp0
        done = torch.zeros_like(y, dtype=torch.bool)
        n_in = torch.zeros_like(y, dtype=torch.int32)
        for _ in range(2 * self.max_steps):
            active = ~done
            if not bool(active.any()):
                break
            x_new = left + (right - left) * noise.uniform()
            lp_new = lp_at(x_new)
            ok = lp_new > y
            hit = active & ok
            miss = active & ~ok
            left = torch.where(miss & (x_new < x0), x_new, left)
            right = torch.where(miss & (x_new >= x0), x_new, right)
            x = torch.where(hit, x_new, x)
            logp = torch.where(hit, lp_new, logp)
            n_in = n_in + active.to(torch.int32)
            done = done | hit
        return x, logp, n_in

    def kernel_step(self, q, state: SliceState, tctx: TuneContext, noise):
        logp = self._refresh_logp(q, state.logp)
        w_all = state.w
        n_out = torch.zeros_like(logp, dtype=torch.int32)
        n_in = torch.zeros_like(n_out)
        tune = self.tune and tctx.tune
        for i in range(self.dim):
            col = int(self.q_indices[i])
            x0 = q[:, col]
            wi = w_all[:, i]

            def lp_at(x, col=col, q=q):
                q_at = q.clone()
                q_at[:, col] = x
                return self._logp_fn(q_at)

            # the slice's level, then a bracket of width wi placed at
            # random around x0
            y = logp - noise.exponential()
            left = x0 - noise.uniform() * wi
            right = left + wi
            left, right, nl, nr = self._step_out(lp_at, y, left, right, wi)
            x_new, logp, n_i = self._shrink(lp_at, y, x0, logp, left, right,
                                            noise)
            q = q.clone()
            q[:, col] = x_new
            if tune:
                w_all = w_all.clone()
                w_all[:, i] = 0.9 * wi + 0.1 * (right - left)
            n_out = n_out + nl + nr
            n_in = n_in + n_i

        stats = {
            "tune": torch.full_like(logp, tctx.tune, dtype=torch.bool),
            "nstep_out": n_out,
            "nstep_in": n_in,
        }
        return q, SliceState(logp, w_all, state.n_tunes + 1), stats

    @staticmethod
    def competence(var, has_grad=False):
        dist = getattr(var, "distribution", None)
        dtype = getattr(dist, "dtype", None) or getattr(var, "dtype", None)
        if str(np.dtype(dtype)) in continuous_types:
            return Competence.PREFERRED
        return Competence.INCOMPATIBLE
