"""Compound step method (cf. ``pymc3_tpu/step_methods/compound.py``).

Applies several steppers in sequence to one batch of flat vectors: the
compound kernel threads ``q: (chains, n)`` through each member's kernel, so
a NUTS over the continuous variables and a Metropolis over the discrete ones
advance every chain together, draw by draw.
"""
from __future__ import annotations

from .arraystep import TuneContext

__all__ = ["CompoundStep"]


class CompoundStep:
    """Step method composed of several step methods applied in sequence
    (cf. ``compound.py:18``)."""

    def __init__(self, methods):
        self.methods = list(methods)
        self.generates_stats = any(m.generates_stats for m in self.methods)
        self.stats_dtypes = []
        for method in self.methods:
            if method.generates_stats:
                self.stats_dtypes.extend(method.stats_dtypes)
        self.name = "compound"
        self.tune = True

    # -- kernel --------------------------------------------------------------
    def kernel_init(self, q0):
        return tuple(m.kernel_init(q0) for m in self.methods)

    def kernel_step(self, q, states, tctx: TuneContext, noise):
        """Each member in turn on the ``q`` the one before it left. The
        statistics come back as a flat list that parallels ``stats_dtypes``
        (a nested compound's list is spliced in)."""
        new_states = []
        all_stats = []
        for method, state in zip(self.methods, states):
            q, s_new, stats = method.kernel_step(q, state, tctx, noise)
            new_states.append(s_new)
            if method.generates_stats:
                if isinstance(stats, list):
                    all_stats.extend(stats)
                else:
                    all_stats.append(stats)
        return q, tuple(new_states), all_stats

    # -- host-side single-draw API -------------------------------------------
    def step(self, point):
        stats_list = []
        for method in self.methods:
            if method.generates_stats:
                point, stats = method.step(point)
                stats_list.extend(stats)
            else:
                point = method.step(point)
        if self.generates_stats:
            return point, stats_list
        return point

    def warnings(self):
        warns = []
        for method in self.methods:
            if hasattr(method, "warnings"):
                warns.extend(method.warnings())
        return warns

    def stop_tuning(self):
        for method in self.methods:
            method.stop_tuning()
        self.tune = False

    def reset_tuning(self):
        for method in self.methods:
            if hasattr(method, "reset_tuning"):
                method.reset_tuning()

    @property
    def vars(self):
        return [var for method in self.methods for var in method.vars]

    def __repr__(self):
        return f"CompoundStep({[repr(m) for m in self.methods]})"
