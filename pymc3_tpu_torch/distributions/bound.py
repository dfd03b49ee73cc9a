"""Bound: truncate a distribution (cf. ``pymc3_tpu/distributions/bound.py``)."""
from __future__ import annotations

import numpy as np
import torch

from ..config import floatX
from ..node import Node, as_node, evaluate
from . import transforms
from .dist_math import bound as bound_mask
from .distribution import (
    Continuous, Discrete, Distribution, draw_values, point_lead,
)
from .shape_utils import to_tuple

__all__ = ["Bound"]

# Rounds of the rejection sampler (each redraws every rejected element at
# once), as the JAX package's 1000 tries.
_BOUND_ROUNDS = 1000


def _node(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


class _Bounded(Distribution):
    """A distribution with its support cut to [lower, upper]
    (cf. ``bound.py:17``). As in the reference the density is not
    renormalized: fine for sampling, not for model comparison."""

    def __init__(self, distribution, lower, upper, default, *args, **kwargs):
        self.lower = None if lower is None else _node(lower)
        self.upper = None if upper is None else _node(upper)
        self._wrapped = distribution.dist(*args, **kwargs)

        if default is None:
            defaults = self._wrapped.defaults
            for name in defaults:
                setattr(self, name, getattr(self._wrapped, name))
        else:
            defaults = ("_default",)
            self._default = default

        super().__init__(
            shape=self._wrapped.shape, dtype=self._wrapped.dtype,
            testval=self._wrapped.testval, defaults=defaults,
            transform=self._wrapped.transform)

        if default is None:
            self.testval = self._get_bounded_testval()

    def _get_bounded_testval(self):
        tv = np.asarray(self._wrapped.default())
        lo = -np.inf if self.lower is None else np.asarray(
            self.lower.test_value)
        hi = np.inf if self.upper is None else np.asarray(
            self.upper.test_value)
        span_lo = np.where(np.isfinite(lo), lo, tv)
        span_hi = np.where(np.isfinite(hi), hi, tv)
        out = np.clip(tv, span_lo, span_hi)
        both = np.isfinite(lo) & np.isfinite(hi)
        out = np.where(both & ((out <= lo) | (out >= hi)),
                       (lo + hi) / 2.0, out)
        only_lo = np.isfinite(lo) & ~np.isfinite(hi)
        out = np.where(only_lo & (out <= lo), lo + 1.0, out)
        only_hi = ~np.isfinite(lo) & np.isfinite(hi)
        out = np.where(only_hi & (out >= hi), hi - 1.0, out)
        return out.astype(self._wrapped.dtype)

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        logp = self._wrapped.logp(value, env, memo)
        conds = []
        if self.lower is not None:
            conds.append(value >= evaluate(self.lower, env or {}, memo))
        if self.upper is not None:
            conds.append(value <= evaluate(self.upper, env or {}, memo))
        return bound_mask(logp, *conds)

    def _host_dtype(self):
        # the JAX package casts its draws to the wrapped distribution's
        return np.dtype(self._wrapped.dtype)

    def _random(self, point=None, size=None, gen=None):
        """Rejection sampling (cf. ``bound.py:80``): each round redraws
        every element still outside the bounds, in one vectorized draw."""
        gen = self._generator(gen)
        lead = point_lead(point)
        n_size = len(to_tuple(size))
        lo, hi = draw_values(
            [self.lower if self.lower is not None else -np.inf,
             self.upper if self.upper is not None else np.inf],
            point=point, size=size, gen=gen)
        out = self._wrapped._random(point=point, size=size, gen=gen)
        n_core = out.ndim - n_size

        def align(b):
            own = b.ndim - lead
            return b.reshape(tuple(b.shape[:lead]) + (1,) * (n_size - lead)
                             + (1,) * (n_core - own) + tuple(b.shape[lead:]))
        lo, hi = align(lo), align(hi)
        bad = (out < lo) | (out > hi)
        for _ in range(_BOUND_ROUNDS):
            if not bool(bad.any()):
                return out
            redraw = self._wrapped._random(point=point, size=size, gen=gen)
            out = torch.where(bad, redraw, out)
            bad = (out < lo) | (out > hi)
        if bool(bad.any()):
            raise RuntimeError(
                "Could not sample from bounded distribution in "
                f"{_BOUND_ROUNDS} tries")
        return out


class _DiscreteBounded(_Bounded, Discrete):
    """cf. ``bound.py:102``: no transform; the test value is the middle of
    the bounds, or one step inside the only bound."""

    def __init__(self, distribution, lower, upper, transform="infer",
                 *args, **kwargs):
        if transform == "infer":
            transform = None
        if transform is not None:
            raise ValueError("Can't transform discrete variable.")
        if lower is None and upper is None:
            default = None
        elif lower is not None and upper is not None:
            default = (int(np.asarray(lower)) + int(np.asarray(upper))) // 2
        elif lower is not None:
            default = int(np.asarray(lower)) + 1
        else:
            default = int(np.asarray(upper)) - 1
        super().__init__(distribution, lower, upper, default, *args, **kwargs)


class _ContinuousBounded(_Bounded, Continuous):
    """cf. ``bound.py:122``."""

    def __init__(self, distribution, lower, upper, transform="infer",
                 *args, **kwargs):
        if transform == "infer":
            if lower is None and upper is None:
                transform = None
            elif lower is not None and upper is not None:
                transform = transforms.interval(lower, upper)
            elif lower is not None:
                transform = transforms.lowerbound(lower)
            else:
                transform = transforms.upperbound(upper)
        super().__init__(distribution, lower, upper, None, *args, **kwargs)
        self.transform = transform


class Bound:
    r"""A factory of bounded distributions (cf. ``bound.py:141``).

    Example::

        NegativeNormal = pm.Bound(pm.Normal, upper=0.0)
        x = NegativeNormal('x', mu=0., sigma=1.)
    """

    def __init__(self, distribution, lower=None, upper=None):
        if isinstance(distribution, _Bounded):
            raise ValueError("Cannot bound a bounded distribution")
        self.distribution = distribution
        self.lower = lower
        self.upper = upper

    def __call__(self, name, *args, **kwargs):
        if "observed" in kwargs:
            raise ValueError(
                "Observed Bound distributions are not supported. If you want "
                "to model truncated data you can use a pm.Potential in "
                "combination with the cumulative probability function.")
        transform = kwargs.pop("transform", "infer")
        return self._bounded_class()(name, self.distribution, self.lower,
                                     self.upper, transform, *args, **kwargs)

    def _bounded_class(self):
        return (_ContinuousBounded if issubclass(self.distribution, Continuous)
                else _DiscreteBounded)

    def dist(self, *args, **kwargs):
        transform = kwargs.pop("transform", "infer")
        return self._bounded_class().dist(self.distribution, self.lower,
                                          self.upper, transform, *args,
                                          **kwargs)
