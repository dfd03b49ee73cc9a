"""Mixture distributions (cf. ``pymc3_tpu/distributions/mixture.py``).

``Mixture.random`` is vectorized where the JAX package loops over rows:
the component of every draw comes from ``torch.multinomial`` (one call for
all rows that share a weight vector), and the draw is a gather from all
components' draws.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import floatX, intX
from ..node import Node, as_node, apply, evaluate
from .continuous import get_tau_sigma, Normal
from .distribution import (
    Distribution, Discrete, draw_values, point_lead, _align,
)
from .shape_utils import to_tuple

__all__ = ["Mixture", "NormalMixture"]


def _an(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


def all_discrete(comp_dists):
    if isinstance(comp_dists, Distribution):
        return isinstance(comp_dists, Discrete)
    return all(isinstance(c, Discrete) for c in comp_dists)


def _stack_last(tensors):
    return torch.stack(torch.broadcast_tensors(*tensors), dim=-1)


def _categorical(w, target, gen):
    """Component indices of shape ``target`` from weights ``w`` that
    broadcast against ``target + (K,)`` (same rank)."""
    K = w.shape[-1]
    wb = tuple(w.shape[:-1])
    # the weights vary only over a leading block of target's axes: one
    # multinomial call draws all the trailing cells of each weight row
    j = len(target)
    while j > 0 and wb[j - 1] == 1:
        j -= 1
    n_cells = int(np.prod(target, dtype=int))
    if n_cells == 0:
        return torch.zeros(target, dtype=torch.int64, device=w.device)
    if wb[:j] == tuple(target[:j]):
        rows = w.reshape(-1, K)
        m = int(np.prod(target[j:], dtype=int))
    else:
        rows = torch.broadcast_to(w, tuple(target) + (K,)).reshape(-1, K)
        m = 1
    rows = rows / rows.sum(-1, keepdim=True)
    idx = torch.multinomial(rows, m, replacement=True, generator=gen)
    return idx.reshape(target)


class Mixture(Distribution):
    r"""Finite mixture (cf. ``mixture.py:30``).

    ``comp_dists`` is either a list of ``.dist()`` instances or one
    distribution whose *last* axis indexes the components.
    """

    def __init__(self, w, comp_dists, *args, **kwargs):
        self.w = _an(w)
        self.comp_dists = comp_dists
        defaults = list(kwargs.pop("defaults", []))
        if all_discrete(comp_dists):
            default_dtype = intX()
        else:
            default_dtype = floatX()
            try:
                self.mean = apply(
                    lambda w, *means: torch.sum(w * _stack_last(means), dim=-1)
                    if len(means) > 1 else torch.sum(w * means[0], dim=-1),
                    self.w, *self._comp_means())
                if "mean" not in defaults:
                    defaults.append("mean")
            except (AttributeError, ValueError, RuntimeError):
                pass
        dtype = kwargs.pop("dtype", default_dtype)
        try:
            def _mode(w, *modes):
                stacked = (_stack_last([m.to(w.dtype) for m in modes])
                           if len(modes) > 1 else modes[0].to(w.dtype))
                bshape = np.broadcast_shapes(tuple(stacked.shape),
                                             tuple(w.shape))
                stacked = torch.broadcast_to(stacked, bshape)
                idx = torch.argmax(torch.broadcast_to(w, bshape), dim=-1,
                                   keepdim=True)
                return torch.gather(stacked, -1, idx)[..., 0]

            self.mode = apply(_mode, self.w, *self._comp_modes())
            if "mode" not in defaults:
                defaults.append("mode")
        except (AttributeError, ValueError, RuntimeError,
                NotImplementedError):
            pass
        super().__init__(dtype=dtype, defaults=defaults, *args, **kwargs)

    def _comp_means(self):
        if isinstance(self.comp_dists, Distribution):
            return [self.comp_dists.mean]
        return [d.mean for d in self.comp_dists]

    def _comp_modes(self):
        if isinstance(self.comp_dists, Distribution):
            return [self.comp_dists.mode]
        return [d.mode for d in self.comp_dists]

    def _comp_logp(self, value, env, memo):
        """Component logps stacked on a trailing component axis
        (cf. ``mixture.py:91``)."""
        if isinstance(self.comp_dists, Distribution):
            # batched components: the value broadcasts against their axis
            return self.comp_dists.logp(value[..., None], env, memo)
        return _stack_last([d.logp(value, env, memo)
                            for d in self.comp_dists])

    def logp(self, value, env=None, memo=None):
        env = env or {}
        memo = {} if memo is None else memo
        w = evaluate(self.w, env, memo)
        comp_logp = self._comp_logp(value, env, memo)
        w_ok = (torch.all(w >= 0) & torch.all(w <= 1)
                & torch.all(torch.abs(torch.sum(w, dim=-1) - 1.0) < 1e-4))
        out = torch.logsumexp(torch.log(torch.where(w > 0, w, 1e-30))
                              + comp_logp, dim=-1)
        return torch.where(w_ok, out, -torch.inf)

    def _comp_samples(self, point, size_t, gen):
        """Every component's draws, ``size + shape + (K,)``."""
        shape = tuple(self.shape)
        comps = ([self.comp_dists] if isinstance(self.comp_dists, Distribution)
                 else self.comp_dists)
        out = []
        for d in comps:
            core = d._draw_core()
            # a batched component dist carries the component axis last
            own = core[:-1] if d is self.comp_dists else core
            if own != shape[len(shape) - len(own):]:
                raise ValueError(f"mixture component draws of shape {core} "
                                 f"do not line up with the mixture's shape "
                                 f"{shape}")
            lead_axes = shape[:len(shape) - len(own)]
            out.append(d._random(point=point, size=size_t + lead_axes,
                                 gen=gen))
        if isinstance(self.comp_dists, Distribution):
            return out[0]
        return torch.stack(out, dim=-1)

    def _random(self, point=None, size=None, gen=None):
        gen = self._generator(gen)
        size_t = to_tuple(size)
        target = size_t + tuple(self.shape)
        w, = draw_values([self.w], point=point, size=size, gen=gen)
        w = _align(w, point_lead(point), len(size_t), len(self.shape) + 1)
        comp = _categorical(w, target, gen)
        samples = self._comp_samples(point, size_t, gen)
        samples = torch.broadcast_to(samples, target + samples.shape[-1:])
        return torch.gather(samples, -1, comp[..., None])[..., 0]


class NormalMixture(Mixture):
    r"""Mixture of normals (cf. ``mixture.py:142``)."""

    def __init__(self, w, mu, sigma=None, tau=None, sd=None, comp_shape=(),
                 *args, **kwargs):
        if sd is not None:
            sigma = sd
        _, sigma_node = get_tau_sigma(tau=tau, sigma=sigma)
        self.mu = _an(mu)
        self.sigma = self.sd = sigma_node
        super().__init__(w, Normal.dist(mu=mu, sigma=sigma_node,
                                        shape=comp_shape),
                         *args, **kwargs)
