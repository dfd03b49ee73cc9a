"""Bijective reparameterizations (cf. ``pymc3_tpu/distributions/transforms.py``).

Conventions as in the JAX package:

- ``forward(x, env) -> z`` maps the constrained value to the unconstrained
  space the samplers see;
- ``backward(z, env) -> x`` inverts it;
- ``jacobian_det(z, env)`` is log|det d backward / dz|, summed into the
  joint logp by the model;
- ``forward_shape(shape)`` is the shape of the unconstrained space (one
  less on the last axis for the simplex transforms).

Transforms with parameters (``Interval``, ``LowerBound``, ``UpperBound``)
hold them as symbolic nodes, so a bound may be another random variable;
``env`` resolves it when the model is evaluated. Every function is a plain
tensor function that batches under ``torch.func.vmap``.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..config import floatX
from ..node import Node, as_node, evaluate

__all__ = [
    "Transform", "transform", "stick_breaking", "logodds", "interval",
    "log_exp_m1", "lowerbound", "upperbound", "ordered", "log", "sum_to_1",
    "circular", "CholeskyCovPacked", "Chain", "Log", "LogExpM1", "LogOdds",
    "Interval", "LowerBound", "UpperBound", "Ordered", "SumTo1",
    "StickBreaking", "Circular",
]


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.as_tensor(np.asarray(x), device="cpu")


def _node(x):
    return x if isinstance(x, Node) else as_node(floatX(np.asarray(x)))


def _param(node, env, memo, like):
    """A transform parameter evaluated against ``env``, on ``like``'s
    device (a host-side ``forward_val`` meets bounds held on the card)."""
    val = evaluate(node, env or {}, {} if memo is None else memo)
    return val.to(like.device) if val.device != like.device else val


class Transform:
    """Base transform class (cf. ``transforms.py:46``)."""

    name = ""

    def forward(self, x, env=None, memo=None):
        raise NotImplementedError

    def backward(self, z, env=None, memo=None):
        raise NotImplementedError

    def jacobian_det(self, z, env=None, memo=None):
        raise NotImplementedError

    def forward_val(self, x, point=None):
        """numpy -> numpy, on the host; ``point`` resolves symbolic
        parameters."""
        env = {k: _host(v) for k, v in (point or {}).items()}
        return self.forward(_host(x), env=env).numpy()

    def backward_val(self, z, point=None):
        """numpy -> numpy, on the host."""
        env = {k: _host(v) for k, v in (point or {}).items()}
        return self.backward(_host(z), env=env).numpy()

    def forward_shape(self, shape):
        return tuple(shape)

    def backward_shape(self, shape):
        return tuple(shape)

    def apply(self, dist):
        from .distribution import TransformedDistribution
        return TransformedDistribution.dist(dist, self)

    def __str__(self):
        return self.name + " transform"


class Log(Transform):
    """Positive support: z = log(x) (cf. ``transforms.py:203``)."""

    name = "log"

    def forward(self, x, env=None, memo=None):
        return torch.log(x)

    def backward(self, z, env=None, memo=None):
        return torch.exp(z)

    def jacobian_det(self, z, env=None, memo=None):
        return z


log = Log()


class LogExpM1(Transform):
    """Positive support through softplus (cf. ``transforms.py:222``)."""

    name = "log_exp_m1"

    def forward(self, x, env=None, memo=None):
        # log(exp(x) - 1) = x + log(1 - exp(-x)), stable
        return torch.log(-torch.expm1(-x)) + x

    def backward(self, z, env=None, memo=None):
        return F.softplus(z)

    def jacobian_det(self, z, env=None, memo=None):
        return -F.softplus(-z)


log_exp_m1 = LogExpM1()


class LogOdds(Transform):
    """(0, 1) support: z = logit(x) (cf. ``transforms.py:246``)."""

    name = "logodds"

    def forward(self, x, env=None, memo=None):
        return torch.special.logit(x)

    def backward(self, z, env=None, memo=None):
        return torch.sigmoid(z)

    def jacobian_det(self, z, env=None, memo=None):
        return -F.softplus(z) - F.softplus(-z)


logodds = LogOdds()


class Interval(Transform):
    """(a, b) support; the bounds may be symbolic (cf. ``transforms.py:262``)."""

    name = "interval"

    def __init__(self, a, b):
        self.a = _node(a)
        self.b = _node(b)

    def _bounds(self, env, memo, like):
        return (_param(self.a, env, memo, like),
                _param(self.b, env, memo, like))

    def forward(self, x, env=None, memo=None):
        a, b = self._bounds(env, memo, x)
        return torch.log(x - a) - torch.log(b - x)

    def backward(self, z, env=None, memo=None):
        a, b = self._bounds(env, memo, z)
        return a + (b - a) * torch.sigmoid(z)

    def jacobian_det(self, z, env=None, memo=None):
        a, b = self._bounds(env, memo, z)
        return torch.log(b - a) - F.softplus(z) - F.softplus(-z)


interval = Interval


class LowerBound(Transform):
    """[a, inf) support (cf. ``transforms.py:295``)."""

    name = "lowerbound"

    def __init__(self, a):
        self.a = _node(a)

    def forward(self, x, env=None, memo=None):
        return torch.log(x - _param(self.a, env, memo, x))

    def backward(self, z, env=None, memo=None):
        return torch.exp(z) + _param(self.a, env, memo, z)

    def jacobian_det(self, z, env=None, memo=None):
        return z


lowerbound = LowerBound


class UpperBound(Transform):
    """(-inf, b] support (cf. ``transforms.py:330``)."""

    name = "upperbound"

    def __init__(self, b):
        self.b = _node(b)

    def forward(self, x, env=None, memo=None):
        return torch.log(_param(self.b, env, memo, x) - x)

    def backward(self, z, env=None, memo=None):
        return _param(self.b, env, memo, z) - torch.exp(z)

    def jacobian_det(self, z, env=None, memo=None):
        return z


upperbound = UpperBound


class Ordered(Transform):
    """Increasing along the last axis (cf. ``transforms.py:365``)."""

    name = "ordered"

    def forward(self, x, env=None, memo=None):
        return torch.cat([x[..., :1], torch.log(x[..., 1:] - x[..., :-1])],
                         dim=-1)

    def backward(self, z, env=None, memo=None):
        return torch.cumsum(torch.cat([z[..., :1], torch.exp(z[..., 1:])],
                                      dim=-1), dim=-1)

    def jacobian_det(self, z, env=None, memo=None):
        return torch.cat([torch.zeros_like(z[..., :1]), z[..., 1:]], dim=-1)


ordered = Ordered()


class SumTo1(Transform):
    """A vector summing to one: drop the last element
    (cf. ``transforms.py:397``)."""

    name = "sumto1"

    def forward(self, x, env=None, memo=None):
        return x[..., :-1]

    def backward(self, z, env=None, memo=None):
        return torch.cat([z, 1.0 - torch.sum(z, dim=-1, keepdim=True)],
                         dim=-1)

    def jacobian_det(self, z, env=None, memo=None):
        return torch.zeros_like(torch.sum(z, dim=-1))

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def backward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)


sum_to_1 = SumTo1()


class StickBreaking(Transform):
    """Simplex <-> R^(K-1) by Stan's stick breaking (cf. ``transforms.py:423``).

    The JAX package uses Stan's formulation rather than the reference
    PyMC3's, and so does the port, since parity is held against it. Where
    the JAX package runs a ``lax.scan`` over the sticks, the remaining
    lengths here are one cumulative sum of ``log(1 - v)``.
    """

    name = "stickbreaking"

    def __init__(self, eps=None):
        pass

    @staticmethod
    def _offset(k, like):
        return torch.log(torch.arange(k, 0, -1, dtype=like.dtype,
                                      device=like.device))

    def forward(self, x, env=None, memo=None):
        rem = 1.0 - torch.cumsum(x[..., :-1], dim=-1)
        rem = torch.cat([torch.ones_like(x[..., :1]), rem[..., :-1]], dim=-1)
        v = x[..., :-1] / rem  # stick fractions in (0, 1)
        return torch.special.logit(v) + self._offset(x.shape[-1] - 1, x)

    def _log_rems(self, zc):
        """log of the stick left before each break, and after the last."""
        log_left = torch.cumsum(F.logsigmoid(-zc), dim=-1)
        before = torch.cat([torch.zeros_like(zc[..., :1]),
                            log_left[..., :-1]], dim=-1)
        return before, log_left[..., -1:]

    def backward(self, z, env=None, memo=None):
        zc = z - self._offset(z.shape[-1], z)
        before, last = self._log_rems(zc)
        return torch.cat([torch.exp(before) * torch.sigmoid(zc),
                          torch.exp(last)], dim=-1)

    def jacobian_det(self, z, env=None, memo=None):
        zc = z - self._offset(z.shape[-1], z)
        before, _ = self._log_rems(zc)
        # log|J| = sum_k [ log(rem_k) + log v_k (1 - v_k) ]
        return torch.sum(before - F.softplus(zc) - F.softplus(-zc), dim=-1)

    def forward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def backward_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] + 1,)


stick_breaking = StickBreaking()


class Circular(Transform):
    """(-pi, pi) identity with wrap-around (cf. ``transforms.py:495``)."""

    name = "circular"

    def forward(self, x, env=None, memo=None):
        return x

    def backward(self, z, env=None, memo=None):
        return torch.atan2(torch.sin(z), torch.cos(z))

    def jacobian_det(self, z, env=None, memo=None):
        return torch.zeros_like(z)


circular = Circular()


class CholeskyCovPacked(Transform):
    """Packed cholesky factor with a log-transformed diagonal
    (cf. ``transforms.py:517``)."""

    name = "cholesky-cov-packed"

    def __init__(self, n):
        self.n = int(n)
        self.diag_idxs = np.arange(1, self.n + 1).cumsum() - 1

    def _mask(self, like):
        mask = np.zeros(like.shape[-1], dtype=bool)
        mask[self.diag_idxs] = True
        return torch.as_tensor(mask, device=like.device)

    def forward(self, x, env=None, memo=None):
        mask = self._mask(x)
        return torch.where(mask, torch.log(torch.where(mask, x, 1.0)), x)

    def backward(self, z, env=None, memo=None):
        mask = self._mask(z)
        return torch.where(mask, torch.exp(torch.where(mask, z, 0.0)), z)

    def jacobian_det(self, z, env=None, memo=None):
        return torch.sum(z[..., torch.as_tensor(self.diag_idxs,
                                                device=z.device)], dim=-1)


class Chain(Transform):
    """Compose transforms, the first applied first (cf. ``transforms.py:537``)."""

    def __init__(self, transform_list):
        self.transform_list = list(transform_list)
        self.name = "+".join([t.name for t in self.transform_list])

    def forward(self, x, env=None, memo=None):
        for t in self.transform_list:
            x = t.forward(x, env, memo)
        return x

    def backward(self, z, env=None, memo=None):
        for t in reversed(self.transform_list):
            z = t.backward(z, env, memo)
        return z

    def jacobian_det(self, z, env=None, memo=None):
        total = 0.0
        for t in reversed(self.transform_list):
            total = total + torch.sum(t.jacobian_det(z, env, memo))
            z = t.backward(z, env, memo)
        return total

    def forward_shape(self, shape):
        for t in self.transform_list:
            shape = t.forward_shape(shape)
        return tuple(shape)

    def backward_shape(self, shape):
        for t in reversed(self.transform_list):
            shape = t.backward_shape(shape)
        return tuple(shape)


transform = Transform
