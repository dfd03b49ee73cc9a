"""Node-aware math (cf. ``pymc3_tpu/math.py``): each function takes
symbolic nodes or concrete values and returns a node. Only the elementwise
core is ported so far."""
from __future__ import annotations

import functools

import torch

from .node import apply

__all__ = ["exp", "log", "log1p", "sqrt", "sqr", "abs_", "sum", "logaddexp",
           "where", "switch"]


def _wrap(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        return apply(lambda *a: fn(*a, **kwargs), *args)
    return wrapped


exp = _wrap(torch.exp)
log = _wrap(torch.log)
log1p = _wrap(torch.log1p)
sqrt = _wrap(torch.sqrt)
abs_ = _wrap(torch.abs)
logaddexp = _wrap(torch.logaddexp)
where = switch = _wrap(torch.where)


def sqr(x):
    return apply(torch.square, x)


def sum(x, axis=None, keepdims=False):
    return apply(lambda v: torch.sum(v) if axis is None
                 else torch.sum(v, dim=axis, keepdim=keepdims), x)
