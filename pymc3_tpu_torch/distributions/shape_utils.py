"""Shape algebra for forward sampling (cf. ``pymc3_tpu/distributions/shape_utils.py``).

The same ``size``-prepend semantics as the JAX package: a leading ``size``
on a sample's shape is set aside while the core shapes are broadcast, and
comes back only on the samples that carried it. Samples may be tensors or
numpy arrays; each comes back as the kind it went in as.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = [
    "to_tuple",
    "shapes_broadcasting",
    "broadcast_dist_samples_shape",
    "get_broadcastable_dist_samples",
    "broadcast_distribution_samples",
    "broadcast_dist_samples_to",
]


def to_tuple(shape):
    """None -> (), int -> (int,), iterable -> tuple (cf. ``shape_utils.py:17``)."""
    if shape is None:
        return tuple()
    temp = np.atleast_1d(shape)
    if temp.size == 0:
        return tuple()
    return tuple(int(s) for s in temp)


def shapes_broadcasting(*args, raise_exception=False):
    """Broadcast shape of the given shapes, or None (cf. ``:27``)."""
    x = list(args[0]) if args else []
    for arg in args[1:]:
        y = list(arg)
        if len(x) < len(y):
            x, y = y, x
        if len(y) > 0:
            x[-len(y):] = [
                j if i == 1 else i if j == 1 else i if i == j else None
                for i, j in zip(x[-len(y):], y)
            ]
        if any(a is None for a in x):
            if raise_exception:
                raise ValueError(
                    f"Supplied shapes {args} do not broadcast together")
            return None
    return tuple(x)


def broadcast_dist_samples_shape(shapes, size=None):
    """Broadcast shapes that may carry a leading ``size`` prepend
    (cf. ``:46``). The prepend is set aside while the cores are broadcast
    and comes back only through the shapes that carried it."""
    if size is None:
        return shapes_broadcasting(*shapes, raise_exception=True)
    shapes = [tuple(s) for s in shapes]
    _size = to_tuple(size)

    def _has_prepend(s):
        return _size == s[:min(len(_size), len(s))]

    cores = [s[len(_size):] if _has_prepend(s) else s for s in shapes]
    core_shape = shapes_broadcasting(*cores, raise_exception=True)
    padded = [
        _size + (1,) * (len(core_shape) - len(core)) + core
        if _has_prepend(s) else s
        for s, core in zip(shapes, cores)
    ]
    return shapes_broadcasting(*padded, raise_exception=True)


def _as_sample(s):
    return s if isinstance(s, torch.Tensor) else np.asarray(s)


def _broadcast_to(s, shape):
    if isinstance(s, torch.Tensor):
        return torch.broadcast_to(s, shape)
    return np.broadcast_to(s, shape)


def get_broadcastable_dist_samples(samples, size=None, must_bcast_with=None,
                                   return_out_shape=False):
    """Reshape samples that may carry a leading ``size`` prepend so that
    they broadcast together (cf. ``:71``)."""
    samples = [_as_sample(s) for s in samples]
    _size = to_tuple(size)
    if must_bcast_with is not None:
        must_bcast_with = to_tuple(must_bcast_with)
    shapes = [tuple(s.shape) for s in samples]
    out_shape = broadcast_dist_samples_shape(
        shapes + ([must_bcast_with] if must_bcast_with else []), size=size)
    outs = []
    for s, shape in zip(samples, shapes):
        # an empty size counts as a universal prepend, so everything pads
        # to rank (the reference's min-slice test)
        if _size == shape[:min(len(_size), len(shape))]:
            core = shape[len(_size):]
            pad = len(out_shape) - len(_size) - len(core)
            outs.append(s.reshape(_size + (1,) * pad + core))
        else:
            outs.append(s)
    if return_out_shape:
        return outs, out_shape
    return outs


def broadcast_distribution_samples(samples, size=None):
    """Broadcast all samples to their common shape (cf. ``:99``)."""
    outs, out_shape = get_broadcastable_dist_samples(
        samples, size=size, return_out_shape=True)
    return [_broadcast_to(o, out_shape) for o in outs]


def broadcast_dist_samples_to(to_shape, samples, size=None):
    """Broadcast samples to ``size + to_shape`` (cf. ``:106``)."""
    samples, to_shape = get_broadcastable_dist_samples(
        samples, size=size, must_bcast_with=to_shape, return_out_shape=True)
    return [_broadcast_to(o, to_shape) for o in samples]
