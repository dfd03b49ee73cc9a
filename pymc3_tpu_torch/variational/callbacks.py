"""VI fit callbacks (cf. ``pymc3_tpu/variational/callbacks.py``). ``fit``
calls them once per block of steps, with the loss history on the host."""
from __future__ import annotations

import collections

import numpy as np

from .updates import tree_leaves

__all__ = ["Callback", "CheckParametersConvergence", "Tracker"]


class Callback:
    def __call__(self, approx, loss_hist, i):
        raise NotImplementedError


class CheckParametersConvergence(Callback):
    """Stop ``fit`` (by raising ``StopIteration``) once the flat vector of
    variational parameters stops moving (cf. ``callbacks.py:16``): every
    ``every`` iterations the ``ord``-norm of its absolute or relative
    change since the previous check is held against ``tolerance``."""

    def __init__(self, every=100, tolerance=1e-3, diff="relative",
                 ord=np.inf):
        if diff not in ("relative", "absolute"):
            raise ValueError(f"diff must be 'relative' or 'absolute', "
                             f"got {diff!r}")
        self.diff = diff
        self.every = int(every)
        self.tolerance = tolerance
        self.ord = ord
        self.prev = None

    def __call__(self, approx, _, i):
        if i < self.every or i % self.every:
            return
        snapshot = self.flatten_shared(approx)
        previous, self.prev = self.prev, snapshot
        if previous is None:
            return
        change = np.abs(snapshot - previous)
        if self.diff == "relative":
            change = (change + 1e-6) / (np.abs(previous) + 1e-6)
        if np.linalg.norm(change, self.ord) < self.tolerance:
            raise StopIteration(f"Convergence achieved at {i}")

    @staticmethod
    def flatten_shared(approx):
        """Every variational parameter as one flat host vector."""
        return np.concatenate([np.ravel(p.detach().cpu().numpy())
                               for p in tree_leaves(approx.params)])


class Tracker(Callback):
    """Record arbitrary statistics during ``fit`` (cf. ``callbacks.py:60``).

    >>> tracker = Tracker(mean=lambda approx, *_: approx.mean)
    """

    def __init__(self, **kwargs):
        self.whatchdict = kwargs
        self.hist = collections.defaultdict(list)

    def record(self, approx, hist, i):
        for key, fn in self.whatchdict.items():
            self.hist[key].append(fn(approx, hist, i))

    __call__ = record

    def clear(self):
        self.hist = collections.defaultdict(list)

    def __getitem__(self, item):
        return self.hist[item]
