"""GP mean functions (cf. ``pymc3_tpu/gp/mean.py``). Ported so far: Zero."""
from __future__ import annotations

import torch

from ..config import torch_floatX
from ..node import apply as node_apply, as_node

__all__ = ["Zero", "Mean"]


class Mean:
    """Base mean class (cf. ``mean.py:22``)."""

    def __call__(self, X):
        raise NotImplementedError


class Zero(Mean):
    """cf. ``mean.py:42``."""

    def __call__(self, X):
        return node_apply(
            lambda X_: torch.zeros(X_.shape[0] if X_.ndim else 1,
                                   dtype=torch_floatX(), device=X_.device),
            as_node(X))
