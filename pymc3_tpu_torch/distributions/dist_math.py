"""Numeric helpers for log-densities (cf. ``pymc3_tpu/distributions/dist_math.py``).

Only what the ported distributions use. All are tensor functions that
batch under ``torch.func.vmap``: no data-dependent Python control flow.
"""
from __future__ import annotations

import torch

__all__ = ["bound", "alltrue_elemwise", "logpow"]


def alltrue_elemwise(conditions):
    """Elementwise AND over boolean tensors (broadcasting)."""
    conds = [torch.as_tensor(c) for c in conditions]
    ret = conds[0]
    for c in conds[1:]:
        ret = ret & c
    return ret


def bound(logp, *conditions):
    """``logp`` where all conditions hold, ``-inf`` elsewhere
    (cf. ``pymc3/dist_math.py:38``)."""
    return torch.where(alltrue_elemwise(conditions), logp, -torch.inf)


def logpow(x, m):
    """Safe ``m * log(x)`` with ``0**0 = 1`` (cf. ``dist_math.py:78``)."""
    zero = x == 0
    inner = torch.where(m == 0, 0.0, -torch.inf)
    return torch.where(zero, inner,
                       m * torch.log(torch.where(zero, 1.0, x)))
