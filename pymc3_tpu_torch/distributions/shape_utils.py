"""Shape helpers (cf. ``pymc3_tpu/distributions/shape_utils.py``). Only
``to_tuple`` is on the sampling path; the broadcasting algebra of forward
sampling is not ported yet."""
from __future__ import annotations

import numpy as np

__all__ = ["to_tuple"]


def to_tuple(shape):
    """None -> (), int -> (int,), iterable -> tuple (cf. ``shape_utils.py:33``)."""
    if shape is None:
        return tuple()
    temp = np.atleast_1d(shape)
    if temp.size == 0:
        return tuple()
    return tuple(int(s) for s in temp)
