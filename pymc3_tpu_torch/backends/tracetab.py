"""Trace → DataFrame conversion (cf. ``pymc3_tpu/backends/tracetab.py``);
pandas is imported when called."""
from __future__ import annotations

from itertools import product

import numpy as np

__all__ = ["trace_to_dataframe"]


def create_flat_names(varname, shape):
    """Column labels for the raveled elements of ``varname`` with ``shape``
    (cf. ``tracetab.py:52``): ``x`` → ``['x']``; ``(2, 2)`` →
    ``['x__0_0', 'x__0_1', 'x__1_0', 'x__1_1']`` (C order)."""
    if not shape:
        return [varname]
    index_tuples = product(*(range(int(n)) for n in shape))
    return [varname + "__" + "_".join(str(i) for i in idx)
            for idx in index_tuples]


def trace_to_dataframe(trace, chains=None, varnames=None,
                       include_transformed=False):
    """Convert trace to pandas DataFrame (cf. ``tracetab.py:26``): one
    column per raveled element of each (selected) variable, chains
    concatenated along rows."""
    shapes = trace._straces[trace.chains[0]].var_shapes
    if varnames is None:
        varnames = [v for v in trace.varnames
                    if include_transformed or not v.endswith("__")]

    columns = {}
    for v in varnames:
        vals = np.asarray(trace.get_values(v, chains=chains, combine=True))
        flat = vals.reshape(vals.shape[0], -1)
        for j, label in enumerate(create_flat_names(v, shapes[v])):
            columns[label] = flat[:, j]
    import pandas as pd
    return pd.DataFrame(columns)


def _create_shape(flat_names):
    """Invert ``create_flat_names``: recover the shape from the last
    label's index suffix."""
    last = flat_names[-1]
    if "__" not in last:
        return ()
    suffix = last.rsplit("__", 1)[1]
    return tuple(int(i) + 1 for i in suffix.split("_"))
