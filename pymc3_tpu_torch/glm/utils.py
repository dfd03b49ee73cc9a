"""GLM design-matrix utilities (cf. ``pymc3_tpu/glm/utils.py``).

The port's own copy of the JAX package's patsy-free formula parser, which
covers the subset used in practice: ``y ~ x1 + x2``, ``y ~ x1 * x2``
(interactions), ``0 +``/``1 +`` intercept control, and ``C(col)``
categorical expansion. Data may be a dict of numpy arrays; pandas is
imported only when a DataFrame or a Series is passed in.
"""
from __future__ import annotations

import re
from typing import List, Tuple

import numpy as np

__all__ = ["any_to_tensor_and_labels", "design_matrices"]


def _is_pandas(x, kind):
    cls = type(x)
    return cls.__module__.startswith("pandas") and cls.__name__ == kind


def any_to_tensor_and_labels(x, labels=None):
    """Convert input to (matrix, labels) (cf. ``glm/utils.py:14``)."""
    if _is_pandas(x, "DataFrame"):
        if labels is None:
            labels = list(map(str, x.columns))
        x = x.to_numpy()
    elif _is_pandas(x, "Series"):
        if labels is None:
            labels = [str(x.name)]
        x = x.to_numpy()[:, None]
    elif isinstance(x, dict):
        if labels is None:
            labels = list(x.keys())
        x = np.column_stack([np.asarray(v) for v in x.values()])
    else:
        x = np.asarray(x)
        if x.ndim == 1:
            x = x[:, None]
    if labels is None:
        labels = [f"x{i}" for i in range(x.shape[1])]
    if len(labels) != x.shape[1]:
        raise ValueError("Length of labels does not match number of columns")
    return x, list(labels)


def _term_columns(term: str, data) -> Tuple[np.ndarray, List[str]]:
    """Columns for one formula term: var, C(var), or var1:var2."""
    term = term.strip()
    if ":" in term:
        parts = term.split(":")
        cols, names = _term_columns(parts[0], data)
        for p in parts[1:]:
            c2, n2 = _term_columns(p, data)
            cols = np.concatenate(
                [cols[:, i:i + 1] * c2 for i in range(cols.shape[1])],
                axis=1)
            names = [f"{a}:{b}" for a in names for b in n2]
        return cols, names
    m = re.fullmatch(r"C\((\w+)\)", term)
    if m:
        col = np.asarray(data[m.group(1)])
        levels = np.unique(col)
        # drop first level (treatment coding)
        cols = np.column_stack([(col == lv).astype(float)
                                for lv in levels[1:]])
        names = [f"C({m.group(1)})[T.{lv}]" for lv in levels[1:]]
        return cols, names
    col = np.asarray(data[term], dtype=float)
    return col[:, None], [term]


def design_matrices(formula: str, data) -> Tuple[np.ndarray, np.ndarray,
                                                 List[str]]:
    """Parse ``y ~ rhs`` into (y, X, labels) with patsy-like semantics."""
    if "~" not in formula:
        raise ValueError(f"Formula must contain '~': {formula!r}")
    lhs, rhs = formula.split("~", 1)
    lhs = lhs.strip()
    y = np.asarray(data[lhs], dtype=float)

    intercept = True
    terms = []
    for raw in rhs.split("+"):
        t = raw.strip()
        if t == "0" or t == "-1":
            intercept = False
        elif t == "1" or t == "":
            intercept = True
        elif "*" in t:
            # a*b = a + b + a:b
            parts = [p.strip() for p in t.split("*")]
            terms.extend(parts)
            terms.append(":".join(parts))
        else:
            terms.append(t)

    cols, names = [], []
    for term in terms:
        c, n = _term_columns(term, data)
        cols.append(c)
        names.extend(n)
    X = np.concatenate(cols, axis=1) if cols else \
        np.empty((len(y), 0))
    if intercept:
        X = np.concatenate([np.ones((len(y), 1)), X], axis=1)
        names = ["Intercept"] + names
    return y, X, names
