"""Naming/startpoint utilities, mirroring ``pymc3/util.py``."""
from __future__ import annotations

import functools
from typing import Dict

import numpy as np

__all__ = ["get_transformed_name", "is_transformed_name",
           "get_untransformed_name", "get_default_varnames", "get_var_name",
           "update_start_vals", "biwrap"]


def get_transformed_name(name: str, transform) -> str:
    """``x`` + Log -> ``x_log__`` (cf. ``pymc3/util.py:50``)."""
    return f"{name}_{transform.name}__"


def is_transformed_name(name: str) -> bool:
    """Does ``name`` look like ``x_log__``?"""
    return name.endswith("__") and name.count("_") >= 3


def get_untransformed_name(name: str) -> str:
    """``x_log__`` -> ``x``; a name that is not transformed raises."""
    if not is_transformed_name(name):
        raise ValueError(f"{name} does not appear to be a transformed name")
    return "_".join(name.split("_")[:-3])


def get_default_varnames(var_iterator, include_transformed: bool):
    """The names to show a user: without the transformed ones unless
    ``include_transformed`` (cf. ``pymc3_tpu/util.py:38``)."""
    if include_transformed:
        return list(var_iterator)
    return [v for v in var_iterator
            if not is_transformed_name(get_var_name(v))]


def get_var_name(var) -> str:
    return getattr(var, "name", None) or str(var)


def update_start_vals(a: Dict, b: Dict, model) -> None:
    """Update a with b, transforming untransformed entries to match model
    (cf. ``pymc3/util.py:147``)."""
    if model is not None:
        for name in list(a):
            rv = model.named_vars.get(name)
            if rv is not None and hasattr(rv, "transformed_name") and rv.transformed_name:
                tname = rv.transformed_name
                if tname not in a:
                    a[tname] = np.asarray(rv.transform.forward_val(np.asarray(a[name])))
    for k, v in b.items():
        if k not in a:
            a[k] = v


def biwrap(wrapper):
    """Let a decorator be used with arguments or without
    (cf. ``pymc3_tpu/util.py:64``)."""
    @functools.wraps(wrapper)
    def enhanced(*args, **kwargs):
        count = 1 if args and hasattr(args[0], wrapper.__name__) else 0
        if len(args) > count and callable(args[count]):
            return wrapper(*args, **kwargs)
        return functools.partial(wrapper, *args, **kwargs)
    return enhanced
