"""Flat-vector ordering & bijections (cf. ``pymc3_tpu/blocking.py``).

``ArrayOrdering`` maps each free RV's *unconstrained* space to a slice of
one flat vector ``q``, in the same variable order as the JAX package, so
flat vectors of the two packages are interchangeable. The flat vector is
the only representation the samplers see; a batch of chains is a
``(chains, n)`` tensor.
"""
from __future__ import annotations

import collections
from typing import Dict, List

import numpy as np

__all__ = ["VarMap", "ArrayOrdering", "DictToArrayBijection"]

VarMap = collections.namedtuple("VarMap", "var, slc, shp, dtyp")


class ArrayOrdering:
    """An ordering for an array space (cf. ``pymc3/blocking.py:33``).

    ``vars`` must expose ``name``, ``unconstrained_shape`` and ``dtype``.
    """

    def __init__(self, vars):
        self.vmap: List[VarMap] = []
        self.by_name: Dict[str, VarMap] = {}
        self.size = 0
        for var in vars:
            name = var.name
            if name is None:
                raise ValueError("unnamed variable in ArrayOrdering")
            shape = tuple(getattr(var, "unconstrained_shape", None) or var.shape)
            count = int(np.prod(shape, dtype=int))
            slc = slice(self.size, self.size + count)
            vm = VarMap(name, slc, shape, np.dtype(var.dtype).name)
            self.vmap.append(vm)
            self.by_name[name] = vm
            self.size += count

    def __getitem__(self, key):
        return self.by_name[key]

    def __iter__(self):
        return iter(self.vmap)


class DictToArrayBijection:
    """Map between Point dicts and flat vectors (cf. ``blocking.py:62``)."""

    def __init__(self, ordering: ArrayOrdering, dpoint: Dict[str, np.ndarray]):
        self.ordering = ordering
        self.dpt = dpoint

    def map(self, dpt: Dict[str, np.ndarray]):
        """Dict -> flat numpy array."""
        vals = [np.ravel(np.asarray(dpt[vm.var])) for vm in self.ordering.vmap]
        if not vals:
            return np.array([], dtype="float64")
        return np.concatenate(vals)

    def rmap(self, apt) -> Dict[str, np.ndarray]:
        """Flat numpy array -> dict (numpy)."""
        dpt = {}
        apt = np.asarray(apt)
        for var, slc, shp, dtyp in self.ordering.vmap:
            dpt[var] = apt[slc].reshape(shp).astype(dtyp)
        for name, val in self.dpt.items():
            if name not in dpt:
                dpt[name] = val
        return dpt
