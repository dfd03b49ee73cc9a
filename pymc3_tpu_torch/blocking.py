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

__all__ = ["VarMap", "ArrayOrdering", "DictToArrayBijection",
           "ListArrayOrdering", "ListToArrayBijection", "DictToVarBijection",
           "Compose"]

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

    def mapf(self, f):
        """A function of a Point as a function of a flat array."""
        def wrapped(apt, *args, **kwargs):
            return f(self.rmap(apt), *args, **kwargs)
        return wrapped


class ListArrayOrdering:
    """An ordering for a list of arrays (cf. ``blocking.py:91``): the
    ``i``-th array's slot is named by its offset. ``intype`` is stored, as
    the JAX package stores it."""

    def __init__(self, list_arrays, intype="numpy"):
        self.vmap = []
        self.intype = intype
        self.size = 0
        for array in list_arrays:
            array = np.asarray(array)
            count = int(np.prod(array.shape, dtype=int))
            slc = slice(self.size, self.size + count)
            self.vmap.append(VarMap(str(self.size), slc, array.shape,
                                    array.dtype.name))
            self.size += count


class ListToArrayBijection:
    """Map between a list of arrays and one flat array
    (cf. ``blocking.py:108``)."""

    def __init__(self, ordering: ListArrayOrdering, list_arrays):
        self.ordering = ordering
        self.list_arrays = list_arrays

    def fmap(self, list_arrays):
        out = np.empty(self.ordering.size)
        for vm, arr in zip(self.ordering.vmap, list_arrays):
            out[vm.slc] = np.ravel(arr)
        return out

    def rmap(self, array):
        return [np.asarray(array)[vm.slc].reshape(vm.shp).astype(vm.dtyp)
                for vm in self.ordering.vmap]

    def mapf(self, f):
        def wrapped(array, *args, **kwargs):
            return f(self.rmap(array), *args, **kwargs)
        return wrapped


class DictToVarBijection:
    """Map between the entries ``idx`` of one variable and a Point
    (cf. ``blocking.py:131``)."""

    def __init__(self, var, idx, dpoint):
        self.var = getattr(var, "name", str(var))
        self.idx = idx
        self.dpt = dpoint

    def map(self, dpt):
        return dpt[self.var][self.idx]

    def rmap(self, apt):
        dpt = dict(self.dpt)
        dvar = np.array(dpt[self.var], copy=True)
        dvar[self.idx] = apt
        dpt[self.var] = dvar
        return dpt

    def mapf(self, f):
        def wrapped(apt, *args, **kwargs):
            return f(self.rmap(apt), *args, **kwargs)
        return wrapped


class Compose:
    """``fa(fb(x))``, picklable (cf. ``blocking.py:154``)."""

    def __init__(self, fa, fb):
        self.fa = fa
        self.fb = fb

    def __call__(self, x):
        return self.fa(self.fb(x))
