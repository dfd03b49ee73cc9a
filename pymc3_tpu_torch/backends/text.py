"""Text file trace backend (cf. ``pymc3_tpu/backends/text.py``).

One CSV file per chain, ``chain-<n>.csv``, one row per draw, one column per
element of each variable under the flat names of ``tracetab.py``
(``x``, ``x__0``, ``x__0_1``, ...). Read and written with the ``csv``
module; the JAX package reads and writes the same files with pandas, so a
directory written by either package loads in the other. Values are
written by ``str``, the shortest text that reads back to the same float, so
a float32 or float64 trace reads back exactly.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Dict

import numpy as np

from ..model import modelcontext
from .base import BaseTrace, MultiTrace
from .ndarray import NDArray

__all__ = ["Text", "load", "dump", "ndarray_from_text"]


def _create_flat_names(varname, shape):
    """cf. ``tracetab.py:52``: ``x -> x``, ``x (2,) -> x__0, x__1``."""
    if not shape:
        return [varname]
    labels = (np.ravel(xs).tolist() for xs in np.indices(shape))
    labels = (map(str, xs) for xs in labels)
    return [f"{varname}__{'_'.join(idxs)}" for idxs in zip(*labels)]


def _read_columns(filename):
    """``{column: list of strings}`` of one chain's file."""
    with open(filename, newline="") as fh:
        reader = csv.reader(fh)
        header = next(reader)
        rows = list(reader)
    return {name: [row[j] for row in rows] for j, name in enumerate(header)}


def _parse(strings, dtype):
    dtype = np.dtype(dtype)
    if dtype.kind == "b":
        return np.array([s.strip() in ("True", "1", "1.0") for s in strings])
    if dtype.kind in "iu":
        return np.array([float(s) for s in strings]).astype(dtype)
    return np.array([float(s) for s in strings], dtype=dtype)


class Text(BaseTrace):
    """Text trace object (cf. ``text.py:43``). Records the draws only: a
    sampler's statistics are dropped (``supports_sampler_stats``)."""

    supports_sampler_stats = False

    def __init__(self, name, model=None, vars=None, test_point=None):
        if not os.path.exists(name):
            os.mkdir(name)
        super().__init__(name, model, vars, test_point)
        self.flat_names = {v: _create_flat_names(v, shape)
                           for v, shape in self.var_shapes.items()}
        self.filename = None
        self._fh = None
        self._writer = None
        self._columns = None

    def setup(self, draws, chain, sampler_vars=None):
        if sampler_vars is not None:
            raise ValueError("Text backend does not support sampler stats.")
        super().setup(draws, chain, sampler_vars=None)
        self.filename = os.path.join(self.name, f"chain-{chain}.csv")
        cnames = [fv for v in self.varnames for fv in self.flat_names[v]]
        if os.path.exists(self.filename):
            with open(self.filename, newline="") as fh:
                prev_cnames = next(csv.reader(fh))
            if prev_cnames != cnames:
                raise ValueError("Previous file has different variables")
            self._fh = open(self.filename, "a", newline="")
            self._writer = csv.writer(self._fh, lineterminator="\n")
        else:
            self._fh = open(self.filename, "w", newline="")
            self._writer = csv.writer(self._fh, lineterminator="\n")
            self._writer.writerow(cnames)
        self._columns = None

    def record(self, point, sampler_stats=None):
        if sampler_stats is not None:
            raise ValueError("Text backend does not support sampler stats.")
        values = dict(zip(self.varnames, self._fn(point)))
        self._writer.writerow([str(v) for var in self.varnames
                               for v in np.ravel(np.asarray(values[var]))])
        self._columns = None

    def record_batch(self, var_values, n, stats_batch=None):
        flat = [np.asarray(var_values[var]).reshape(n, -1)
                for var in self.varnames]
        self._writer.writerows([[str(v) for a in flat for v in a[i]]
                                for i in range(n)])
        self._columns = None

    def close(self):
        if self._fh is not None:
            self._fh.close()
            self._fh = None
            self._writer = None

    # -- selection -----------------------------------------------------------
    def _load(self):
        if self._columns is None:
            self._columns = _read_columns(self.filename)
        return self._columns

    def __len__(self):
        if self.filename is None or not os.path.exists(self.filename):
            return 0
        columns = self._load()
        return len(next(iter(columns.values()))) if columns else 0

    def get_values(self, varname, burn=0, thin=1):
        columns = self._load()
        names = self.flat_names[varname]
        dtype = self.var_dtypes[varname]
        n = len(columns[names[0]])
        vals = np.stack([_parse(columns[c], dtype) for c in names], axis=1) \
            if names else np.empty((n, 0), dtype)
        return vals.reshape((n,) + tuple(self.var_shapes[varname]))[
            burn::thin]

    def _slice(self, idx):
        if idx.stop is not None:
            raise ValueError("Stop value in slice not supported.")
        return ndarray_from_text(self)._slice(idx)

    def point(self, idx) -> Dict[str, np.ndarray]:
        idx = int(idx)
        return {v: self.get_values(v)[idx] for v in self.varnames}


def ndarray_from_text(strace: Text) -> NDArray:
    """The chain of a Text trace as an in-memory NDArray."""
    nd = NDArray(model=strace.model, vars=strace.vars)
    nd.chain = strace.chain
    nd.samples = {v: strace.get_values(v) for v in strace.varnames}
    nd.draw_idx = len(strace)
    return nd


def load(name, model=None) -> MultiTrace:
    """Load a Text trace directory (cf. ``text.py:174``)."""
    files = glob.glob(os.path.join(name, "chain-*.csv"))
    if len(files) == 0:
        raise ValueError(f"No files present in directory {name}")
    model = modelcontext(model)
    straces = []
    for f in files:
        chain = int(os.path.splitext(os.path.basename(f))[0].replace(
            "chain-", ""))
        strace = Text(name, model=model)
        strace.chain = chain
        strace.filename = f
        straces.append(strace)
    return MultiTrace(straces)


def dump(name, trace, chains=None):
    """Write the chains of an NDArray trace as CSV files (cf.
    ``text.py:204``)."""
    if not os.path.exists(name):
        os.mkdir(name)
    if chains is None:
        chains = trace.chains
    for chain in chains:
        filename = os.path.join(name, f"chain-{chain}.csv")
        strace = trace._straces[chain]
        header, columns = [], []
        for varname in strace.varnames:
            vals = np.asarray(strace.get_values(varname))
            header += _create_flat_names(varname, strace.var_shapes.get(
                varname, vals.shape[1:]))
            columns.append(vals.reshape(len(vals), -1))
        rows = [[str(v) for a in columns for v in a[i]]
                for i in range(len(strace))]
        with open(filename, "w", newline="") as fh:
            writer = csv.writer(fh, lineterminator="\n")
            writer.writerow(header)
            writer.writerows(rows)
