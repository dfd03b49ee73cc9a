"""HDF5 trace backend (cf. ``pymc3_tpu/backends/hdf5.py``): one file for
all chains, with the sampler statistics. ``h5py`` is imported when a trace
is made or loaded, not with the package.
"""
from __future__ import annotations

import contextlib
from typing import Dict

import numpy as np

from ..model import modelcontext
from .base import BaseTrace, MultiTrace

__all__ = ["HDF5", "load"]


def _h5py():
    try:
        import h5py
    except ImportError as e:
        raise ImportError("h5py is required for the HDF5 backend") from e
    return h5py


class HDF5(BaseTrace):
    """HDF5 trace object (cf. ``hdf5.py:32``)."""

    supports_sampler_stats = True

    def __init__(self, name=None, model=None, vars=None, test_point=None):
        _h5py()
        if name is None:
            name = "mcmc.hdf5"
        super().__init__(name, model, vars, test_point)
        self.hdf5_file = None
        self.draw_idx = 0
        self.draws = None
        self._sampler_vars_setup = None

    # -- h5 plumbing ---------------------------------------------------------
    @contextlib.contextmanager
    def activate_file(self):
        if self.hdf5_file is not None:
            yield self.hdf5_file
            return
        self.hdf5_file = _h5py().File(self.name, "a")
        try:
            yield self.hdf5_file
        finally:
            self.hdf5_file.close()
            self.hdf5_file = None

    @property
    def is_new_file(self):
        with self.activate_file() as f:
            return "varnames" not in f.attrs

    def _chain_group(self, f):
        return f.require_group(str(self.chain))

    def setup(self, draws, chain, sampler_vars=None):
        super().setup(draws, chain, sampler_vars)
        self.chain = chain
        with self.activate_file() as f:
            if "varnames" not in f.attrs:
                f.attrs["varnames"] = np.array(
                    [v.encode() for v in self.varnames])
            g = self._chain_group(f)
            samples = g.require_group("samples")
            old = 0
            for varname, shape in self.var_shapes.items():
                if varname in samples:
                    old = samples[varname].shape[0]
                    samples[varname].resize((old + draws,) + shape)
                else:
                    samples.create_dataset(
                        varname, (draws,) + shape,
                        dtype=self.var_dtypes[varname],
                        maxshape=(None,) + shape)
            self.draw_idx = old
            self.draws = self.draw_idx + draws
            if sampler_vars is not None:
                stats = g.require_group("stats")
                for i, sampler in enumerate(sampler_vars):
                    sg = stats.require_group(str(i))
                    for statname, dtype in sampler.items():
                        if statname in sg:
                            sg[statname].resize((self.draws,))
                        else:
                            sg.create_dataset(statname, (self.draws,),
                                              dtype=np.dtype(dtype)
                                              if dtype is not bool else "bool",
                                              maxshape=(None,))

    def record(self, point, sampler_stats=None):
        with self.activate_file() as f:
            g = self._chain_group(f)
            samples = g["samples"]
            for varname, value in zip(self.varnames, self._fn(point)):
                samples[varname][self.draw_idx] = value
            if sampler_stats is not None:
                stats = g["stats"]
                for i, sampler in enumerate(sampler_stats):
                    sg = stats[str(i)]
                    for key, val in sampler.items():
                        sg[key][self.draw_idx] = val
            self.draw_idx += 1

    def record_batch(self, var_values, n, stats_batch=None):
        with self.activate_file() as f:
            g = self._chain_group(f)
            samples = g["samples"]
            end = self.draw_idx + n
            for varname in self.varnames:
                samples[varname][self.draw_idx:end] = var_values[varname]
            if stats_batch is not None and "stats" in g:
                stats = g["stats"]
                for i, sampler in enumerate(stats_batch):
                    sg = stats[str(i)]
                    for key, val in sampler.items():
                        sg[key][self.draw_idx:end] = val
            self.draw_idx = end

    def close(self):
        with self.activate_file() as f:
            g = self._chain_group(f)
            if self.draws is not None and self.draw_idx < self.draws:
                samples = g["samples"]
                for varname in self.varnames:
                    ds = samples[varname]
                    ds.resize((self.draw_idx,) + ds.shape[1:])

    # -- selection -----------------------------------------------------------
    def __len__(self):
        if self.chain is None:
            return 0
        with self.activate_file() as f:
            if str(self.chain) not in f:
                return 0
            g = self._chain_group(f)
            if not self.varnames:
                return 0
            return min(self.draw_idx,
                       g["samples"][self.varnames[0]].shape[0]) \
                if self.draw_idx else g["samples"][self.varnames[0]].shape[0]

    def get_values(self, varname, burn=0, thin=1):
        with self.activate_file() as f:
            g = self._chain_group(f)
            return np.asarray(g["samples"][varname][burn::thin])

    def _get_sampler_stats(self, varname, sampler_idx, burn, thin):
        with self.activate_file() as f:
            g = self._chain_group(f)
            return np.asarray(g["stats"][str(sampler_idx)][varname][burn::thin])

    def _slice(self, idx):
        from .ndarray import NDArray
        nd = NDArray(model=self.model, vars=self.vars)
        nd.chain = self.chain
        nd.samples = {v: self.get_values(v) for v in self.varnames}
        nd.draw_idx = len(self)
        nd.sampler_vars = self.sampler_vars
        if self.sampler_vars:
            nd._stats = []
            for i, sampler in enumerate(self.sampler_vars):
                nd._stats.append({k: self._get_sampler_stats(k, i, 0, 1)
                                  for k in sampler})
        return nd._slice(idx)

    def point(self, idx) -> Dict[str, np.ndarray]:
        idx = int(idx)
        with self.activate_file() as f:
            g = self._chain_group(f)
            return {v: np.asarray(g["samples"][v][idx])
                    for v in self.varnames}


def load(name, model=None) -> MultiTrace:
    """Load HDF5 file (cf. ``hdf5.py:226``)."""
    h5py = _h5py()
    model = modelcontext(model)
    with h5py.File(name, "r") as f:
        chains = [int(k) for k in f.keys() if k.isdigit()]
    straces = []
    for chain in chains:
        strace = HDF5(name, model=model)
        strace.chain = chain
        with strace.activate_file() as f:
            g = f[str(chain)]
            n = g["samples"][strace.varnames[0]].shape[0]
            strace.draw_idx = n
            strace.draws = n
            if "stats" in g:
                sampler_vars = []
                for i in sorted(g["stats"].keys(), key=int):
                    sg = g["stats"][i]
                    sampler_vars.append(
                        {k: sg[k].dtype for k in sg.keys()})
                strace.sampler_vars = sampler_vars
        straces.append(strace)
    return MultiTrace(straces)
