"""In-memory (numpy) trace and its files on disk (cf.
``pymc3_tpu/backends/ndarray.py``).

``save_trace``/``load_trace`` keep each chain as npz files and json
metadata in the JAX package's layout, with the chain's warmup-state
checkpoint (``warmup_state.npz``), so that ``sample(resume_from=...)`` can
continue a saved run without tuning again.
"""
from __future__ import annotations

import glob
import json
import os
import shutil
from typing import Dict, List, Optional

import numpy as np

from ..model import modelcontext
from .base import BaseTrace, MultiTrace

__all__ = ["NDArray", "save_trace", "load_trace",
           "point_list_to_multitrace"]


class NDArray(BaseTrace):
    """NDArray trace object (cf. ``ndarray.py:183``)."""

    supports_sampler_stats = True

    def __init__(self, name=None, model=None, vars=None, test_point=None):
        super().__init__(name, model, vars, test_point)
        self.draw_idx = 0
        self.draws = None
        self.samples = {}
        self._stats = None

    # -- sampling methods ----------------------------------------------------
    def setup(self, draws, chain, sampler_vars=None) -> None:
        """Perform chain-specific setup (cf. ``ndarray.py:209``)."""
        super().setup(draws, chain, sampler_vars)
        self.chain = chain
        if self.samples:  # continue a trace: concatenate
            old_draws = len(self)
            self.draws = old_draws + draws
            self.draw_idx = old_draws
            for varname, shape in self.var_shapes.items():
                old_var_samples = self.samples[varname]
                new_var_samples = np.zeros((draws,) + shape,
                                           self.var_dtypes[varname])
                self.samples[varname] = np.concatenate(
                    (old_var_samples, new_var_samples), axis=0)
        else:
            self.draws = draws
            for varname, shape in self.var_shapes.items():
                self.samples[varname] = np.zeros((draws,) + shape,
                                                 dtype=self.var_dtypes[varname])
        if sampler_vars is None:
            return
        if self._stats is None:
            self._stats = []
            for sampler in sampler_vars:
                data = {}
                self._stats.append(data)
                for varname, dtype in sampler.items():
                    data[varname] = np.zeros(draws, dtype=dtype)
        else:
            for data, vars_ in zip(self._stats, sampler_vars):
                if vars_.keys() != data.keys():
                    raise ValueError("Sampler vars can't change")
                old_draws = len(self)
                for varname, dtype in vars_.items():
                    old = data[varname]
                    new = np.zeros(draws, dtype=dtype)
                    data[varname] = np.concatenate([old, new])

    def record(self, point, sampler_stats=None) -> None:
        """Record results of a sampling iteration (cf. ``ndarray.py:248``)."""
        for varname, value in zip(self.varnames, self._fn(point)):
            self.samples[varname][self.draw_idx] = value
        if self._stats is not None and sampler_stats is None:
            raise ValueError("Expected sampler_stats")
        if self._stats is None and sampler_stats is not None:
            raise ValueError("Unknown sampler_stats")
        if sampler_stats is not None:
            for data, vars_ in zip(self._stats, sampler_stats):
                for key, val in vars_.items():
                    data[key][self.draw_idx] = val
        self.draw_idx += 1

    def record_batch(self, var_values: Dict[str, np.ndarray], n: int,
                     stats_batch: Optional[List[Dict[str, np.ndarray]]] = None):
        """Record ``n`` draws at once from the sampler's host blocks."""
        end = self.draw_idx + n
        for varname in self.varnames:
            self.samples[varname][self.draw_idx:end] = var_values[varname]
        if stats_batch is not None and self._stats is not None:
            for data, vars_ in zip(self._stats, stats_batch):
                for key, val in vars_.items():
                    data[key][self.draw_idx:end] = val
        self.draw_idx = end

    def close(self):
        if self.draw_idx == self.draws:
            return
        # Remove trailing zeros if interrupted before completed all draws
        self.samples = {var: vtrace[:self.draw_idx]
                        for var, vtrace in self.samples.items()}
        if self._stats is not None:
            self._stats = [{var: trace[:self.draw_idx]
                            for var, trace in stats.items()}
                           for stats in self._stats]

    # -- selection methods ---------------------------------------------------
    def __len__(self):
        if not self.samples:
            return 0
        return self.draw_idx

    def get_values(self, varname, burn=0, thin=1) -> np.ndarray:
        return self.samples[varname][burn::thin]

    def _get_sampler_stats(self, varname, sampler_idx, burn, thin):
        return self._stats[sampler_idx][varname][burn::thin]

    def _slice(self, idx):
        start, stop, step = idx.indices(len(self))
        sliced = NDArray(model=self.model, vars=self.vars)
        sliced.chain = self.chain
        sliced.samples = {varname: values[start:stop:step]
                          for varname, values in self.samples.items()}
        sliced.sampler_vars = self.sampler_vars
        sliced.draw_idx = len(range(start, stop, step))
        if self._stats is None:
            return sliced
        sliced._stats = []
        for vars_ in self._stats:
            var_sliced = {}
            sliced._stats.append(var_sliced)
            for key, vals in vars_.items():
                var_sliced[key] = vals[start:stop:step]
        return sliced

    def point(self, idx) -> Dict[str, np.ndarray]:
        idx = int(idx)
        return {varname: values[idx]
                for varname, values in self.samples.items()}


def save_trace(trace: MultiTrace, directory: Optional[str] = None,
               overwrite=False) -> str:
    """Save a MultiTrace to ``directory`` (cf. ``ndarray.py:168``).

    Layout, the JAX package's: one subdirectory ``chain-<n>`` per chain with
    ``samples.npz``, ``stats.npz`` and ``metadata.json``, and the chain's
    warmup-state checkpoint (step size, mass matrix, adaptation state) as
    ``warmup_state.npz`` where the trace carries one. A directory written
    by either package loads in the other, for values and statistics.
    """
    if directory is None:
        directory = ".pymc3_tpu.trace"
    if os.path.isdir(directory):
        if overwrite:
            shutil.rmtree(directory)
        else:
            raise OSError(
                "Cautiously refusing to overwrite the already existing "
                f"{directory}! Please supply a different directory, or set "
                "`overwrite=True`")
    os.makedirs(directory)

    for chain, strace in trace._straces.items():
        dirname = os.path.join(directory, f"chain-{chain}")
        os.makedirs(dirname)
        np.savez(os.path.join(dirname, "samples.npz"),
                            **strace.samples)
        meta = {
            "chain": int(chain),
            "draw_idx": int(strace.draw_idx),
            "varnames": list(strace.varnames),
            "sampler_vars": [
                {k: np.dtype(v).name for k, v in s.items()}
                for s in (strace.sampler_vars or [])
            ],
        }
        with open(os.path.join(dirname, "metadata.json"), "w") as f:
            json.dump(meta, f)
        if strace._stats is not None:
            flat = {}
            for i, stats in enumerate(strace._stats):
                for k, v in stats.items():
                    flat[f"{i}__{k}"] = v
            np.savez(os.path.join(dirname, "stats.npz"), **flat)
        warm = getattr(strace, "warmup_state", None)
        if warm is not None:
            np.savez(os.path.join(dirname, "warmup_state.npz"),
                                **warm)
    return directory


def load_trace(directory: str, model=None) -> MultiTrace:
    """Load a MultiTrace saved by :func:`save_trace` (cf.
    ``ndarray.py:217``)."""
    straces = []
    model = modelcontext(model)
    for chain_dir in sorted(glob.glob(os.path.join(directory, "chain-*"))):
        with open(os.path.join(chain_dir, "metadata.json")) as f:
            meta = json.load(f)
        strace = NDArray(model=model)
        strace.chain = meta["chain"]
        data = np.load(os.path.join(chain_dir, "samples.npz"))
        strace.samples = {k: data[k] for k in data.files}
        strace.varnames = meta["varnames"]
        strace.draw_idx = meta["draw_idx"]
        strace.draws = meta["draw_idx"]
        if meta["sampler_vars"]:
            strace.sampler_vars = [
                {k: np.dtype(v) for k, v in s.items()}
                for s in meta["sampler_vars"]]
            stats_path = os.path.join(chain_dir, "stats.npz")
            if os.path.exists(stats_path):
                sdata = np.load(stats_path)
                strace._stats = [dict() for _ in meta["sampler_vars"]]
                for key in sdata.files:
                    i, k = key.split("__", 1)
                    strace._stats[int(i)][k] = sdata[key]
        warm_path = os.path.join(chain_dir, "warmup_state.npz")
        if os.path.exists(warm_path):
            wdata = np.load(warm_path)
            strace.warmup_state = {k: wdata[k] for k in wdata.files}
        straces.append(strace)
    if not straces:
        raise ValueError(f"No chains found in {directory}")
    return MultiTrace(straces)


def point_list_to_multitrace(point_list: List[Dict[str, np.ndarray]],
                             model=None) -> MultiTrace:
    """Transform a list of Points into a MultiTrace
    (cf. ``ndarray.py:252``)."""
    _model = modelcontext(model)
    varnames = list(point_list[0].keys())
    with _model:
        chain = NDArray(model=_model, vars=[_model[vn] for vn in varnames])
        chain.setup(draws=len(point_list), chain=0)
        # the values are given: no function of the point is needed
        chain._fn = lambda point: [point[vn] for vn in varnames]
        chain.varnames = varnames
        for point in point_list:
            chain.record(point)
    return MultiTrace([chain])
