"""Base trace backend classes (cf. ``pymc3_tpu/backends/base.py``).

``BaseTrace`` (``base.py:39``) stores one chain; ``MultiTrace``
(``base.py:238``) is the multi-chain container the user receives from
``pm.sample()``. Var shapes/dtypes come from the model test point; sampler
statistics are first-class (``base.py:91-109``).
"""
from __future__ import annotations

import itertools
import warnings
from abc import ABC
from typing import Dict, List, Optional

import numpy as np

from ..model import modelcontext
from ..util import get_var_name

__all__ = ["BackendError", "BaseTrace", "MultiTrace", "merge_traces"]


class BackendError(Exception):
    pass


class BaseTrace(ABC):
    """Base trace object (cf. ``base.py:39``).

    Parameters
    ----------
    name: str
        Name of backend.
    model: Model
    vars: list of variables (default: ``model.unobserved_RVs``)
    test_point: dict, optional
    """

    supports_sampler_stats = True

    def __init__(self, name, model=None, vars=None, test_point=None):
        self.name = name
        model = modelcontext(model)
        self.model = model
        if vars is None:
            vars = model.unobserved_RVs
        self.vars = vars
        self.varnames = [get_var_name(var) for var in vars]

        # var shapes/dtypes from the test point, evaluated once per model
        # and var list: every chain trace of a model shares them
        key = tuple(self.varnames) if test_point is None else None
        cache = model.__dict__.setdefault("_trace_meta_cache", {})
        hit = cache.get(key) if key is not None else None
        if hit is None:
            fn = model.makefn(vars)
            values = fn(dict(model.test_point if test_point is None
                             else test_point))
            hit = (fn, {name: np.shape(v)
                        for name, v in zip(self.varnames, values)},
                   {name: np.asarray(v).dtype
                    for name, v in zip(self.varnames, values)})
            if key is not None:
                cache[key] = hit
        self._fn, shapes, dtypes = hit
        self.var_shapes = dict(shapes)
        self.var_dtypes = dict(dtypes)
        self.chain = None
        self._is_base_setup = False
        self.sampler_vars = None
        self._warnings = []

    def _add_warnings(self, warnings_):
        self._warnings.extend(warnings_)

    # -- sampling methods ----------------------------------------------------
    def setup(self, draws, chain, sampler_vars=None) -> None:
        """Perform chain-specific setup (cf. ``base.py:112``)."""
        self.chain = chain
        self._set_sampler_vars(sampler_vars)
        self._is_base_setup = True

    def _set_sampler_vars(self, sampler_vars):
        if sampler_vars is not None and not self.supports_sampler_stats:
            raise ValueError("Backend does not support sampler stats.")
        if self._is_base_setup and self.sampler_vars != sampler_vars:
            raise ValueError("Can't change sampler_vars")
        self.sampler_vars = sampler_vars

    def record(self, point, sampler_stats=None):
        raise NotImplementedError

    def close(self):
        pass

    # -- selection methods ---------------------------------------------------
    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._slice(idx)
        try:
            return self.point(int(idx))
        except (ValueError, TypeError):
            return self.get_values(idx)

    def __len__(self):
        raise NotImplementedError

    def get_values(self, varname, burn=0, thin=1):
        raise NotImplementedError

    def get_sampler_stats(self, stat_name, sampler_idx=None, burn=0, thin=1):
        """Get sampler statistics (cf. ``base.py:186``)."""
        if sampler_idx is not None:
            return self._get_sampler_stats(stat_name, sampler_idx, burn, thin)
        sampler_idxs = [i for i, s in enumerate(self.sampler_vars or [])
                        if stat_name in s]
        if not sampler_idxs:
            raise KeyError(f"Unknown sampler stat {stat_name}")
        vals = np.stack([self._get_sampler_stats(stat_name, i, burn, thin)
                         for i in sampler_idxs], axis=-1)
        if vals.shape[-1] == 1:
            return vals[..., 0]
        return vals

    def _get_sampler_stats(self, stat_name, sampler_idx, burn, thin):
        raise NotImplementedError

    def _slice(self, idx):
        raise NotImplementedError

    def point(self, idx) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    @property
    def stat_names(self):
        names = set()
        for vars_ in self.sampler_vars or []:
            names.update(vars_.keys())
        return names


class MultiTrace:
    """Main interface for accessing values from MCMC results
    (cf. ``base.py:238``)."""

    def __init__(self, straces):
        if len({t.chain for t in straces}) != len(straces):
            raise ValueError("Chains are not unique.")
        self._straces = {t.chain: t for t in straces}
        self._report = None

    @property
    def report(self):
        if self._report is None:
            from .report import SamplerReport
            self._report = SamplerReport()
        return self._report

    def __repr__(self):
        template = "<{}: {} chains, {} iterations, {} variables>"
        return template.format(self.__class__.__name__, self.nchains,
                               len(self), len(self.varnames))

    @property
    def nchains(self) -> int:
        return len(self._straces)

    @property
    def chains(self) -> List[int]:
        return list(sorted(self._straces.keys()))

    def __iter__(self):
        return iter(self.points())

    def _lookup(self, key):
        """Classify a user key as model variable or sampler statistic.

        Returns a zero-argument accessor, or None if the key names neither.
        Variables shadow statistics (with an ambiguity warning), matching
        the user-facing contract of the reference API."""
        name = get_var_name(key)
        is_var = name in self.varnames
        is_stat = name in self.stat_names
        if is_var and is_stat:
            warnings.warn(
                "Attribute access on a trace object is ambiguous. "
                "Sampler statistic and model variable share a name. Use "
                "trace.get_values or trace.get_sampler_stats.")
        if is_var:
            return lambda: self.get_values(name)
        if is_stat:
            return lambda: self.get_sampler_stats(name)
        return None

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return self._slice(idx)
        try:
            return self.point(int(idx))
        except (ValueError, TypeError):
            pass
        if isinstance(idx, tuple):
            # ('name', slice(burn, None, thin)) form
            var, vslice = idx
            return self.get_values(var, burn=vslice.start or 0,
                                   thin=vslice.step or 1)
        accessor = self._lookup(idx)
        if accessor is None:
            raise KeyError(f"Unknown variable {get_var_name(idx)}")
        return accessor()

    _attrs = {"_straces", "varnames", "chains", "stat_names", "_report",
              "supports_sampler_stats"}

    def __getattr__(self, name):
        # Avoid infinite recursion when called before __init__
        # variables are set up
        if name in self._attrs:
            raise AttributeError(name)
        accessor = self._lookup(name)
        if accessor is None:
            raise AttributeError(
                f"'{type(self).__name__}' object has no attribute {name!r}")
        return accessor()

    def __len__(self):
        return len(self._straces[self.chains[-1]])

    @property
    def varnames(self):
        return self._straces[self.chains[-1]].varnames

    @property
    def stat_names(self):
        """Union of per-chain sampler-statistic names; all chains must
        share one layout (they come from the same batched kernel).

        Memoized: the report pass queries a stat per chain, and an
        uncached O(chains) union per query is O(chains^2) at thousands of
        chains. ``merge_traces`` invalidates.
        (__dict__ access: MultiTrace.__getattr__ resolves unknown names
        as variable/stat lookups, which would recurse through here.)"""
        cached = self.__dict__.get("_stat_names_cache")
        if cached is not None:
            return cached
        names = set()
        layout = None
        for strace in self._straces.values():
            if layout is None:
                layout = strace.sampler_vars
            elif strace.sampler_vars != layout:
                raise ValueError(
                    "Chains do not share a common sampler-statistic layout")
            names |= strace.stat_names
        self._stat_names_cache = names
        return names

    def add_values(self, vals, overwrite=False) -> None:
        """Attach derived per-draw series to every chain (API parity with
        the reference's ``MultiTrace.add_values``, ``base.py:394``).

        Each value is read in the layout ``get_values(combine=True)``
        produces — the chain-major concatenation of
        ``nchains * len(self)`` rows — and split back into per-chain
        blocks stored on each chain's backend.
        """
        n_draws = len(self)
        for name, series in vals.items():
            exists = name in self.varnames
            if exists and not overwrite:
                raise ValueError(f"Variable name {name} already exists.")
            arr = np.asarray(series)
            expected = n_draws * self.nchains
            n_rows = arr.shape[0] if arr.ndim else 0
            if n_rows != expected:
                warnings.warn(
                    f"add_values: {name!r} has {n_rows} rows but the trace "
                    f"holds {expected} (chains * iterations).")
            table = arr.reshape((self.nchains, n_draws, -1))
            if table.shape[-1] == 1:
                table = table[..., 0]
            for cid, block in zip(self.chains, table):
                strace = self._straces[cid]
                if not hasattr(strace, "samples"):
                    raise BackendError(
                        f"{type(strace).__name__} does not support "
                        "post-hoc add_values")
                strace.samples[name] = block
                if name not in strace.varnames:
                    strace.varnames.append(name)

    def remove_values(self, name) -> None:
        """Drop a variable from every chain (API parity with the
        reference's ``MultiTrace.remove_values``, ``base.py:448``)."""
        if name not in self.varnames:
            raise KeyError(f"Unknown variable {name}")
        for strace in self._straces.values():
            strace.vars = [v for v in strace.vars
                           if get_var_name(v) != name]
            if name in strace.varnames:
                strace.varnames.remove(name)
            if hasattr(strace, "samples"):
                strace.samples.pop(name, None)

    def _chain_list(self, chains):
        """Normalize a chains argument to a list of chain ids."""
        if chains is None:
            return self.chains
        if np.ndim(chains) == 0:
            return [chains]
        return list(chains)

    def get_values(self, varname, burn=0, thin=1, combine=True, chains=None,
                   squeeze=True):
        """Per-chain value arrays for ``varname`` (cf. ``base.py:470``)."""
        name = get_var_name(varname)
        per_chain = [self._straces[c].get_values(name, burn, thin)
                     for c in self._chain_list(chains)]
        return _gather(per_chain, combine, squeeze)

    def get_sampler_stats(self, stat_name, burn=0, thin=1, combine=True,
                          chains=None, squeeze=True):
        """Per-chain sampler-statistic arrays (cf. ``base.py:502``)."""
        if stat_name not in self.stat_names:
            raise KeyError(f"Unknown sampler statistic {stat_name}")
        per_chain = [self._straces[c].get_sampler_stats(stat_name, None,
                                                        burn, thin)
                     for c in self._chain_list(chains)]
        return _gather(per_chain, combine, squeeze)

    def _slice(self, slice_):
        """Return a new MultiTrace object sliced according to ``slice_``."""
        new_traces = [trace._slice(slice_) for trace in self._straces.values()]
        trace = MultiTrace(new_traces)
        idxs = slice_.indices(len(self))
        trace._report = self.report._slice(*idxs)
        return trace

    def point(self, idx, chain=None) -> Dict[str, np.ndarray]:
        """Return a dictionary of point values at ``idx``."""
        if chain is None:
            chain = self.chains[-1]
        return self._straces[chain].point(idx)

    def points(self, chains=None):
        """Return an iterator over all or some chains."""
        if chains is None:
            chains = self.chains
        return itertools.chain.from_iterable(self._straces[chain]
                                             for chain in chains)


def merge_traces(mtraces: List[MultiTrace]) -> MultiTrace:
    """Merge MultiTrace objects into one (cf. ``base.py:562``)."""
    if len(mtraces) == 1:
        return mtraces[0]
    base_mtrace = mtraces[0]
    chain_len = len(base_mtrace)
    max_chain = max(base_mtrace.chains)
    for new_mtrace in mtraces[1:]:
        for new_chain, strace in new_mtrace._straces.items():
            if chain_len != len(new_mtrace):
                raise ValueError("Traces are unequal lengths.")
            max_chain += 1
            strace.chain = max_chain
            base_mtrace._straces[max_chain] = strace
    base_mtrace._stat_names_cache = None
    base_mtrace._report = base_mtrace.report
    return base_mtrace


def _gather(per_chain, combine, squeeze):
    """Assemble per-chain arrays into the user-requested layout: one
    concatenated array (``combine``), the bare array for a lone chain
    (``squeeze``), or the per-chain list itself."""
    arrays = [np.asarray(a) for a in per_chain]
    if combine:
        cat = np.concatenate(arrays)
        return cat if squeeze else [cat]
    if squeeze and len(arrays) == 1:
        return arrays[0]
    return arrays
