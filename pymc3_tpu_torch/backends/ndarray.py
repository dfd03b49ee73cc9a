"""In-memory (numpy) trace (cf. ``pymc3_tpu/backends/ndarray.py``)."""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .base import BaseTrace

__all__ = ["NDArray"]


class NDArray(BaseTrace):
    """NDArray trace object (cf. ``ndarray.py:183``)."""

    supports_sampler_stats = True

    def __init__(self, name=None, model=None, vars=None, test_point=None):
        super().__init__(name, model, vars, test_point)
        self.draw_idx = 0
        self.draws = None
        self.samples = {}
        self._stats = None

    def setup(self, draws, chain, sampler_vars=None) -> None:
        """Allocate ``draws`` rows for every variable and statistic."""
        super().setup(draws, chain, sampler_vars)
        self.draws = draws
        self.samples = {name: np.zeros((draws,) + shape,
                                       dtype=self.var_dtypes[name])
                        for name, shape in self.var_shapes.items()}
        if sampler_vars is not None:
            self._stats = [{k: np.zeros(draws, dtype=dt)
                            for k, dt in sampler.items()}
                           for sampler in sampler_vars]

    def record(self, point, sampler_stats=None) -> None:
        """Record one draw at ``point`` (cf. ``ndarray.py:77``)."""
        for varname, value in zip(self.varnames, self._fn(point)):
            self.samples[varname][self.draw_idx] = value
        if (self._stats is None) != (sampler_stats is None):
            raise ValueError("Expected sampler_stats" if sampler_stats is None
                             else "Unknown sampler_stats")
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
        self.samples = {var: vtrace[:self.draw_idx]
                        for var, vtrace in self.samples.items()}
        if self._stats is not None:
            self._stats = [{var: trace[:self.draw_idx]
                            for var, trace in stats.items()}
                           for stats in self._stats]

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
        if self._stats is not None:
            sliced._stats = [{k: v[start:stop:step] for k, v in s.items()}
                             for s in self._stats]
        return sliced

    def point(self, idx) -> Dict[str, np.ndarray]:
        idx = int(idx)
        return {varname: values[idx]
                for varname, values in self.samples.items()}
