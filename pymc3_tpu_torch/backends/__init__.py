"""Trace backends (cf. ``pymc3_tpu/backends``): the in-memory ``NDArray``
with ``save_trace``/``load_trace`` (the warmup-state checkpoint included),
``Text`` (csv files), ``SQLite`` and ``HDF5``, ``trace_to_dataframe`` and
``InferenceData``. ``sample(trace=...)`` takes a backend instance, a list
of variable names, or one of the shortcut names ``"text"``, ``"sqlite"``
and ``"hdf5"``. Only numpy, ``csv`` and ``sqlite3`` are needed: h5py,
pandas and ArviZ are imported where they are called.
"""
from .base import BackendError, BaseTrace, MultiTrace, merge_traces
from .ndarray import (
    NDArray, save_trace, load_trace, point_list_to_multitrace,
)
from .text import Text
from .sqlite import SQLite
from .hdf5 import HDF5
from .tracetab import trace_to_dataframe
from .inferencedata import InferenceData, to_inference_data

__all__ = [
    "BackendError", "BaseTrace", "MultiTrace", "merge_traces", "NDArray",
    "Text", "SQLite", "HDF5", "save_trace", "load_trace",
    "point_list_to_multitrace", "trace_to_dataframe", "InferenceData",
    "to_inference_data",
]

_shortcuts = {
    "text": {"backend": Text, "name": "mcmc"},
    "sqlite": {"backend": SQLite, "name": "mcmc.sqlite"},
    "hdf5": {"backend": HDF5, "name": "mcmc.hdf5"},
}
