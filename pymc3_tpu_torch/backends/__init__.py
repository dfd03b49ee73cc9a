"""Trace backends (cf. ``pymc3_tpu/backends``). Ported so far: NDArray."""
from .base import BaseTrace, MultiTrace, merge_traces
from .ndarray import NDArray

__all__ = ["BaseTrace", "MultiTrace", "merge_traces", "NDArray"]
