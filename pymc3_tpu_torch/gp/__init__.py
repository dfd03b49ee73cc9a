"""Gaussian processes (cf. ``pymc3_tpu/gp/__init__.py``)."""
from . import cov
from . import mean
from . import util
from .gp import Marginal

__all__ = ["cov", "mean", "util", "Marginal"]
