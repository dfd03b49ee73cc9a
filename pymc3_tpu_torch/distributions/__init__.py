"""Distributions library (cf. ``pymc3_tpu/distributions/__init__.py``)."""
from . import transforms
from .distribution import Distribution, Continuous
from .continuous import Normal, HalfNormal, HalfCauchy, Gamma
from .multivariate import MvNormal

__all__ = ["Normal", "HalfNormal", "HalfCauchy", "Gamma", "MvNormal",
           "Distribution", "Continuous", "transforms"]
