"""Gaussian processes (cf. ``pymc3_tpu/gp/__init__.py``)."""
from . import cov
from . import mean
from . import util
from .gp import Latent, Marginal, TP, MarginalSparse, LatentKron, MarginalKron

__all__ = ["cov", "mean", "util", "Latent", "Marginal", "TP",
           "MarginalSparse", "LatentKron", "MarginalKron"]
