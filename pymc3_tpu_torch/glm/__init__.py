"""Generalized linear models (cf. ``pymc3_tpu/glm/__init__.py``)."""
from . import families
from .linear import GLM, LinearComponent

__all__ = ["GLM", "LinearComponent", "families"]
