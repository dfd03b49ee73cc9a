"""MAP and Hessian tools (cf. ``pymc3_tpu/tuning``)."""
from .starting import find_MAP
from .scaling import (
    adjust_precision, adjust_scaling, find_hessian, find_hessian_diag,
    fixed_hessian, guess_scaling, trace_cov,
)

__all__ = ["find_MAP", "find_hessian", "find_hessian_diag", "fixed_hessian",
           "guess_scaling", "adjust_scaling", "adjust_precision",
           "trace_cov"]
