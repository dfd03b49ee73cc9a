"""Variational inference (cf. ``pymc3_tpu/variational/__init__.py``)."""
from .approximations import (
    Empirical, FullRank, MeanField, NormalizingFlow, sample_approx,
)
from .inference import (
    ADVI, ASVGD, NFVI, SVGD, FullRankADVI, ImplicitGradient, Inference,
    KLqp, fit,
)
from .opvi import Approximation, Group, Operator, ObjectiveFunction, TestFunction
from .operators import KL, KSD
from . import updates
from . import callbacks
from . import flows
from .flows import Formula
from .test_functions import Kernel, RBF
from .stein import Stein

__all__ = [
    "ADVI", "ASVGD", "NFVI", "SVGD", "FullRankADVI", "Inference", "KLqp",
    "ImplicitGradient", "fit", "Empirical", "FullRank", "MeanField",
    "NormalizingFlow", "sample_approx", "Approximation", "Group",
    "Operator", "KL", "KSD", "Formula",
]
