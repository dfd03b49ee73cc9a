"""MCMC step methods (cf. ``pymc3_tpu/step_methods``).

Every stepper is built around a kernel over a batch of chains,

    ``kernel_step(q, state, tctx, noise) -> (q_new, state_new, stats)``

where ``q: (chains, n)`` is the full flat unconstrained vector of every
chain, ``state`` a NamedTuple of tensors, ``tctx`` the tuning flag and draw
index, and ``noise`` the source of the transition's random numbers.
"""
from .arraystep import (
    ArrayStep, ArrayStepShared, BlockedStep, Competence, GeneratorNoise,
    TuneContext, metrop_select,
)
from .compound import CompoundStep
from .hmc import NUTS, HamiltonianMC, QuadPotentialDiagAdapt
from .metropolis import (
    Metropolis,
    BinaryMetropolis,
    BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis,
    DEMetropolis,
    DEMetropolisZ,
    NormalProposal,
    UniformProposal,
    CauchyProposal,
    LaplaceProposal,
    PoissonProposal,
    MultivariateNormalProposal,
)
from .slicer import Slice
from .elliptical_slice import EllipticalSlice
from .gibbs import ElemwiseCategorical

__all__ = [
    "NUTS", "HamiltonianMC", "Metropolis", "BinaryMetropolis",
    "BinaryGibbsMetropolis", "CategoricalGibbsMetropolis", "DEMetropolis",
    "DEMetropolisZ", "Slice", "EllipticalSlice", "ElemwiseCategorical",
    "CompoundStep", "Competence", "TuneContext",
    "GeneratorNoise", "QuadPotentialDiagAdapt", "NormalProposal",
    "UniformProposal", "CauchyProposal", "LaplaceProposal", "PoissonProposal",
    "MultivariateNormalProposal", "ArrayStep", "ArrayStepShared",
    "BlockedStep", "metrop_select", "STEP_METHODS",
]

STEP_METHODS = (
    NUTS,
    HamiltonianMC,
    Metropolis,
    BinaryMetropolis,
    BinaryGibbsMetropolis,
    Slice,
    CategoricalGibbsMetropolis,
)
