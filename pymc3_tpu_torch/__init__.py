"""pymc3_tpu_torch: the PyTorch/CUDA port of pymc3_tpu.

Same public names as the JAX package for the ported slice: the model DSL,
the 30 continuous and 15 discrete distributions, every transform,
``Bound``, ``Mixture``/``NormalMixture``, ``Dirichlet`` and ``MvNormal``, GP
marginal regression, NUTS with pooled or per-chain adaptation,
``HamiltonianMC``, the Metropolis family, ``Slice`` and ``CompoundStep`` with
automatic step assignment, ``sample()``, prior and posterior predictive
draws, traces and diagnostics. Models build on the card unless the caller
asks for the CPU (``set_config(device="cpu")`` or ``Model(device="cpu")``).
Imports torch and numpy only, never jax or pymc3_tpu.
"""
from .config import floatX, intX, get_config, set_config
from . import node
from . import math
from .model import (
    Model, modelcontext, Point, Deterministic, Potential, FreeRV, ObservedRV,
    TransformedRV, ValueGradFunction,
)
from .distributions import *  # noqa: F401,F403
from .distributions import transforms
from . import distributions
from .exceptions import *  # noqa: F401,F403
from . import step_methods
from .step_methods import (
    NUTS, HamiltonianMC, Metropolis, BinaryMetropolis, BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis, DEMetropolis, DEMetropolisZ, Slice,
    CompoundStep,
)
from .step_methods.metropolis import (
    NormalProposal, UniformProposal, CauchyProposal, LaplaceProposal,
    PoissonProposal, MultivariateNormalProposal,
)
from .backends.base import MultiTrace
from .backends.ndarray import NDArray
from .sampling import (
    sample, init_nuts, sample_prior_predictive, sample_posterior_predictive,
    fast_sample_posterior_predictive, sample_posterior_predictive_w,
    stop_tuning, assign_step_methods, instantiate_steppers,
)
from .stats import ess, rhat, mcse, summary
from . import gp
