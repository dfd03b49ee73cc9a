"""pymc3_tpu_torch: the PyTorch/CUDA port of pymc3_tpu.

Same public names as the JAX package for the ported slice: the model DSL
with ``Data``, ``Minibatch`` and ``total_size``, the 30 continuous and 15
discrete distributions, the multivariate and time-series families, every transform, ``Bound``,
``Mixture``/``NormalMixture``, ``Simulator``, the Gaussian processes
(marginal, latent, Student-T, sparse and Kronecker), sequential Monte Carlo
(``sample_smc``, SMC-ABC), NUTS and
``HamiltonianMC`` with diagonal or dense, adaptive (pooled or per chain) or
fixed mass matrices, the Metropolis family, ``Slice``, ``EllipticalSlice``,
``ElemwiseCategorical`` and ``CompoundStep`` with automatic step
assignment, ``sample()`` and ``iter_sample()``, prior and posterior
predictive draws, traces, diagnostics on the host and on the card, model
comparison (``loo``, ``waic``, ``compare``), ODEs (``ode``), GLMs
(``GLM``, ``LinearComponent``), variational inference (``fit``,
ADVI, full-rank ADVI, SVGD, ASVGD, normalizing flows), ``SGLD``, and the MAP
and Hessian tools of ``tuning``. Models build on the card unless the caller
asks for the CPU (``set_config(device="cpu")`` or ``Model(device="cpu")``).
Imports torch, numpy and scipy only, never jax or pymc3_tpu.
"""
from .config import floatX, intX, get_config, set_config
from . import node
from . import math
from .math import (
    logsumexp, logaddexp, logit, invlogit, expand_packed_triangular,
    probit, invprobit,
)
from .model import (
    Model, modelcontext, Point, Deterministic, Potential, FreeRV, ObservedRV,
    TransformedRV, ValueGradFunction, set_data,
)
from .data import Data, Minibatch, get_data, GeneratorAdapter, align_minibatches
from .torchf import (
    gradient, hessian, hessian_diag, jacobian, inputvars, cont_inputs,
)
from .distributions import *  # noqa: F401,F403
from .distributions import transforms
from . import distributions
from .exceptions import *  # noqa: F401,F403
from . import step_methods
from .step_methods import (
    NUTS, HamiltonianMC, Metropolis, BinaryMetropolis, BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis, DEMetropolis, DEMetropolisZ, Slice,
    EllipticalSlice, ElemwiseCategorical, CompoundStep,
)
from .step_methods.sgmcmc import SGLD
from .step_methods.metropolis import (
    NormalProposal, UniformProposal, CauchyProposal, LaplaceProposal,
    PoissonProposal, MultivariateNormalProposal,
)
from .backends.base import MultiTrace
from .backends.ndarray import NDArray
from .sampling import (
    sample, iter_sample, init_nuts, sample_prior_predictive, sample_posterior_predictive,
    fast_sample_posterior_predictive, sample_posterior_predictive_w,
    stop_tuning, assign_step_methods, instantiate_steppers,
)
from . import stats
from .stats import (
    bfmi, compare, ess, geweke, hpd, loo, mcse, r2_score, rhat, summary,
    waic, rhat_device, ess_device, effective_n, gelman_rubin,
)
from . import gp
from . import smc
from .smc import sample_smc
from . import tuning
from .tuning import find_MAP, find_hessian, guess_scaling, trace_cov
from . import variational
from .variational import (
    ADVI, ASVGD, NFVI, SVGD, FullRankADVI, Empirical, FullRank, MeanField,
    NormalizingFlow, KLqp, fit, sample_approx, Inference, ImplicitGradient,
    Approximation, Group,
)
from .variational.stein import Stein
from .variational.updates import (
    sgd, momentum, nesterov_momentum, adagrad, adagrad_window, rmsprop,
    adadelta, adam, adamax, norm_constraint, total_norm_constraint,
    apply_momentum, apply_nesterov_momentum,
)
from . import ode
from . import glm
from .glm import GLM, LinearComponent
