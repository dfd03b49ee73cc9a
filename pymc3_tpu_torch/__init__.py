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
predictive draws, traces (in memory, saved and loaded with their warmup
state, text, SQLite, HDF5, InferenceData) with ``sample(resume_from=...)``,
missing-value imputation, diagnostics on the host and on the card, model
comparison (``loo``, ``waic``, ``compare``), ODEs (``ode``), GLMs
(``GLM``, ``LinearComponent``), variational inference (``fit``,
ADVI, full-rank ADVI, SVGD, ASVGD, normalizing flows), ``SGLD``, and the MAP
and Hessian tools of ``tuning``, and chains, SMC particles and ADVI
minibatches sharded over the ranks of a process group (``parallel``,
``sample(devices=...)``); and the plots (their numbers computed on the
device, drawn by matplotlib on the host) and ``model_to_graphviz``.
Models build on the card unless the caller
asks for the CPU (``set_config(device="cpu")`` or ``Model(device="cpu")``).
Imports torch, numpy and scipy only, never jax or pymc3_tpu; matplotlib
and graphviz when a plot or a graph is drawn.
"""
import logging

_log = logging.getLogger("pymc3_tpu_torch")
#: The package logger's handler; attached only where logging has no root
#: handler yet, as the JAX package does.
handler = logging.StreamHandler()
if not logging.root.handlers and not _log.handlers:
    _log.setLevel(logging.INFO)
    _log.addHandler(handler)

from .config import floatX, intX, get_config, set_config
from . import node
from . import math
from .math import (
    logsumexp, logaddexp, logit, invlogit, expand_packed_triangular,
    probit, invprobit,
)
from .model import (
    Model, modelcontext, Point, Deterministic, Potential, FreeRV, ObservedRV,
    MultiObservedRV, TransformedRV, ValueGradFunction, set_data, Factor, fn,
    fastfn, compilef,
)
from .blocking import (
    ArrayOrdering, DictToArrayBijection, DictToVarBijection,
)
from .data import Data, Minibatch, get_data, GeneratorAdapter, align_minibatches
from . import torchf
from .torchf import (
    gradient, hessian, hessian_diag, jacobian, inputvars, cont_inputs,
    smartfloatX, CallableTensor, join_nonshared_inputs,
    make_shared_replacements, generator, tt_rng, set_tt_rng, take_along_axis,
)
from .distributions import *  # noqa: F401,F403
from .distributions import transforms
from . import distributions
from .exceptions import *  # noqa: F401,F403
from .memoize import memoize, clear_cache
from .vartypes import *  # noqa: F401,F403
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
from . import backends
from .backends.base import MultiTrace, merge_traces
from .backends.ndarray import (
    NDArray, save_trace, load_trace, point_list_to_multitrace,
)
from .backends.tracetab import trace_to_dataframe
from .backends.inferencedata import InferenceData, to_inference_data
from .backends.report import SamplerReport, SamplerWarning, WarningType
from .sampling import (
    sample, iter_sample, init_nuts, sample_prior_predictive, sample_posterior_predictive,
    fast_sample_posterior_predictive, sample_posterior_predictive_w,
    stop_tuning, assign_step_methods, instantiate_steppers,
)
from . import stats
from .stats import (
    bfmi, compare, ess, geweke, hpd, loo, mcse, r2_score, rhat, summary,
    waic, rhat_device, ess_device, effective_n, gelman_rubin, map_args,
)
from . import gp
from . import smc
from .smc import sample_smc, SMC
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
from .ode import DifferentialEquation
from . import glm
from .glm import GLM, LinearComponent
from . import parallel
from . import plots
from .plots import (
    traceplot, plot_posterior, forestplot, energyplot, autocorrplot,
    densityplot, kdeplot, pairplot, compareplot,
    plot_posterior_predictive_glm,
)
from .model_graph import model_to_graphviz

# the reference leaks ``theano.tensor.constant`` into pm.* (as
# ``theano_constant``); here a constant is a wrapped array node
from .node import as_node as theano_constant  # noqa: E402


def test(*args):
    """Run the port's tests (``tests/test_torch_*.py`` beside the package;
    cf. ``pymc3/__init__.py:50``); ``args`` go on to pytest."""
    import glob
    import os
    import pytest

    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return pytest.main(sorted(glob.glob(os.path.join(
        here, "tests", "test_torch_*.py"))) + list(args))
