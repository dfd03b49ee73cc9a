"""Every public callable of the port takes the JAX package's parameters,
module by module.

Over the modules and module renames of ``test_torch_submodule_surface.py``
(one case per JAX module), for every public function, every class's
``__init__`` and every public method the JAX module defines or lists in
``__all__``:

- every named parameter of the JAX signature is a named parameter of the
  port's (a port ``**kwargs`` does not count as accepting a name);
- where both defaults are plain literals (a number, a string, a bool,
  ``None``, or a tuple of these), they are equal.

A parameter is named by where its callable is defined, ``module.Qual.param``
relative to the package (a re-exported class is checked under its own
module). ``EXCLUDED`` maps the parameters that carry the JAX package's own
idiom to the port's counterpart, which a test asserts exists: PRNG keys
(the port draws from explicit noise or a ``torch.Generator``), the Pallas
switches and XLA's matmul precision.
"""
import importlib
import inspect

import pytest
import torch

import pymc3_tpu
import pymc3_tpu_torch

from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .test_torch_submodule_surface import (
    JAX_MODULES, _public_names, _relative, _resolve, port_module,
)

_SM = "step_methods."
EXCLUDED = {
    # -- JAX PRNG keys: each transition's random numbers come from noise
    **{f"{_SM}{qual}.kernel_step.key": f"{_SM}{qual}.kernel_step.noise"
       for qual in (
           "arraystep.BlockedStep", "compound.CompoundStep",
           "elliptical_slice.EllipticalSlice", "gibbs.ElemwiseCategorical",
           "hmc.hmc.HamiltonianMC", "hmc.nuts.NUTS",
           "metropolis.BinaryGibbsMetropolis", "metropolis.BinaryMetropolis",
           "metropolis.CategoricalGibbsMetropolis",
           "metropolis.DEMetropolisZ", "metropolis.Metropolis",
           "sgmcmc.BaseStochasticGradient", "slicer.Slice")},
    f"{_SM}metropolis.DEMetropolis.population_kernel_step.key":
        f"{_SM}metropolis.DEMetropolis.population_kernel_step.noise",
    # the accept/reject uniform is drawn by the caller's noise
    f"{_SM}arraystep.metrop_select.key": f"{_SM}arraystep.metrop_select.u",
    # a proposal reads its normals (and their count, the chains) from noise
    **{f"{_SM}metropolis.{cls}.sample.{p}":
       f"{_SM}metropolis.{cls}.sample.{q}"
       for cls in ("CauchyProposal", "LaplaceProposal", "NormalProposal",
                   "PoissonProposal", "UniformProposal",
                   "MultivariateNormalProposal")
       for p, q in (("key", "noise"), ("shape", "dim"))},
    f"{_SM}metropolis.MultivariateNormalProposal.sample.num_draws":
        f"{_SM}metropolis.MultivariateNormalProposal.sample.noise",
    # momenta from standard normals drawn by the caller, or from a generator
    f"{_SM}hmc.quadpotential.diag_random.key":
        f"{_SM}hmc.quadpotential.diag_random.gen",
    f"{_SM}hmc.quadpotential.dense_random.key":
        f"{_SM}hmc.quadpotential.dense_random.z",
    f"{_SM}hmc.quadpotential.kernel_momentum.key":
        f"{_SM}hmc.quadpotential.kernel_momentum.z",
    # one NUTS draw from noise; the depth cap is a host int, not a tracer
    f"{_SM}hmc.nuts.nuts_draw.key": f"{_SM}hmc.nuts.nuts_draw.noise",
    f"{_SM}hmc.nuts.nuts_draw.max_treedepth_t":
        f"{_SM}hmc.nuts.nuts_draw.max_treedepth",
    f"{_SM}hmc.nuts.nuts_draw.max_treedepth_static":
        f"{_SM}hmc.nuts.nuts_draw.max_treedepth",
    # a minibatch's rows from a drawn offset instead of a key
    "data.MinibatchNode.indices.key": "data.MinibatchNode.indices.r",
    # variational samples from drawn noise; its leading axis is their count
    "variational.opvi.Approximation.sample_q.key":
        "variational.opvi.Approximation.sample_q.noise",
    "variational.opvi.Approximation.sample_q.mb_keys":
        "variational.opvi.Approximation.sample_q.noise",
    "variational.opvi.Group.sample_q.key":
        "variational.opvi.Group.sample_q.noise",
    "variational.opvi.Group.sample_q.size":
        "variational.opvi.Group.sample_q.noise",
    **{f"variational.approximations.{cls}.sample_q.{p}":
       f"variational.approximations.{cls}.sample_q.eps"
       for cls in ("MeanFieldGroup", "FullRankGroup", "NormalizingFlowGroup")
       for p in ("key", "size")},
    "variational.approximations.MeanFieldGroup.sample_q.mb_keys":
        "variational.approximations.MeanFieldGroup.sample_q.draws",
    "variational.approximations.EmpiricalGroup.sample_q.key":
        "variational.approximations.EmpiricalGroup.sample_q.idx",
    "variational.approximations.EmpiricalGroup.sample_q.size":
        "variational.approximations.EmpiricalGroup.sample_q.idx",
    # -- the Pallas switches: the device of X picks the path (a CUDA tensor
    # launches the kernel, a CPU tensor takes the plain version)
    **{f"ops.pallas.gp_cov.stationary_cov.{p}": "ops.gp_cov.stationary_cov.X"
       for p in ("force_pallas", "interpret")},
    # -- XLA's matmul precision: PyTorch's own setting
    "config.Config.__init__.matmul_precision":
        "torch.set_float32_matmul_precision",
    "math.matmul.precision": "torch.set_float32_matmul_precision",
}


def _literal(v):
    if v is None or isinstance(v, (bool, int, float, str)):
        return True
    return isinstance(v, tuple) and all(_literal(x) for x in v)


def _named(fn):
    """The named parameters of ``fn``: ``{name: Parameter}``, or None where
    it has no signature."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None
    return {n: p for n, p in params.items() if p.kind not in (
        p.POSITIONAL_ONLY, p.VAR_POSITIONAL, p.VAR_KEYWORD)}


def _key(fn, fallback):
    """``module.Qual`` of where ``fn`` is defined in the JAX package
    (``fallback`` for a callable from elsewhere, such as ``jnp``'s)."""
    module = getattr(fn, "__module__", None) or ""
    qual = getattr(fn, "__qualname__", "")
    if module.startswith("pymc3_tpu.") and qual and "<" not in qual:
        return f"{_relative(module)}.{qual}"
    return fallback


def _compare(key, jfn, tfn, out):
    jp = _named(jfn)
    if jp is None:
        return
    tp = _named(tfn) or {}
    for name, p in jp.items():
        full = f"{key}.{name}"
        if full in EXCLUDED:
            continue
        if name not in tp:
            out.append(f"{full}: not a named parameter of the port's")
            continue
        jd, td = p.default, tp[name].default
        if jd is not p.empty and td is not p.empty and _literal(jd) \
                and _literal(td) and jd != td:
            out.append(f"{full}: default {td!r}, the JAX package's {jd!r}")


def _callables(jo, to, key):
    """``(key, jax callable, port callable)`` of ``jo`` and its port
    ``to``: the function itself, or a class's ``__init__`` and its public
    methods."""
    if not inspect.isclass(jo):
        return [(_key(jo, key), jo, to)] if callable(jo) else []
    init = to.__init__ if inspect.isclass(to) else to
    out = [(_key(jo.__init__, f"{key}.__init__"), jo.__init__, init)]
    for member, raw in vars(jo).items():
        if member.startswith("_") or not hasattr(to, member):
            continue
        if not isinstance(raw, (staticmethod, classmethod)) \
                and not inspect.isfunction(raw):
            continue
        jm = getattr(jo, member)
        out.append((_key(jm, f"{key}.{member}"), jm, getattr(to, member)))
    return out


def _mismatches(module):
    jm = importlib.import_module(module)
    tm = importlib.import_module(port_module(module))
    rel = _relative(module)
    out = []
    for name in _public_names(jm):
        if not hasattr(jm, name) or not hasattr(tm, name):
            continue  # a missing name is the name surface's to report
        for key, jfn, tfn in _callables(getattr(jm, name),
                                        getattr(tm, name), f"{rel}.{name}"):
            _compare(key, jfn, tfn, out)
    return sorted(set(out))


@pytest.mark.parametrize("module", JAX_MODULES)
def test_signatures_take_the_jax_parameters(module):
    assert _mismatches(module) == []


def _split(path):
    owner, param = path.rsplit(".", 1)
    return owner, param


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_exclusion_names_its_counterpart(name):
    """The excluded name is a parameter of the JAX package's callable, and
    its counterpart a parameter of the port's (or PyTorch's own
    setting)."""
    owner, param = _split(name)
    assert param in _named(_resolve(pymc3_tpu, owner))
    counterpart = EXCLUDED[name]
    if counterpart.startswith("torch."):
        assert callable(_resolve(torch, counterpart[len("torch."):]))
        return
    owner, param = _split(counterpart)
    assert param in _named(_resolve(pymc3_tpu_torch, owner))
