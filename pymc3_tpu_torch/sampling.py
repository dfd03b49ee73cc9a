"""Sampling driver (cf. ``pymc3_tpu/sampling.py``).

``sample()`` keeps the JAX package's surface: NUTS with its initialization
for a continuous model, and otherwise the step methods that
``assign_step_methods`` picks for each variable, compounded. All chains
advance together as the leading dimension of ``(chains, n)`` tensors on the
model's device; a Python loop runs the draws, the random numbers come from
one ``torch.Generator`` on that device seeded from ``random_seed``, and the
kept draws are decoded on the device into per-block buffers that are copied
to the host once per block.

The predictive entry points draw every variable for all samples at once on
the model's device, from a ``torch.Generator`` seeded from ``random_seed``
(the JAX package seeds numpy's global generator and draws on the host), and
return numpy arrays with the JAX package's keys and shapes.
"""
from __future__ import annotations

import logging
import sys
import time
import warnings
from collections import defaultdict
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from .backends.base import MultiTrace
from .backends.ndarray import NDArray
from .backends.report import SamplerReport, SamplerWarning, WarningType
from .config import floatX, torch_floatX
from .distributions.distribution import make_generator
from .distributions.shape_utils import to_tuple
from .exceptions import SamplingError
from .model import all_continuous, modelcontext
from .node import _ev
from .step_methods import STEP_METHODS, CompoundStep, DEMetropolis, NUTS
from .step_methods.arraystep import GeneratorNoise, TuneContext
from .step_methods.hmc.nuts import find_reasonable_eps
from .step_methods.hmc.quadpotential import (
    QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
    QuadPotentialFullAdapt,
)
from .util import get_var_name, update_start_vals
from .vartypes import discrete_types

__all__ = ["sample", "iter_sample", "init_nuts", "stop_tuning", "assign_step_methods",
           "instantiate_steppers", "sample_prior_predictive",
           "sample_posterior_predictive", "fast_sample_posterior_predictive",
           "sample_posterior_predictive_w"]

_log = logging.getLogger("pymc3_tpu_torch")

# elements of (chains x draws x traced values) held on the device per block
_BLOCK_BUDGET = int(5e7)


def instantiate_steppers(model, steps, selected_steps, step_kwargs=None):
    """Instantiate the step method chosen for each group of variables
    (cf. ``sampling.py:56``)."""
    if step_kwargs is None:
        step_kwargs = {}
    used_keys = set()
    for step_class, vars in selected_steps.items():
        if len(vars) == 0:
            continue
        args = step_kwargs.get(step_class.name, {})
        used_keys.add(step_class.name)
        steps.append(step_class(vars=vars, model=model, **args))

    unused_args = set(step_kwargs).difference(used_keys)
    if unused_args:
        raise ValueError(f"Unused step method arguments: {unused_args}")
    if len(steps) == 1:
        return steps[0]
    return steps


def assign_step_methods(model, step=None, methods=STEP_METHODS,
                        step_kwargs=None):
    """Assign every free variable that ``step`` does not cover to the step
    method most competent for it (cf. ``sampling.py:80``)."""
    steps = []
    assigned_vars = set()
    if step is not None:
        try:
            steps += list(step)
        except TypeError:
            steps.append(step)
        for s in steps:
            assigned_vars |= {get_var_name(v) for v in s.vars}

    selected_steps = defaultdict(list)
    for var in model.free_RVs:
        if get_var_name(var) in assigned_vars:
            continue
        has_grad = _has_grad(model, var)
        selected = max(methods,
                       key=lambda method: method.competence(var, has_grad))
        selected_steps[selected].append(var)
    return instantiate_steppers(model, steps, selected_steps, step_kwargs)


def _has_grad(model, var):
    """Is d logp / d var finite at the test point? A discrete variable has
    no gradient, and autograd is not asked for one."""
    if str(np.dtype(var.distribution.dtype)) in discrete_types:
        return False
    try:
        q = torch.as_tensor(model.dict_to_array(model.test_point),
                            dtype=torch_floatX(), device=model.device)[None]
        _, grad = model.logp_dlogp_function()(q)
        vm = model.ordering.by_name[var.name]
        return bool(torch.isfinite(grad[0, vm.slc]).all())
    except (RuntimeError, NotImplementedError):
        return False


_STEPPER_NAMES = ("nuts", "hmc", "metropolis", "slice", "DEMetropolis",
                  "DEMetropolisZ", "binary_metropolis",
                  "binary_gibbs_metropolis", "categorical_gibbs_metropolis")

# keywords of the JAX package's sample() that later slices of the port bring
_LATER = {
    "resume_from": "the port's bench slice (ROADMAP item 6)",
    "devices": "the multi-GPU slice (ROADMAP item 13)",
    "return_inferencedata": "the backends slice (ROADMAP item 14)",
    "idata_kwargs": "the backends slice (ROADMAP item 14)",
}


def sample(draws=500, step=None, init="auto", n_init=200000, start=None,
           trace=None, chain_idx=0, chains=None, cores=None, tune=500,
           progressbar=True,
           model=None, random_seed=None, discard_tuned_samples=True,
           compute_convergence_checks=True, callback=None,
           return_inferencedata=None, idata_kwargs=None, mp_ctx=None,
           pickle_backend="pickle", target_accept=None, axis_name=None,
           devices=None, record_stats=None, block_size=None, **kwargs):
    """Draw samples from the posterior (cf. ``sampling.py:128``).

    With no ``step``, a model of continuous variables only gets NUTS with
    its mass-matrix initialization; any other model gets the step methods
    that :func:`assign_step_methods` picks, compounded. ``step`` may be one
    stepper or a list; the variables it leaves out are assigned as above.

    ``chains`` is the batch dimension (default 4); ``cores``, ``mp_ctx`` and
    ``pickle_backend`` are accepted for API parity and ignored. ``trace``
    may list the variables to record; ``record_stats`` lists the sampler
    statistics to keep ("diverging" is always kept). ``axis_name`` (any
    value) pools step-size and mass-matrix adaptation over all chains.
    Step-method arguments go by stepper name, ``nuts={"max_treedepth":
    8}``, or together as ``step_kwargs={...}``.

    The draws run in blocks of ``block_size`` (by default as many as fit a
    fixed budget of device memory): each block's kept draws are copied to
    the host at its end, and then ``callback(trace=None, draw=...)`` runs
    once, with ``draw.draw_idx`` the draws done and ``draw.is_last``. A
    ``KeyboardInterrupt``, from the callback or the user, ends the run with
    the draws of the blocks done so far.
    """
    model = modelcontext(model)
    if not model.free_RVs:
        raise ValueError("The model does not contain any free variables.")
    asked = {"resume_from": kwargs.pop("resume_from", None),
             "devices": devices, "return_inferencedata": return_inferencedata,
             "idata_kwargs": idata_kwargs}
    for name, value in asked.items():
        if value is not None:
            raise NotImplementedError(
                f"sample({name}=...) comes with {_LATER[name]}")
    if chains is None:
        chains = max(4, cores or 0)
    step_kwargs = {name: dict(kwargs.pop(name)) for name in _STEPPER_NAMES
                   if name in kwargs}
    legacy = kwargs.pop("step_kwargs", None)
    if legacy:
        bad = set(legacy) - set(_STEPPER_NAMES)
        if bad:
            raise ValueError(
                f"Unknown step method(s) in step_kwargs: {sorted(bad)!r}; "
                f"valid names are {list(_STEPPER_NAMES)}")
        step_kwargs.update(legacy)
    if kwargs:
        raise ValueError(
            f"Unknown keyword argument(s) for sample: {sorted(kwargs)!r}. "
            f"Step-method arguments are passed by stepper name, e.g. "
            f"sample(..., nuts={{'target_accept': 0.9}}).")
    if target_accept is not None:
        step_kwargs.setdefault("nuts", {})["target_accept"] = target_accept
    if random_seed is None:
        random_seed = np.random.randint(0, 2 ** 30)
    random_seed = int(np.asarray(random_seed).ravel()[0])
    start = _check_start_shape(model, start, chains)
    draws, tune = int(draws), int(tune)
    if draws + tune <= 0:
        raise ValueError("Argument `draws` must be greater than 0.")

    # -- step method selection (cf. sampling.py:201-235) ---------------------
    start_points = None
    if step is None and init is not None and all_continuous(model.free_RVs):
        start_points, step = init_nuts(
            init=init, chains=chains, n_init=n_init, model=model,
            random_seed=random_seed, axis_name=axis_name,
            **step_kwargs.get("nuts", {}))
    else:
        step = assign_step_methods(model, step, step_kwargs=step_kwargs)
    if isinstance(step, list):
        step = CompoundStep(step)

    if any(isinstance(m, DEMetropolis) for m in _members(step)):
        ndim = model.ndim
        if chains < 3:
            raise ValueError(
                f"DEMetropolis requires at least 3 chains. For this "
                f"{ndim}-dimensional model you should use >= {ndim + 1} "
                f"chains")
        if chains <= ndim:
            warnings.warn(
                f"DEMetropolis should be used with more chains than "
                f"dimensions! (The model has {ndim} dimensions.)",
                UserWarning)

    # every chain of a run without the NUTS initialization starts at the
    # test point, as in the JAX package (no jitter)
    if start is not None:
        chain_starts = start
    elif start_points is not None:
        chain_starts = start_points
    else:
        chain_starts = [model.test_point] * chains

    q0 = np.stack([model.dict_to_array(_complete_point(model, p))
                   for p in chain_starts]).astype(floatX())
    _check_bad_init(model, chain_starts[0])
    trace_vars = _resolve_trace_vars(model, trace)

    keep_from = tune if discard_tuned_samples else 0
    t_start = time.time()
    result = _device_sample(model, step, q0, draws, tune, random_seed,
                            progressbar, keep_from, trace_vars, record_stats,
                            block_size, callback)
    t_sampling = time.time() - t_start
    if result["interrupted"]:
        if result["n_kept"] == 0:
            raise KeyboardInterrupt(
                "Sampling interrupted before any post-warmup draws "
                "completed.")
        _log.warning(f"Sampling interrupted: returning a partial trace with "
                     f"{result['n_kept']} of {draws + tune - keep_from} "
                     "draws per chain.")

    mtrace = MultiTrace(_flush_to_traces(model, step, result, chain_idx,
                                         trace_vars))
    mtrace._report = SamplerReport()
    mtrace.report._n_tune = tune
    mtrace.report._n_draws = draws
    mtrace.report._t_sampling = t_sampling
    _attach_sample_stats_warnings(mtrace, step, tune, model)
    if compute_convergence_checks:
        if draws < 100:
            warnings.warn("The number of samples is too small to check "
                          "convergence reliably.")
        else:
            mtrace.report._run_convergence_checks(mtrace, model)
    mtrace.report._log_summary()
    return mtrace


def _members(step):
    return step.methods if isinstance(step, CompoundStep) else [step]


def _complete_point(model, point):
    """Fill a (possibly partial, possibly untransformed) start point."""
    start = dict(point or {})
    update_start_vals(start, model.test_point, model)
    names = model.ordering.by_name
    return {k: v for k, v in start.items() if k in names}


def _check_start_shape(model, start, chains):
    """One start point per chain, each value of its variable's shape
    (cf. ``sampling.py:347``)."""
    if start is None:
        return None
    if isinstance(start, dict):
        start = [start] * chains
    e = ""
    for elem in start:
        for var in model.free_RVs:
            name = var.name
            if name in elem:
                var_shape = np.shape(var.test_value)
                start_var_shape = np.shape(elem[name])
                if start_var_shape:
                    if start_var_shape != var_shape:
                        e += f"\nExpected shape {var_shape} for var " \
                             f"'{name}', got: {start_var_shape}"
                elif var_shape:
                    e += f"\nExpected shape {var_shape} for var " \
                         f"'{name}', got scalar {elem[name]}"
    if e:
        raise ValueError(f"Bad shape for start argument:{e}")
    return list(start)


def _check_bad_init(model, start):
    """'Bad initial energy' check with per-factor attribution."""
    point = _complete_point(model, start)
    if not np.isfinite(model.logp(point)):
        raise SamplingError(
            f"Initial evaluation of model at starting point failed!\n"
            f"Starting values:\n{point}\n\nInitial evaluation results:\n"
            f"{model.check_test_point(point)}")


def _resolve_trace_vars(model, trace):
    """A list-valued ``trace`` selects the unobserved variables to record."""
    if trace is None:
        return model.unobserved_RVs
    if not isinstance(trace, (list, tuple)):
        raise NotImplementedError("only the NDArray trace is ported; pass "
                                  "trace=None or a list of variable names")
    by_name = {v.name: v for v in model.unobserved_RVs}
    out = []
    for item in trace:
        name = item if isinstance(item, str) else getattr(item, "name", None)
        if name not in by_name:
            raise ValueError(f"trace list entries must name unobserved model "
                             f"variables; got {item!r}")
        out.append(by_name[name])
    return out


def _device_sample(model, step, q0, draws, tune, random_seed, progressbar,
                   keep_from, trace_vars, record_stats, block_size=None,
                   callback=None):
    """Run warmup and draws over all chains at once, in blocks of
    ``block_size`` draws (tuning included) that end with one copy to the
    host and one call of ``callback``.

    A compound threads ``q`` through its members' kernels; a population
    stepper (``population_based``) steps the ``(chains, n)`` population
    through ``population_kernel_step``. Returns ``values`` {name: (chains,
    n_kept, ...)} and ``stats``, one {name: (chains, n_kept)} per stepper
    that generates statistics, on the host, the final kernel state, and
    whether a ``KeyboardInterrupt`` cut the run short.
    """
    device = model.device
    chains = q0.shape[0]
    total = draws + tune
    gen = torch.Generator(device=device)
    gen.manual_seed(random_seed)
    noise = GeneratorNoise(gen, chains, device)
    q = torch.as_tensor(q0, dtype=torch_floatX(), device=device)

    if tune > 0:
        for m in _members(step):
            if getattr(m, "adapt_step_size", False) and \
                    hasattr(m, "step_size") and hasattr(m, "potential"):
                m.step_size = find_reasonable_eps(m, q, noise)
    state = step.kernel_init(q)
    kernel_step = (step.population_kernel_step
                   if getattr(step, "population_based", False)
                   else step.kernel_step)

    ordering = model.ordering

    def decode(qp):
        env = model._env_from_q(qp, ordering)
        memo = {}
        return {v.name: _ev(v, env, memo) for v in trace_vars}
    decode_batch = torch.func.vmap(decode)

    stat_names = [[k for k in dtypes
                   if record_stats is None or k in record_stats
                   or k == "diverging"]
                  for dtypes in (step.stats_dtypes if step.generates_stats
                                 else [])]
    n_keep = total - keep_from
    width = sum(max(1, int(np.prod(np.shape(v.test_value))))
                for v in trace_vars) + sum(len(n) for n in stat_names)
    if block_size is None:
        block = max(1, min(n_keep, _BLOCK_BUDGET // max(1, chains * width)))
    else:
        block = max(1, int(block_size))
    host_vals = defaultdict(list)
    host_stats = [defaultdict(list) for _ in stat_names]
    buf_vals = defaultdict(list)
    buf_stats = [defaultdict(list) for _ in stat_names]

    def flush():
        for name, rows in buf_vals.items():
            host_vals[name].append(torch.stack(rows, 1).cpu().numpy())
        for host, buf in zip(host_stats, buf_stats):
            for name, rows in buf.items():
                host[name].append(torch.stack(rows, 1).cpu().numpy())
            buf.clear()
        buf_vals.clear()

    t0 = time.time()
    interrupted = False
    try:
        for idx in range(total):
            tctx = TuneContext(idx < tune, idx, tune)
            q, state, stats = kernel_step(q, state, tctx, noise)
            if idx >= keep_from:
                per_stepper = stats if isinstance(stats, list) else [stats]
                for name, val in decode_batch(q).items():
                    buf_vals[name].append(val)
                for names, buf, st in zip(stat_names, buf_stats,
                                          per_stepper):
                    for name in names:
                        buf[name].append(st[name])
            if (idx + 1) % block and idx != total - 1:
                continue
            flush()
            if progressbar:
                sys.stderr.write(f"\rSampling {chains} chains: {idx + 1}/"
                                 f"{total} draws ({time.time() - t0:.1f} s)")
            if callback is not None:
                callback(trace=None, draw=SimpleNamespace(
                    chain=None, is_last=idx == total - 1, draw_idx=idx + 1,
                    tuning=idx < tune, stats=None, point=None))
    except KeyboardInterrupt:
        interrupted = True
        flush()
    if progressbar:
        sys.stderr.write("\n")

    def cat(chunks):
        return np.concatenate(chunks, axis=1)
    values = {k: cat(v) for k, v in host_vals.items()}
    stats_out = [{k: cat(v) for k, v in host.items()} for host in host_stats]
    n_kept = n_keep
    if interrupted:
        # an interrupt inside a draw's bookkeeping can leave one series a
        # row longer than another: keep the draws every series has
        n_kept = min([a.shape[1] for a in values.values()]
                     + [a.shape[1] for st in stats_out for a in st.values()],
                     default=0)
        values = {k: v[:, :n_kept] for k, v in values.items()}
        stats_out = [{k: v[:, :n_kept] for k, v in st.items()}
                     for st in stats_out]
    return {"values": values, "stats": stats_out, "final_state": state,
            "n_kept": n_kept, "chains": chains, "interrupted": interrupted}


def _flush_to_traces(model, step, result, chain_idx, trace_vars):
    """Record the (chains, n_kept, ...) host blocks into one NDArray per
    chain, with one dictionary of statistics per stepper."""
    values, stats = result["values"], result["stats"]
    nkept = result["n_kept"]
    # only the statistics that were kept (a record_stats subset trims them)
    dtypes = [{k: dt for k, dt in full.items() if k in kept}
              for full, kept in zip(step.stats_dtypes, stats)]
    traces = []
    for ci in range(result["chains"]):
        strace = NDArray(model=model, vars=trace_vars)
        strace.setup(nkept, chain_idx + ci, dtypes)
        if nkept:
            strace.record_batch(
                {k: v[ci] for k, v in values.items()}, nkept,
                [{k: kept[k][ci].astype(dt) for k, dt in dts.items()}
                 for dts, kept in zip(dtypes, stats)])
        strace.close()
        traces.append(strace)
    return traces


def stop_tuning(step):
    """Stop tuning the current step method (cf. ``sampling.py:921``)."""
    step.stop_tuning()
    return step


def iter_sample(draws, step, start=None, trace=None, chain=0, tune=None,
                model=None, random_seed=None, callback=None):
    """A generator that yields the trace so far after every draw
    (cf. ``iter_sample``, ``sampling.py:853``): one chain, on the host path
    (``step.step(point)``), for debugging and interactive use."""
    sampling = _iter_sample(draws, step, start, trace, chain, tune, model,
                            random_seed, callback)
    for i, (strace, _) in enumerate(sampling):
        yield MultiTrace([strace[:i + 1]])


def _iter_sample(draws, step, start=None, trace=None, chain=0, tune=None,
                 model=None, random_seed=None, callback=None):
    """Single-chain host-side sampling generator (cf. ``sampling.py:864``).
    ``random_seed`` seeds numpy's global generator, from which the host
    path seeds the steppers' own generators."""
    model = modelcontext(model)
    draws = int(draws)
    tune = int(tune) if tune is not None else 0
    if random_seed is not None:
        np.random.seed(int(np.asarray(random_seed).ravel()[0]))
    if draws < 1:
        raise ValueError("Argument `draws` must be greater than 0.")
    point = _complete_point(model, start or {})
    strace = trace if isinstance(trace, NDArray) else NDArray(model=model)
    try:
        step = CompoundStep(step)
    except TypeError:
        pass
    strace.setup(draws, chain,
                 step.stats_dtypes if step.generates_stats else None)
    try:
        step.tune = bool(tune)
        if hasattr(step, "reset_tuning"):
            step.reset_tuning()
        for i in range(draws):
            if i == tune:
                step.stop_tuning()
            if step.generates_stats:
                point, stats = step.step(point)
                strace.record(point, stats)
                diverging = i > tune and any(
                    s.get("diverging", False) for s in stats)
            else:
                point = step.step(point)
                strace.record(point)
                diverging = False
            if callback is not None:
                callback(trace=strace, draw=(chain, i == draws - 1, i,
                                             i < tune, None, point))
            yield strace, diverging
    finally:
        strace.close()


def _attach_sample_stats_warnings(mtrace, step, tune, model=None):
    """The report's warnings of each chain (cf. ``sampling.py:790``): a
    ``BAD_ENERGY`` where a draw's ``model_logp`` is not finite, naming the
    logp terms that are not finite at that draw; ``DIVERGENCES``; and a
    ``TREEDEPTH`` where a draw reached a stepper's ``max_treedepth``."""
    report = mtrace.report
    names = mtrace.stat_names
    caps = [m.max_treedepth for m in _members(step)
            if hasattr(m, "max_treedepth")]
    for chain in mtrace.chains:
        def stat(name):
            return np.asarray(mtrace.get_sampler_stats(name, chains=[chain]))
        found = []
        if model is not None and "model_logp" in names:
            bad = ~np.isfinite(stat("model_logp").astype(np.float64))
            bad = bad.reshape(bad.shape[0], -1).any(axis=1)
            if bad.any():
                idx = int(np.argmax(bad))
                per_rv = model.check_test_point(mtrace.point(idx, chain=chain))
                offenders = ", ".join(k for k, v in per_rv.items()
                                      if not np.isfinite(v)) or "unattributed"
                found.append(SamplerWarning(
                    WarningType.BAD_ENERGY,
                    f"Chain {chain} hit a non-finite model logp at draw "
                    f"{idx} (offending logp terms: {offenders}).",
                    "warn", idx, None, None))
        if "diverging" in names:
            n = int(np.sum(stat("diverging")))
            if n:
                found.append(SamplerWarning(
                    WarningType.DIVERGENCES,
                    f"Chain {chain} had {n} diverging samples after tuning.",
                    "warn", None, None, None))
        if "depth" in names and caps:
            depth = stat("depth")
            for cap in caps:
                if (depth >= cap).any():
                    found.append(SamplerWarning(
                        WarningType.TREEDEPTH,
                        f"Chain {chain} reached the maximum tree depth. "
                        "Increase max_treedepth, increase target_accept or "
                        "reparameterize.", "warn", None, None, None))
        if found:
            report._add_warnings(found, chain)


def init_nuts(init="auto", chains=1, n_init=500000, model=None,
              random_seed=None, axis_name=None, progressbar=True, **kwargs):
    """NUTS with its mass-matrix initialization (cf. ``sampling.py:968``).

    ``init`` is one of ``auto`` (= ``jitter+adapt_diag``), ``adapt_diag``,
    ``jitter+adapt_diag``, ``advi+adapt_diag``, ``advi+adapt_diag_grad``,
    ``advi``, ``advi_map``, ``map``, ``adapt_full``, ``jitter+adapt_full``
    and ``nuts``. The jitter comes from numpy's global generator seeded with
    ``random_seed``, so the start points equal the JAX package's for the
    same seed. The ``advi`` strategies fit ADVI for at most ``n_init`` steps
    (stopped early by two ``CheckParametersConvergence`` callbacks, absolute
    and relative, at tolerance 1e-2), start the chains at draws of the fit
    and take its variances as the mass matrix; ``advi_map`` starts them at
    ``find_MAP``'s point instead; ``map`` starts them there with the inverse
    Hessian as a dense mass matrix (an adaptive diagonal one where the
    Hessian cannot be inverted).
    """
    model = modelcontext(model)
    vars = kwargs.pop("vars", model.vars)
    if set(vars) != set(model.vars):
        raise ValueError("Must use init_nuts on all variables of a model.")
    if not all_continuous(vars):
        raise ValueError("init_nuts can only be used for models with only "
                         "continuous variables.")
    if not isinstance(init, str):
        raise TypeError("init must be a string.")
    init = init.lower()
    if init == "auto":
        init = "jitter+adapt_diag"
    if random_seed is not None:
        random_seed = int(np.atleast_1d(random_seed)[0])
        np.random.seed(random_seed)

    q0 = model.dict_to_array(model.test_point).astype(floatX())
    n = q0.shape[0]

    def jitter_starts():
        return [model.array_to_dict(
            q0 + np.random.uniform(-1, 1, size=n).astype(floatX()))
            for _ in range(chains)]

    def starts_mean(starts):
        return np.stack([model.dict_to_array(p) for p in starts]).mean(axis=0)

    if init == "adapt_diag":
        start = [model.test_point] * chains
        potential = QuadPotentialDiagAdapt(n, q0, np.ones(n), 10)
    elif init == "jitter+adapt_diag":
        start = jitter_starts()
        potential = QuadPotentialDiagAdapt(n, starts_mean(start), np.ones(n),
                                           10)
    elif init in ("advi+adapt_diag", "advi+adapt_diag_grad", "advi",
                  "advi_map"):
        from .tuning import find_MAP
        from .variational import fit
        from .variational.callbacks import CheckParametersConvergence
        cb = [CheckParametersConvergence(tolerance=1e-2, diff="absolute"),
              CheckParametersConvergence(tolerance=1e-2, diff="relative")]
        approx = fit(random_seed=random_seed, n=n_init, method="advi",
                     model=model, callbacks=cb, progressbar=progressbar)
        approx_trace = approx.sample(draws=chains, random_seed=random_seed)
        start = [{k: np.asarray(approx_trace.point(i)[k])
                  for k in model.ordering.by_name} for i in range(chains)]
        var = approx.std ** 2
        if init == "advi_map":
            start = [find_MAP(model=model)] * chains
        if init in ("advi", "advi_map"):
            potential = QuadPotentialDiag(var)
        else:
            potential = QuadPotentialDiagAdapt(n, approx.mean, var, 50)
    elif init == "map":
        from .tuning import find_MAP, find_hessian
        start_map = find_MAP(model=model)
        try:
            cov = np.linalg.inv(find_hessian(start_map, model=model))
            potential = QuadPotentialFull(cov)
        except (np.linalg.LinAlgError, RuntimeError, NotImplementedError):
            potential = QuadPotentialDiagAdapt(
                n, model.dict_to_array(start_map), np.ones(n), 10)
        start = [start_map] * chains
    elif init == "adapt_full":
        start = [model.test_point] * chains
        potential = QuadPotentialFullAdapt(n, q0)
    elif init == "jitter+adapt_full":
        start = jitter_starts()
        potential = QuadPotentialFullAdapt(n, starts_mean(start))
    elif init == "nuts":
        start = jitter_starts()
        potential = QuadPotentialDiagAdapt(n, q0, np.ones(n), 10)
    else:
        raise ValueError(f"Unknown initializer: {init}.")
    step = NUTS(potential=potential, model=model, axis_name=axis_name,
                **kwargs)
    return start, step


# ---------------------------------------------------------------------------
# Predictive sampling (cf. pymc3_tpu/sampling.py:1036-1198)
# ---------------------------------------------------------------------------
class IncorrectArgumentsError(ValueError):
    pass


def _generator(model, random_seed):
    return make_generator(model.device, None if random_seed is None
                          else np.atleast_1d(random_seed)[0])


def _host(x):
    return x.detach().cpu().numpy()


def sample_prior_predictive(samples=500, model=None, vars=None,
                            var_names=None, random_seed=None
                            ) -> Dict[str, np.ndarray]:
    """Draws from the prior predictive distribution (cf. ``sampling.py:1036``).

    ``samples`` is an int or a size tuple: every draw carries that leading
    shape, with 1 or (1,) giving unbatched draws, as in the JAX package.
    """
    model = modelcontext(model)
    if vars is None and var_names is None:
        names = [get_var_name(v) for v in
                 model.unobserved_RVs + list(model.deterministics)
                 + model.observed_RVs]
    elif vars is None:
        names = list(var_names)
    elif var_names is None:
        names = [get_var_name(v) for v in vars]
    else:
        raise ValueError("Cannot supply both vars and var_names arguments.")

    size = to_tuple(samples) if samples is not None else ()
    if size == (1,):
        size = ()
    flat = int(np.prod(size, dtype=int)) if size else 1
    values = model.sample_forward(flat, gen=_generator(model, random_seed))
    data = {}
    for name in names:
        if name in values:
            out = _host(values[name])
            data[name] = out.reshape(size + out.shape[1:])
    if not data:
        raise AssertionError(
            f"No variables sampled: attempting to sample {names}")
    return data


def _trace_arrays(trace, model):
    """The trace as stacked arrays ``{name: (n_points, ...)}``, chain after
    chain, with its chain count."""
    if isinstance(trace, MultiTrace):
        return ({name: trace.get_values(name, combine=True)
                 for name in trace.varnames}, trace.nchains)
    if isinstance(trace, dict):
        arrays = {k: np.asarray(v) for k, v in trace.items()}
        if len({len(np.atleast_1d(v)) for v in arrays.values()}) != 1:
            raise ValueError("Arrays in trace dict must have equal length")
        return arrays, 1
    if isinstance(trace, list):
        return ({k: np.stack([np.asarray(p[k]) for p in trace])
                 for k in trace[0]}, 1)
    raise TypeError("Unsupported trace type")


def _posterior_predictive(trace, samples, model, vars, var_names, size,
                          keep_size, gen):
    points, nchain = _trace_arrays(trace, model)
    n_points = len(next(iter(points.values())))
    len_trace = n_points // max(nchain, 1)

    if keep_size and samples is not None:
        raise IncorrectArgumentsError(
            "Should not specify both keep_size and samples arguments")
    if keep_size and size is not None:
        raise IncorrectArgumentsError(
            "Should not specify both keep_size and size arguments")
    if samples is None:
        samples = n_points
    if samples < len_trace * nchain:
        warnings.warn("samples parameter is smaller than nchains times "
                      "ndraws, some draws and/or chains may not be "
                      "represented in the returned posterior predictive "
                      "sample")
    if var_names is not None:
        if vars is not None:
            raise IncorrectArgumentsError(
                "Should not specify both vars and var_names arguments.")
        vars = [model[x] for x in var_names]
    elif vars is None:
        vars = model.observed_RVs

    # trace points cycled (or cut short) to ``samples``, as the JAX package
    idx = np.mod(np.arange(samples), n_points)
    out = model.sample_forward_conditional(points, idx, vars, size=size,
                                           gen=gen)
    out = {k: _host(v) for k, v in out.items()}
    if keep_size:
        out = {k: v.reshape((nchain, len_trace) + v.shape[1:])
               for k, v in out.items()}
    return out


def sample_posterior_predictive(trace, samples=None, model=None, vars=None,
                                var_names=None, size=None, keep_size=False,
                                random_seed=None, progressbar=True
                                ) -> Dict[str, np.ndarray]:
    """Posterior-predictive draws given a trace (cf. ``sampling.py:1083``).

    Every selected trace point is drawn forward at once on the model's
    device; ``trace`` is a MultiTrace, a dict of equal-length arrays or a
    list of points.
    """
    model = modelcontext(model)
    return _posterior_predictive(trace, samples, model, vars, var_names,
                                 size, keep_size,
                                 _generator(model, random_seed))


def fast_sample_posterior_predictive(trace, samples=None, model=None,
                                     var_names=None, keep_size=False,
                                     random_seed=None
                                     ) -> Dict[str, np.ndarray]:
    """The vectorized posterior predictive (cf. ``sampling.py:1144``): the
    standard path is vectorized, so this is the same call."""
    return sample_posterior_predictive(
        trace, samples=samples, model=model, var_names=var_names,
        keep_size=keep_size, random_seed=random_seed, progressbar=False)


def sample_posterior_predictive_w(traces, samples=None, models=None,
                                  weights=None, random_seed=None,
                                  progressbar=True):
    """Weighted posterior predictive draws from several models
    (cf. ``sampling.py:1155``): how many draws each trace gives is itself
    one multinomial draw from the weights."""
    if models is None:
        models = [modelcontext(None)] * len(traces)
    if weights is None:
        weights = [1.0] * len(traces)
    if len(traces) != len(weights) or len(models) != len(weights):
        raise ValueError("The number of traces, models and weights must be "
                         "the same")
    gen = _generator(models[0], random_seed)
    if samples is None:
        samples = min(len(tr) * tr.nchains for tr in traces)
    p = torch.as_tensor(np.asarray(weights, dtype=float), device=gen.device)
    pick = torch.multinomial(p / p.sum(), int(samples), replacement=True,
                             generator=gen)
    ns = torch.bincount(pick, minlength=len(traces)).tolist()
    results = defaultdict(list)
    for tr, m, n in zip(traces, models, ns):
        if n == 0:
            continue
        if m.device != gen.device:
            raise ValueError("the models must share one device")
        sub = _posterior_predictive(tr, n, m, None, None, None, False, gen)
        for k, v in sub.items():
            results[k].append(v)
    return {k: np.concatenate(v, axis=0) for k, v in results.items()}
