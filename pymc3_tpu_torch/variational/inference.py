"""Inference classes of VI (cf. ``pymc3_tpu/variational/inference.py``).

``Inference.fit`` runs the optimizer steps in blocks of ``block``: within a
block nothing waits for the device (the random numbers are drawn there from
one ``torch.Generator`` seeded from ``random_seed``, and each step's loss is
written into a buffer there). At the end of a block the losses are copied
to the host once, a non-finite loss is reported, and the callbacks run, as
the JAX package does between its scans.
"""
from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..config import torch_floatX
from ..model import modelcontext
from .approximations import (Empirical, FullRank, FullRankGroup, MeanField,
                             MeanFieldGroup, NormalizingFlow)
from .operators import KL, KSD
from .opvi import Approximation
from .updates import adagrad_window

_log = logging.getLogger("pymc3_tpu_torch")

__all__ = ["ADVI", "FullRankADVI", "SVGD", "ASVGD", "NFVI", "Inference",
           "ImplicitGradient", "KLqp", "fit"]


class Inference:
    """Base inference class (cf. ``inference.py:35``)."""

    def __init__(self, op, approx, tf, **kwargs):
        self.hist = np.asarray(())
        self.objective = op(approx, **kwargs)(tf)
        self.state = None
        self._state_opt = None
        self._default_optimizer = None

    @property
    def approx(self) -> Approximation:
        return self.objective.approx

    def _generator(self, random_seed):
        gen = torch.Generator(device=self.approx.model.device)
        if random_seed is None:
            random_seed = np.random.randint(0, 2 ** 31 - 1)
        gen.manual_seed(int(random_seed))
        return gen

    def _optimizer(self, obj_optimizer):
        """``obj_optimizer``, or this object's own ``adagrad_window``: an
        optimizer state carries over between fits with the same optimizer
        object."""
        if obj_optimizer is not None:
            return obj_optimizer
        if self._default_optimizer is None:
            self._default_optimizer = adagrad_window()
        return self._default_optimizer

    def run_profiling(self, n=1000, score=None, obj_n_mc=1, **kwargs):
        """Host-clock time per step over ``n`` steps after one warm step,
        waited for at the end (cf. ``inference.py:47``)."""
        step, opt = self.objective.step_function(obj_n_mc=obj_n_mc, **kwargs)
        params = self.approx.params
        state = opt.init(params)
        gen = self._generator(0)
        sync = (torch.cuda.synchronize
                if self.approx.model.device.type == "cuda" else lambda: None)
        t0 = time.perf_counter()
        params, state, _ = step(params, state,
                                self.objective.draw_noise(gen, obj_n_mc))
        sync()
        first = time.perf_counter() - t0
        t0 = time.perf_counter()
        for _ in range(n):
            params, state, _ = step(params, state,
                                    self.objective.draw_noise(gen, obj_n_mc))
        sync()
        total = time.perf_counter() - t0
        return {"n": n, "first_step_s": first,
                "per_step_us": total / n * 1e6}

    def fit(self, n=10000, score=None, callbacks=None, progressbar=True,
            obj_n_mc=1, obj_optimizer=None, block=1000, random_seed=None,
            total_grad_norm_constraint=None, **kwargs) -> Approximation:
        """Run ``n`` optimizer steps (cf. ``inference.py:67``): ``block``
        steps between host copies of the loss and calls of ``callbacks``,
        which may stop the fit by raising ``StopIteration``."""
        callbacks = callbacks or []
        self._refine_kwargs = dict(
            obj_n_mc=obj_n_mc, obj_optimizer=obj_optimizer, block=block,
            total_grad_norm_constraint=total_grad_norm_constraint)
        step, opt = self.objective.step_function(
            obj_n_mc=obj_n_mc, obj_optimizer=self._optimizer(obj_optimizer),
            total_grad_norm_constraint=total_grad_norm_constraint)
        params = self.approx.params
        if self.state is None or self._state_opt is not opt:
            state = opt.init(params)
        else:
            state = self.state
        self._state_opt = opt
        gen = self._generator(random_seed)
        device = self.approx.model.device
        block = max(1, int(block))
        losses = torch.zeros(min(block, max(n, 1)), dtype=torch_floatX(),
                             device=device)
        hist = list(self.hist)
        i = 0
        t0 = time.time()
        try:
            while i < n:
                nsteps = min(block, n - i)
                for j in range(nsteps):
                    params, state, losses[j] = step(
                        params, state,
                        self.objective.draw_noise(gen, obj_n_mc))
                block_losses = losses[:nsteps].cpu().numpy()
                hist.extend(block_losses.tolist())
                i += nsteps
                self.approx.params = params
                self.state = state
                if progressbar:
                    _log.info(f"fit: {i}/{n} steps, loss "
                              f"{block_losses[-1]:.4g} "
                              f"({time.time() - t0:.1f} s)")
                if not np.isfinite(block_losses[-1]):
                    _log.warning(
                        f"NaN/inf loss at iteration {i}; continuing "
                        "(gradients are masked for non-finite steps)")
                for cb in callbacks:
                    cb(self.approx, np.asarray(hist), i)
        except (KeyboardInterrupt, StopIteration) as e:
            if isinstance(e, StopIteration):
                _log.info(str(e))
        self.hist = np.asarray(hist)
        self.approx.hist = self.hist
        return self.approx

    def refine(self, n, progressbar=True):
        """More steps with the last fit's settings and optimizer state
        (cf. ``inference.py:173``)."""
        return self.fit(n, progressbar=progressbar,
                        **getattr(self, "_refine_kwargs", {}))


class KLqp(Inference):
    """KL-divergence VI (cf. ``inference.py:181``)."""

    def __init__(self, approx, beta=1.0):
        super().__init__(KL, approx, None, beta=beta)


def _build_local_approx(model, local_rv, global_family, start=None):
    """One local (AEVB) mean-field group for each entry of ``local_rv``
    (``{var: dict(mu=..., rho=...)}``, ``{var: (mu, rho)}`` or ``{var:
    dict(encoder=fn, aux=...)}``), then one group of ``global_family``
    over the other free variables, started at ``start``
    (cf. ``inference.py:188``)."""
    groups, local_names = [], set()
    for var, spec in local_rv.items():
        if isinstance(spec, (tuple, list)):
            spec = dict(mu=spec[0], rho=spec[1])
        g = MeanFieldGroup([var], local=True, params=dict(spec), model=model)
        groups.append(g)
        local_names.update(v.name for v in g.group_vars)
    rest = [v for v in model.free_RVs if v.name not in local_names]
    if rest:
        family = {"mean_field": MeanFieldGroup,
                  "full_rank": FullRankGroup}[global_family]
        groups.append(family(rest, model=model))
    approx = Approximation(groups, model=model)
    if rest and start is not None:
        approx.params[len(groups) - 1] = groups[-1].init_params(start)
    return approx


class ADVI(KLqp):
    """Automatic differentiation VI with a mean-field Gaussian
    (cf. ``inference.py:210``). ``local_rv={var: params}`` adds local
    (AEVB) groups: see :func:`_build_local_approx` and
    ``MeanFieldGroup``."""

    def __init__(self, *args, model=None, random_seed=None, start=None,
                 local_rv=None, **kwargs):
        model = modelcontext(model)
        approx = _build_local_approx(model, local_rv, "mean_field", start) \
            if local_rv else MeanField(model=model, start=start)
        super().__init__(approx,
                         **{k: v for k, v in kwargs.items() if k == "beta"})


class FullRankADVI(KLqp):
    """ADVI with a full-rank Gaussian (cf. ``inference.py:228``), with
    local groups as :class:`ADVI` has them."""

    def __init__(self, *args, model=None, random_seed=None, start=None,
                 local_rv=None, **kwargs):
        model = modelcontext(model)
        approx = _build_local_approx(model, local_rv, "full_rank", start) \
            if local_rv else FullRank(model=model, start=start)
        super().__init__(approx,
                         **{k: v for k, v in kwargs.items() if k == "beta"})


class ImplicitGradient(Inference):
    """Base of the particle methods (cf. ``inference.py:243``)."""

    def __init__(self, approx, estimator=KSD, kernel=None, **kwargs):
        from .test_functions import RBF
        super().__init__(op=estimator, approx=approx,
                         tf=kernel if kernel is not None else RBF(), **kwargs)


class SVGD(ImplicitGradient):
    """Stein variational gradient descent over ``n_particles`` particles
    (cf. ``inference.py:253``); ``random_seed`` seeds numpy's global
    generator, which places the particles, as in the JAX package."""

    def __init__(self, n_particles=100, jitter=1, model=None, start=None,
                 random_seed=None, estimator=KSD, kernel=None,
                 temperature=1.0, **kwargs):
        if random_seed is not None:
            np.random.seed(int(random_seed))
        model = modelcontext(model)
        super().__init__(approx=Empirical(size=n_particles, model=model),
                         estimator=estimator, kernel=kernel,
                         temperature=temperature, **kwargs)


class ASVGD(ImplicitGradient):
    """Amortized SVGD (cf. ``inference.py:267``): a parametric sampler
    (FullRank by default) trained along the Stein direction of
    ``obj_n_mc`` of its draws."""

    def __init__(self, approx=None, estimator=KSD, kernel=None,
                 model=None, random_seed=None, **kwargs):
        if random_seed is not None:
            np.random.seed(int(random_seed))
        if approx is None:
            approx = FullRank(model=modelcontext(model))
        super().__init__(approx=approx, estimator=estimator, kernel=kernel,
                         **kwargs)

    def fit(self, n=10000, score=None, callbacks=None, progressbar=True,
            obj_n_mc=100, **kwargs):
        return super().fit(n=n, score=score, callbacks=callbacks,
                           progressbar=progressbar, obj_n_mc=obj_n_mc,
                           **kwargs)


class NFVI(KLqp):
    """Normalizing-flow VI (cf. ``inference.py:296``)."""

    def __init__(self, flow="scale-loc", model=None, **kwargs):
        model = modelcontext(model)
        super().__init__(NormalizingFlow(flow=flow, model=model),
                         **{k: v for k, v in kwargs.items() if k == "beta"})


def fit(n=10000, local_rv=None, method="advi", model=None, random_seed=None,
        start=None, inf_kwargs=None, **kwargs) -> Approximation:
    """Fit a variational approximation (cf. ``inference.py:306``).

    ``method``: 'advi', 'fullrank_advi', 'svgd', 'asvgd', 'nfvi',
    'nfvi=<formula>' or an :class:`Inference`.
    """
    inf_kwargs = dict(inf_kwargs or {})
    if local_rv is not None:
        if not (isinstance(method, str)
                and method in ("advi", "fullrank_advi")):
            raise NotImplementedError(
                "local_rv (AEVB) is supported for advi and fullrank_advi "
                "only")
        inf_kwargs["local_rv"] = local_rv
    if random_seed is not None:
        inf_kwargs["random_seed"] = random_seed
    if start is not None:
        inf_kwargs["start"] = start
    model = modelcontext(model)
    select = dict(advi=ADVI, fullrank_advi=FullRankADVI, svgd=SVGD,
                  asvgd=ASVGD, nfvi=NFVI)
    if isinstance(method, str):
        method = method.lower()
        if method.startswith("nfvi="):
            inference = NFVI(method[len("nfvi="):], model=model,
                             **inf_kwargs)
        elif method in select:
            inference = select[method](model=model, **inf_kwargs)
        else:
            raise KeyError(f"method should be one of {set(select)} or an "
                           "Inference instance")
    elif isinstance(method, Inference):
        inference = method
    else:
        raise TypeError(f"method should be one of {set(select)} or an "
                        "Inference instance")
    fit_kwargs = {k: v for k, v in kwargs.items()
                  if k not in ("random_seed", "start",
                               "obj_optimizer_kwargs")}
    if "random_seed" in inf_kwargs:
        fit_kwargs["random_seed"] = inf_kwargs["random_seed"]
    return inference.fit(n, **fit_kwargs)
