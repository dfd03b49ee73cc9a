"""Step-method framework (cf. ``pymc3_tpu/step_methods/arraystep.py``).

A stepper owns an index set into the model's flat unconstrained vector and
exposes, over a batch of chains,

    ``kernel_init(q0: (chains, n)) -> state``
    ``kernel_step(q, state, tctx, noise) -> (q, state, stats)``

``q`` is the full flat vector of every chain and threads from stepper to
stepper inside a :class:`~.compound.CompoundStep`; a stepper moves only its
own columns. ``state`` is a NamedTuple of tensors with a leading chain
dimension (and host integers where a value depends on the draw index
alone). The random numbers of a transition come from ``noise``
(:class:`GeneratorNoise`, or a test's own object handing in fixed numbers),
where the JAX kernels split a key.

The host-side ``step(point)`` (API parity, debugging) runs the kernel on a
batch of one chain.
"""
from __future__ import annotations

from enum import IntEnum, unique
from typing import Dict, List

import numpy as np
import torch

from ..blocking import ArrayOrdering, DictToArrayBijection
from ..config import torch_floatX
from ..model import modelcontext
from ..torchf import batched_value_and_grad

__all__ = ["ArrayStep", "ArrayStepShared", "BlockedStep", "Competence",
           "GeneratorNoise", "GradientSharedStep", "TuneContext",
           "metrop_select"]


@unique
class Competence(IntEnum):
    """Usability of a step method for a variable (cf. ``arraystep.py:28``)."""

    INCOMPATIBLE = 0
    COMPATIBLE = 1
    PREFERRED = 2
    IDEAL = 3


class TuneContext:
    """Per-draw context: ``tune`` (bool), ``step_idx`` (draw counter) and
    ``n_tune``. All host values: the draw loop runs on the host."""

    __slots__ = ("tune", "step_idx", "n_tune")

    def __init__(self, tune, step_idx, n_tune):
        self.tune = bool(tune)
        self.step_idx = int(step_idx)
        self.n_tune = int(n_tune)


class GeneratorNoise:
    """The random numbers of the steppers' transitions for ``chains`` chains,
    drawn from one ``torch.Generator`` on ``device``. Every method returns a
    tensor with a leading chain dimension."""

    def __init__(self, generator, chains, device):
        self.generator = generator
        self.chains = int(chains)
        self.device = device

    def _shape(self, dim):
        return (self.chains,) if dim is None else (self.chains, int(dim))

    def normal(self, dim):
        """Standard normal ``(chains, dim)``: momenta and proposals."""
        return torch.randn(self._shape(dim), generator=self.generator,
                           dtype=torch_floatX(), device=self.device)

    def uniform(self, dim=None):
        """Uniform on [0, 1): ``(chains,)``, or ``(chains, dim)``."""
        return torch.rand(self._shape(dim), generator=self.generator,
                          dtype=torch_floatX(), device=self.device)

    def gumbel(self, dim):
        """Standard Gumbel ``(chains, dim)``, ``-log(-log(u))`` with ``u``
        uniform on [tiny, 1): a categorical draw is the argmax of the
        log-probabilities plus these."""
        u = torch.rand(self._shape(dim), generator=self.generator,
                       dtype=torch_floatX(), device=self.device)
        return -torch.log(-torch.log(
            torch.clamp(u, min=torch.finfo(u.dtype).tiny)))

    def exponential(self):
        """Unit exponential ``(chains,)``."""
        return torch.empty(self.chains, dtype=torch_floatX(),
                           device=self.device).exponential_(
                               generator=self.generator)

    def poisson(self, lam):
        """Poisson counts ``(chains, dim)`` at the rates ``lam: (dim,)``."""
        rates = torch.broadcast_to(lam, (self.chains,) + tuple(lam.shape))
        return torch.poisson(rates.contiguous(), generator=self.generator)

    def randint(self, low, high, dim=None):
        """Integers in [low, high) (host bounds): ``(chains,)``, or
        ``(chains, dim)``."""
        return torch.randint(int(low), int(high), self._shape(dim),
                             generator=self.generator, device=self.device)

    def permutation(self, n):
        """One permutation of ``range(n)`` per chain, ``(chains, n)``."""
        return torch.argsort(self.uniform(n), dim=1)

    def minibatch(self, nodes):
        """One minibatch draw per chain for the views ``nodes``
        (``data.minibatch_noise``)."""
        from ..data import minibatch_noise
        return minibatch_noise(nodes, self.generator, self.chains)

    def depth(self, depth, n_take):
        """Uniforms of one NUTS doubling: direction ``(chains,)``, merge
        ``(chains,)``, and one per leaf for the proposal ``(n_take,
        chains)``."""
        u = torch.rand((2 + n_take, self.chains), generator=self.generator,
                       dtype=torch_floatX(), device=self.device)
        return u[0], u[1], u[2:]


class BlockedStep:
    """Base class of the steppers (cf. ``arraystep.py:59``).

    ``__new__`` splits an unblocked variable list into a ``CompoundStep`` of
    one-variable steppers, as the reference does.
    """

    generates_stats = False
    stats_dtypes: List[Dict[str, type]] = []
    name = "blocked"

    def __new__(cls, *args, **kwargs):
        blocked = kwargs.get("blocked")
        if blocked is None:
            # the class's own default
            blocked = getattr(cls, "default_blocked", True)
            kwargs["blocked"] = blocked

        if len(args) > 0:
            vars = args[0]
            args = args[1:]
        elif "vars" in kwargs:
            vars = kwargs.pop("vars")
        else:  # all model variables
            vars = None

        if vars is not None and not isinstance(vars, (tuple, list)):
            vars = [vars]

        if vars is not None and not blocked and len(vars) > 1:
            from .compound import CompoundStep
            _kwargs = dict(kwargs)
            _kwargs["blocked"] = True
            steps = []
            for var in vars:
                step = super().__new__(cls)
                step.__init__([var], *args, **_kwargs)
                steps.append(step)
            return CompoundStep(steps)
        step = super().__new__(cls)
        step._init_args = (vars,) + tuple(args)
        step._init_kwargs = kwargs
        return step

    def __init__(self, *args, **kwargs):
        pass

    def __getnewargs_ex__(self):
        # pickling support (cf. arraystep.py:107)
        return self._init_args, self._init_kwargs

    @staticmethod
    def competence(var, has_grad=False):
        return Competence.INCOMPATIBLE

    def stop_tuning(self):
        if hasattr(self, "tune"):
            self.tune = False

    # -- flat-vector plumbing ------------------------------------------------
    def _setup_vars(self, vars, model):
        """Resolve the stepper's variables and their indices into the model's
        flat vector."""
        self.model = model
        if vars is None:
            vars = model.cont_vars
        resolved = []
        for v in vars:
            v = model.named_vars.get(getattr(v, "name", v), v)
            # a user-facing transformed view stands for its FreeRV
            tr = getattr(v, "transformed", None)
            resolved.append(tr if tr is not None else v)
        self.vars = resolved
        self.ordering = ArrayOrdering(resolved)
        self.dim = self.ordering.size
        global_order = model.ordering
        idx = []
        for vm in self.ordering.vmap:
            g = global_order.by_name[vm.var]
            idx.extend(range(g.slc.start, g.slc.stop))
        self.q_indices = np.asarray(idx, dtype=np.int64)
        self._sub_idx = torch.as_tensor(self.q_indices, device=model.device)
        self.bij = DictToArrayBijection(self.ordering, model.test_point)
        # True when the stepper owns a strict subset of the flat vector: it
        # runs inside a CompoundStep, other steppers move q between its
        # calls, and a logp or gradient it cached is stale
        self.is_partial = self.dim != global_order.size

    def _refresh_logp(self, q, cached):
        """logp at the current point: our own cached value is stale whenever
        another stepper has moved ``q`` (cf. ``arraystep.py:147``)."""
        if self.is_partial:
            return self._logp_fn(q)
        return cached

    def _sub(self, q):
        """This stepper's columns of ``q``."""
        return q.index_select(1, self._sub_idx) if self.is_partial else q

    def _scatter(self, q, x):
        """``q`` with this stepper's columns replaced by ``x``."""
        return q.index_copy(1, self._sub_idx, x) if self.is_partial else x

    # -- kernel interface ----------------------------------------------------
    def kernel_init(self, q0):
        """Initial kernel state for the start points ``q0: (chains, n)``."""
        return ()

    def kernel_step(self, q, state, tctx: TuneContext, noise):
        raise NotImplementedError

    # -- host-side single-draw API (cf. arraystep.py:163) --------------------
    def step(self, point):
        """One transition from ``point`` on the model's device, as a batch
        of one chain; returns the new point (and the statistics)."""
        model = self.model
        device = model.device
        q = torch.as_tensor(model.dict_to_array(point), dtype=torch_floatX(),
                            device=device)[None]
        if getattr(self, "_host_state", None) is None:
            self._host_state = self.kernel_init(q)
            gen = torch.Generator(device=device)
            gen.manual_seed(int(np.random.randint(0, 2 ** 31 - 1)))
            self._host_noise = GeneratorNoise(gen, 1, device)
            self._host_i = 0
        tune = bool(getattr(self, "tune", True))
        q_new, self._host_state, stats = self.kernel_step(
            q, self._host_state, TuneContext(tune, self._host_i, 0),
            self._host_noise)
        self._host_i += 1
        new_point = model.array_to_dict(q_new[0].cpu().numpy())
        for k, v in point.items():
            if k not in new_point:
                new_point[k] = v
        if self.generates_stats:
            host_stats = {k: v[0].cpu().numpy().item()
                          for k, v in stats.items()}
            return new_point, [host_stats]
        return new_point

    def reset_tuning(self):
        self._host_state = None

    def __repr__(self):
        return f"{type(self).__name__}"


class ArrayStep(BlockedStep):
    """Stepper on its slice of the flat array (cf. ``arraystep.py:197``)."""


class ArrayStepShared(BlockedStep):
    """The reference's shared-variable fast path (``arraystep.py:201``);
    here every stepper already reads the model's constants on the device,
    so this is a name kept for API parity."""


class GradientSharedStep(ArrayStepShared):
    """Stepper owning the batched logp+grad function
    (cf. ``arraystep.py:207``). Over a subset of the flat vector it works on
    ``x = q[:, idx]``: :meth:`_value_and_grad_at` gives the function of
    ``x`` with the other coordinates held at ``q``'s values.

    ``logp_dlogp_func``, as in the JAX package, is the logp of one flat
    point of the model, which the stepper batches and differentiates (the
    model's own by default); ``dtype`` is accepted and unused, as there."""

    def __init__(self, vars, model=None, blocked=True, dtype=None,
                 logp_dlogp_func=None, **kwargs):
        model = modelcontext(model)
        self._setup_vars(vars, model)
        self.blocked = blocked
        self._logp_dlogp_fn = model.logp_dlogp_function() \
            if logp_dlogp_func is None \
            else batched_value_and_grad(logp_dlogp_func)

    def _value_and_grad_at(self, q):
        """``x -> (logp, dlogp/dx)`` over this stepper's columns, the rest
        of the point taken from ``q`` (cf. ``sub_logp``, nuts.py:463)."""
        if not self.is_partial:
            return self._logp_dlogp_fn
        idx = self._sub_idx

        def value_and_grad(x):
            logp, grad = self._logp_dlogp_fn(q.index_copy(1, idx, x))
            return logp, grad.index_select(1, idx)
        return value_and_grad


def metrop_select(mr, q, q0, u):
    """Accept ``q`` over ``q0`` where ``log(u) < mr``, per chain
    (cf. ``arraystep.py:223``). ``mr, u``: ``(chains,)``; returns
    ``(q_new, accepted)``."""
    accepted = torch.log(u) < mr
    return torch.where(accepted[:, None], q, q0), accepted
