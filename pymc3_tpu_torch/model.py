"""Model core: the DSL runtime (cf. ``pymc3_tpu/model.py``).

``Model`` is a context-managed registry of free, observed and deterministic
variables. Its factor list contracts into one function of the flat
unconstrained vector, ``logp_point(q)``, written for one point. The samplers
see two batched forms of it: :class:`ValueGradFunction`, which batches it
over chains with ``torch.func.vmap`` and differentiates the batch with
autograd, and ``make_logp_fn()``, the same batch without a gradient, for
the steppers that never use one.

Every model constant lives on ``Model(device=...)``; when that is not given,
on the configured device (``config.device``, the card by default).
"""
from __future__ import annotations

import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from .blocking import ArrayOrdering, DictToArrayBijection
from .config import default_device, floatX, torch_floatX
from .distributions.distribution import (
    BatchedPoint, _as_tensor, make_generator,
)
from .memoize import WithMemoization
from .node import Node, NamedNode, ConstantNode, apply, as_node, _ev
from .torchf import batched_value, batched_value_and_grad
from .util import get_transformed_name, get_var_name
from .vartypes import continuous_types, discrete_types

__all__ = ["Model", "modelcontext", "Point", "Deterministic", "Potential",
           "FreeRV", "ObservedRV", "TransformedRV", "DeterministicRV",
           "ValueGradFunction", "set_data"]

#: The environment key under which a minibatch draw reaches the model's
#: ``Minibatch`` views (``data.RNG_ENV_KEY``).
RNG_ENV_KEY = "__rng__"


class ContextMeta(type):
    """Thread-local context stack so `with model:` registers variables
    (cf. ``model.py:243``). Subclasses share one stack."""

    def __call__(cls, *args, **kwargs):
        instance = cls.__new__(cls, *args, **kwargs)
        with instance:
            instance.__init__(*args, **kwargs)
        return instance

    @property
    def context_class(cls):
        root = cls
        for base in cls.__mro__:
            if isinstance(base, ContextMeta):
                root = base
        return root

    def get_contexts(cls) -> List:
        root = cls.context_class
        if "_contexts" not in root.__dict__:
            root._contexts = threading.local()
        if not hasattr(root._contexts, "stack"):
            root._contexts.stack = []
        return root._contexts.stack

    def get_context(cls, error_if_none=True):
        stack = cls.get_contexts()
        if not stack:
            if error_if_none:
                raise TypeError(f"No {cls.__name__} on context stack")
            return None
        return stack[-1]


def modelcontext(model: Optional["Model"]) -> "Model":
    """The given model or the ambient context model (cf. ``model.py:356``)."""
    if model is None:
        model = Model.get_context(error_if_none=False)
        if model is None:
            raise TypeError("No model on context stack.")
    return model


def _get_scaling(total_size, shape, ndim):
    """The factor that scales a minibatch's logp up to ``total_size``
    (cf. ``model.py:102``): an int scales the leading axis, a list scales
    the axes it names (``None`` skips one, ``Ellipsis`` right-aligns the
    rest)."""
    if total_size is None:
        return 1.0
    if isinstance(total_size, int):
        denom = (shape[0] if shape else 1) if ndim >= 1 else 1
        return float(total_size) / max(int(denom), 1)
    if isinstance(total_size, (list, tuple)):
        if not all(isinstance(i, int) or i is Ellipsis or i is None
                   for i in total_size):
            raise TypeError(f"Unrecognized `total_size` type: {total_size}")
        if Ellipsis in total_size:
            sep = total_size.index(Ellipsis)
            begin, end = total_size[:sep], total_size[sep + 1:]
            if len(begin) + len(end) > ndim:
                raise ValueError("Length of total_size > ndim")
        else:
            begin, end = list(total_size), []
        coef = 1.0
        for i, t in enumerate(begin):
            if t is not None:
                coef *= float(t) / max(int(shape[i]), 1)
        for i, t in enumerate(reversed(end)):
            if t is not None:
                coef *= float(t) / max(int(shape[ndim - 1 - i]), 1)
        return coef
    raise TypeError(f"Unrecognized `total_size` type: {total_size}")


#: The environment key under which ``_env_from_q`` records the flat point
#: and, for each scalar variable, ``(index in it, value)``.
SCALARS_ENV_KEY = "__scalars__"


def _scalar(v):
    """``v`` as a 0-d tensor, with no op where it is one already."""
    return v if v.dim() == 0 else v.reshape(())


def stack_scalars(nodes, env, memo):
    """The values of ``nodes``, each of one element, stacked into a vector.
    Where they are consecutive scalar variables of the flat point (a GLM's
    coefficients), the vector is a slice of it: one op forward and one
    backward, where a stack costs one a variable both ways and each
    variable's own slice of the point a zero-filled gradient of all of it
    and an add."""
    q, scalars = env.get(SCALARS_ENV_KEY, (None, {}))
    head = scalars.get(getattr(nodes[0], "name", None))
    if head is not None and all(
            scalars.get(n.name, (None,))[0] == head[0] + i
            and env.get(n.name) is scalars[n.name][1]
            for i, n in enumerate(nodes)):
        return q[head[0]:head[0] + len(nodes)]
    return torch.stack([_scalar(_ev(n, env, memo)) for n in nodes])


class ScalarStack(Node):
    """A node for :func:`stack_scalars` of ``nodes``."""

    def __init__(self, nodes):
        self.nodes = list(nodes)
        self._test_value = np.stack([np.asarray(n.test_value).reshape(())
                                     for n in self.nodes])

    def _eval(self, env, memo):
        return stack_scalars(self.nodes, env, memo)


class FreeRV(NamedNode):
    """Unobserved random variable in *unconstrained* space
    (cf. ``model.py:1420``). For transformed distributions this is the
    ``name_{transform}__`` variable the samplers see; its shape is the
    transform's ``forward_shape`` of the distribution's (one less on the
    last axis for the simplex transforms). ``total_size`` scales its logp
    term as for a minibatch."""

    def __init__(self, name, distribution, model, transform=None,
                 orig_name=None, total_size=None):
        self.name = name
        self.distribution = distribution
        self.model = model
        self.transform = transform
        self.orig_name = orig_name or name
        shape = tuple(distribution.shape)
        testval = distribution.default()
        if transform is not None:
            shape = tuple(transform.forward_shape(shape))
            testval = transform.forward_val(floatX(testval))
        self.unconstrained_shape = shape
        self._test_value = floatX(np.broadcast_to(testval, shape))
        self._default = torch.as_tensor(self._test_value, device=model.device)
        self.scaling = _get_scaling(total_size, tuple(distribution.shape),
                                    len(distribution.shape))

    @property
    def dtype(self):
        return np.dtype(floatX())

    def _eval_default(self, env, memo):
        return self._default

    def logp_env(self, env, memo, jacobian=True):
        """Summed logp term, with the transform's jacobian unless
        ``jacobian`` is false, times ``scaling``."""
        z = _ev(self, env, memo)
        if self.transform is not None:
            x = self.transform.backward(z, env, memo)
            lp = torch.sum(self.distribution.logp(x, env, memo))
            if jacobian:
                lp = lp + torch.sum(self.transform.jacobian_det(z, env, memo))
        else:
            lp = torch.sum(self.distribution.logp(z, env, memo))
        return lp if self.scaling == 1.0 else self.scaling * lp


class TransformedRV(NamedNode):
    """User-facing view of a transformed FreeRV: ``x = backward(x_log__)``
    (cf. ``model.py:1707``)."""

    def __init__(self, name, distribution, transform, transformed_rv, model):
        self.name = name
        self.distribution = distribution
        self.transform = transform
        self.transformed = transformed_rv
        self.transformed_name = transformed_rv.name
        self.model = model
        self._test_value = floatX(
            transform.backward_val(transformed_rv.test_value))

    @property
    def dtype(self):
        return np.dtype(floatX())

    def _eval_default(self, env, memo):
        return self.transform.backward(_ev(self.transformed, env, memo),
                                       env, memo)


class ObservedRV(NamedNode):
    """Observed variable (cf. ``model.py:1534``). Constant data lives on the
    model's device; data given as a node (``Data``, ``Minibatch``) is
    evaluated at every logp, so it reads the container's current value or
    the minibatch the environment selects. ``total_size`` scales the term
    from the data's rows to the full data set's."""

    def __init__(self, name, data, distribution, model, total_size=None):
        self.name = name
        self.distribution = distribution
        self.model = model
        self.data_node = None
        if isinstance(data, Node) and not isinstance(data, ConstantNode):
            self.data_node = data
        data = np.asarray(data.test_value if isinstance(data, Node) else data)
        if data.dtype.kind == "f":
            data = floatX(data)
        self.data = data
        self._test_value = data
        self._data = torch.as_tensor(data, device=model.device)
        if not distribution.shape and data.ndim > 0:
            distribution.shape = tuple(data.shape)
        self.scaling = _get_scaling(total_size, data.shape, data.ndim)

    @property
    def dtype(self):
        return self.data.dtype

    def _eval_default(self, env, memo):
        if self.data_node is not None:
            return _ev(self.data_node, env, memo)
        return self._data

    def logp_env(self, env, memo, jacobian=True):
        lp = torch.sum(self.distribution.logp(self._eval_default(env, memo),
                                              env, memo))
        return lp if self.scaling == 1.0 else self.scaling * lp

    def refresh_shape(self):
        """Follow a ``Data`` container's current shape, for forward draws
        after ``set_data`` (cf. ``model.py:960``)."""
        if self.data_node is not None and hasattr(self.data_node,
                                                  "set_value"):
            self.distribution.shape = tuple(np.shape(
                self.data_node.test_value))


class DeterministicRV(NamedNode):
    """A named deterministic quantity (cf. ``model.py:1667``)."""

    def __init__(self, name, expr, model):
        self.name = name
        self.expr = as_node(expr)
        self.model = model
        self._test_value = np.asarray(self.expr.test_value)

    def _eval_default(self, env, memo):
        return _ev(self.expr, env, memo)


class Model(WithMemoization, metaclass=ContextMeta):
    """The variables and likelihood factors of a model (cf. ``model.py:716``).

    ``device``: where every constant of the model lives and where its logp
    runs. When not given, a sub-model takes its parent's and any other model
    the configured one (``set_config(device=...)``, "cuda" by default);
    without a CUDA device that raises instead of building on the CPU.
    """

    def __new__(cls, *args, **kwargs):
        instance = object.__new__(cls)
        instance._parent = kwargs.get("model") or cls.get_context(
            error_if_none=False)
        return instance

    def __init__(self, name="", model=None, device=None):
        self.name = name
        if device is None:
            device = (self.parent.device if self.parent is not None
                      else default_device())
        self.device = torch.device(device)
        if self.parent is not None:
            self.named_vars = self.parent.named_vars
            self.free_RVs = self.parent.free_RVs
            self.observed_RVs = self.parent.observed_RVs
            self.deterministics = self.parent.deterministics
            self.potentials = self.parent.potentials
            self._factor_order = self.parent._factor_order
        else:
            self.named_vars: Dict[str, Node] = {}
            self.free_RVs: List[FreeRV] = []
            self.observed_RVs: List[ObservedRV] = []
            self.deterministics: List[DeterministicRV] = []
            self.potentials: List[Node] = []
            self._factor_order: List = []  # declaration-ordered factors

    @property
    def parent(self):
        return self._parent

    def __enter__(self):
        type(self).get_contexts().append(self)
        return self

    def __exit__(self, typ, value, traceback):
        type(self).get_contexts().pop()

    # -- naming -------------------------------------------------------------
    @property
    def prefix(self):
        return f"{self.name}_" if self.name else ""

    def name_for(self, name):
        if self.prefix and not name.startswith(self.prefix):
            return f"{self.prefix}{name}"
        return name

    def __getitem__(self, key):
        try:
            return self.named_vars[key]
        except KeyError:
            return self.named_vars[self.name_for(key)]

    def __contains__(self, key):
        return key in self.named_vars or self.name_for(key) in self.named_vars

    # -- registration -------------------------------------------------------
    def Var(self, name, dist, data=None, total_size=None):
        """Create and register a variable (cf. ``model.py:975``)."""
        name = self.name_for(name)
        if name in self.named_vars:
            raise ValueError(f"Variable name {name} already exists.")
        if data is not None:
            var = ObservedRV(name, data, dist, self, total_size=total_size)
            self.add_named_variable(var)
            self.observed_RVs.append(var)
            self._factor_order.append(var)
            return var
        transform = getattr(dist, "transform", None)
        if transform is None:
            var = FreeRV(name, dist, self, total_size=total_size)
            self.add_named_variable(var)
            self.free_RVs.append(var)
            self._factor_order.append(var)
            return var
        zname = get_transformed_name(name, transform)
        if zname in self.named_vars:
            raise ValueError(f"Variable name {zname} already exists.")
        zvar = FreeRV(zname, dist, self, transform=transform, orig_name=name,
                      total_size=total_size)
        self.add_named_variable(zvar)
        self.free_RVs.append(zvar)
        self._factor_order.append(zvar)
        var = TransformedRV(name, dist, transform, zvar, self)
        self.add_named_variable(var)
        zvar.view_rv = var
        return var

    def add_named_variable(self, var):
        if var.name in self.named_vars:
            raise ValueError(f"Variable name {var.name} already exists.")
        self.named_vars[var.name] = var

    # -- variable views -----------------------------------------------------
    @property
    def vars(self):
        """Sampling-space (unconstrained) free variables."""
        return list(self.free_RVs)

    @property
    def unobserved_RVs(self):
        """Untransformed views, raw free RVs, and deterministics."""
        out = [rv.view_rv for rv in self.free_RVs
               if getattr(rv, "view_rv", None) is not None]
        out.extend(self.free_RVs)
        out.extend(self.deterministics)
        return out

    @property
    def cont_vars(self):
        return [v for v in self.free_RVs
                if str(v.distribution.dtype) in continuous_types]

    @property
    def disc_vars(self):
        return [v for v in self.free_RVs
                if str(v.distribution.dtype) in discrete_types]

    @property
    def test_point(self) -> Dict[str, np.ndarray]:
        """Test point in unconstrained space (cf. ``model.py:946``)."""
        return {v.name: v.test_value for v in self.free_RVs}

    @property
    def ndim(self):
        return sum(int(np.prod(v.unconstrained_shape, dtype=int))
                   for v in self.free_RVs)

    @property
    def ordering(self) -> ArrayOrdering:
        return ArrayOrdering(self.free_RVs)

    @property
    def bijection(self) -> DictToArrayBijection:
        return DictToArrayBijection(self.ordering, self.test_point)

    def dict_to_array(self, point) -> np.ndarray:
        return floatX(self.bijection.map(point))

    def array_to_dict(self, q) -> Dict[str, np.ndarray]:
        return self.bijection.rmap(q)

    # -- logp construction --------------------------------------------------
    def _env_from_q(self, q, ordering=None):
        """Decode one flat unconstrained point into an env holding both the
        transformed and the constrained values. A caller that decodes many
        points passes the ``ordering`` it computed once. Scalar variables
        are recorded under ``SCALARS_ENV_KEY`` for :func:`stack_scalars`."""
        env, scalars = {}, {}
        for vm in (self.ordering if ordering is None else ordering).vmap:
            if vm.shp == ():
                v = env[vm.var] = q[vm.slc.start]
                scalars[vm.var] = (vm.slc.start, v)
            else:
                env[vm.var] = q[vm.slc].reshape(vm.shp)
        if scalars:
            env[SCALARS_ENV_KEY] = (q, scalars)
        self._decode_transformed(env)
        return env

    def _decode_transformed(self, env):
        """Add the constrained value of every transformed variable whose
        unconstrained value is in ``env``, in declaration order, so that a
        bound's parents are decoded before it (cf. ``model.py:574-583``).
        Each decode evaluates its bounds afresh (no shared memo): they may
        read variables decoded just before."""
        for rv in self.free_RVs:
            if rv.transform is not None and rv.name in env \
                    and rv.orig_name not in env:
                env[rv.orig_name] = rv.transform.backward(env[rv.name], env,
                                                          {})
        return env

    def _logp_plan(self):
        """The factors in declaration order, with every set of scalar free
        variables that share one untransformed univariate distribution
        object (a GLM's coefficients share their default prior) as one
        ``(distribution, [rv, ...])`` entry at its first member's place:
        its logp is one call on the stacked values instead of one call a
        variable. Made again when factors are added."""
        n = len(self._factor_order)
        if getattr(self, "_plan", (None,))[0] == n:
            return self._plan[1]
        univariate = ("continuous", "discrete")
        members = {}
        for f in self._factor_order:
            d = getattr(f, "distribution", None)
            if type(f) is FreeRV and f.transform is None \
                    and f.scaling == 1.0 and tuple(d.shape) == () \
                    and type(d).__module__.rsplit(".", 1)[-1] in univariate:
                members.setdefault(id(d), []).append(f)
        plan, placed = [], set()
        for f in self._factor_order:
            group = members.get(id(getattr(f, "distribution", None)))
            if group is None or len(group) < 2 or f not in group:
                plan.append(f)
            elif id(f.distribution) not in placed:
                placed.add(id(f.distribution))
                plan.append((f.distribution, group))
        self._plan = (n, plan)
        return plan

    def logp_from_env(self, env, memo=None, jacobian=True):
        """Total logp given an env of free-RV values; without the
        transforms' jacobians when ``jacobian`` is false."""
        memo = {} if memo is None else memo
        terms = []
        for item in self._logp_plan():
            if isinstance(item, tuple):
                dist, rvs = item
                values = stack_scalars(rvs, env, memo)
                terms.append(torch.sum(dist.logp(values, env, memo)))
            else:
                terms.append(item.logp_env(env, memo, jacobian))
        terms += [torch.sum(_ev(pot, env, memo)) for pot in self.potentials]
        return sum(terms[1:], terms[0])

    def logp_point(self, q, ordering=None, jacobian=True, draw=None):
        """Scalar logp of one flat point ``q: (n,)`` (cf. model.py:574-599).
        ``draw`` is one minibatch draw (``data.minibatch_noise``), handed to
        the model's ``Minibatch`` views through the environment."""
        env = self._env_from_q(q, ordering)
        if draw is not None:
            env[RNG_ENV_KEY] = draw
        return self.logp_from_env(env, jacobian=jacobian)

    def logp_point_fn(self, jacobian=True):
        """``(q: (n,), draw=None) -> logp``, written for one point: the
        analog of the JAX package's ``make_logp_fn(with_rng=True)``
        (``model.py:601``). Callers batch it with ``torch.func.vmap``."""
        ordering = self.ordering

        def logp(q, draw=None):
            return self.logp_point(q, ordering, jacobian, draw)
        return logp

    def logp_dlogp_function(self):
        """cf. ``model.py:885`` — returns a :class:`ValueGradFunction`."""
        return ValueGradFunction(self)

    def make_logp_fn(self):
        """Batched logp without a gradient, ``q: (chains, n) -> (chains,)``
        (cf. ``make_logp_fn``, ``model.py:601``, which is for one point and
        is vmapped by its callers). Discrete values ride in ``q`` as
        floats."""
        ordering = self.ordering
        return batched_value(lambda q: self.logp_point(q, ordering))

    def varlogpt_point(self, q, ordering=None):
        """logp of the free variables alone, transforms' jacobians included,
        at one flat point: the prior term of SMC (cf. ``varlogpt_fn``,
        ``model.py:631``)."""
        env = self._env_from_q(q, ordering)
        memo = {}
        return sum((rv.logp_env(env, memo) for rv in self.free_RVs),
                   torch.zeros((), dtype=q.dtype, device=q.device))

    def datalogpt_point(self, q, ordering=None):
        """logp of the observed terms and the potentials alone at one flat
        point: the likelihood term of SMC and of an elliptical slice
        sampler."""
        env = self._env_from_q(q, ordering)
        memo = {}
        terms = [obs.logp_env(env, memo) for obs in self.observed_RVs]
        terms += [torch.sum(_ev(pot, env, memo)) for pot in self.potentials]
        return sum(terms, torch.zeros((), dtype=q.dtype, device=q.device))

    def varlogpt_fn(self):
        """Batched :meth:`varlogpt_point`, ``q: (chains, n) -> (chains,)``
        (cf. ``varlogpt_fn``, ``model.py:631``, which is for one point and
        is vmapped by its callers)."""
        ordering = self.ordering
        return batched_value(lambda q: self.varlogpt_point(q, ordering))

    def datalogpt_fn(self):
        """Batched :meth:`datalogpt_point`, ``q: (chains, n) -> (chains,)``
        (cf. ``datalogpt_fn``, ``model.py:642``)."""
        ordering = self.ordering
        return batched_value(lambda q: self.datalogpt_point(q, ordering))

    # -- symbolic logp nodes (cf. model.py:657-711) ----------------------------
    def _logp_node(self, fn_from_env, name):
        """An env -> scalar contraction as a node whose inputs are the free
        variables, so ``gradient(model.logpt)`` differentiates through it."""
        rvs = list(self.free_RVs)

        def run(*vals):
            env = {rv.name: v for rv, v in zip(rvs, vals)}
            return fn_from_env(self._decode_transformed(env))

        out = apply(run, *rvs)
        out.name = name
        return out

    @property
    def logpt(self):
        """The joint logp node, jacobians included (``model.py:676``)."""
        return self._logp_node(self.logp_from_env, "__logp")

    @property
    def logp_nojact(self):
        """The joint logp node without jacobians (``model.py:682``)."""
        return self._logp_node(
            lambda env: self.logp_from_env(env, jacobian=False),
            "__logp_nojac")

    def _terms(self, env, factors, potentials):
        memo = {}
        terms = [f.logp_env(env, memo) for f in factors]
        terms += [torch.sum(_ev(pot, env, memo)) for pot in potentials]
        return sum(terms[1:], terms[0]) if terms else \
            torch.zeros((), device=self.device)

    @property
    def varlogpt(self):
        """The free variables' logp node (``model.py:689``)."""
        return self._logp_node(
            lambda env: self._terms(env, self.free_RVs, []), "__varlogp")

    @property
    def datalogpt(self):
        """The observed terms' and potentials' logp node
        (``model.py:700``)."""
        return self._logp_node(
            lambda env: self._terms(env, self.observed_RVs, self.potentials),
            "__datalogp")

    # -- host-side conveniences ---------------------------------------------
    def _point_to_env(self, point):
        env = {k: torch.as_tensor(np.asarray(v), device=self.device)
               for k, v in point.items()}
        return self._decode_transformed(env)

    def logp(self, point=None):
        """Host-side total logp at a Point (transformed-space names)."""
        point = point if point is not None else self.test_point
        return float(self.logp_from_env(self._point_to_env(point)))

    def logp_nojac(self, point=None):
        """Host-side logp without the transforms' jacobians."""
        point = point if point is not None else self.test_point
        return float(self.logp_from_env(self._point_to_env(point),
                                        jacobian=False))

    def set_data(self, name, values):
        """Replace a ``Data`` container's value (cf. ``model.py:973``)."""
        node = self[name]
        if not hasattr(node, "set_value") or not hasattr(node, "version"):
            raise TypeError(
                f"The variable `{name}` must be defined as `pymc3.Data` "
                "inside the model to allow updating.")
        node.set_value(values)

    def check_test_point(self, test_point=None):
        """Per-factor logp at the test point (cf. ``model.py:1199``)."""
        env = self._point_to_env(test_point or self.test_point)
        memo = {}
        return {f.name: float(f.logp_env(env, memo))
                for f in self._factor_order}

    def makefn(self, outs):
        """A Point -> numpy values function (cf. ``model.py:1081``)."""
        single = not isinstance(outs, (list, tuple))
        outs_list = [outs] if single else list(outs)

        def f(point):
            env = self._point_to_env(point)
            memo = {}
            vals = [_ev(as_node(o), env, memo).detach().cpu().numpy()
                    for o in outs_list]
            return vals[0] if single else vals
        return f

    # -- forward (predictive) sampling ---------------------------------------
    # Draws come from an explicit ``torch.Generator`` on the model's device
    # and stay there: these methods return tensors.
    def _generator(self, gen):
        return gen if gen is not None else make_generator(self.device)

    def draw_point(self, point=None, gen=None):
        """One forward draw of every variable in declaration order, given
        the values already in ``point`` (cf. ``model.py:818``)."""
        gen = self._generator(gen)
        point = {k: _as_tensor(v, self.device)
                 for k, v in (point or {}).items()}
        for factor in self._factor_order:
            orig = getattr(factor, "orig_name", factor.name)
            if orig in point or factor.name in point:
                continue
            val = factor.distribution.random(point=point, gen=gen)
            point[orig] = val
            if isinstance(factor, FreeRV) and factor.transform is not None:
                point[factor.name] = factor.transform.forward(val, point, {})
        memo = {}
        for det in self.deterministics:
            if det.name not in point:
                point[det.name] = _ev(det, point, memo)
        return point

    def _batched_random(self, dist, point, size, gen):
        """Draws of ``size + dist.shape`` at a batched point, in one
        vectorized call: a shape that cannot be drawn so raises."""
        expect = tuple(size) + tuple(dist.shape)
        out = dist.random(point=point, size=size, gen=gen)
        if tuple(out.shape) != expect:
            out = torch.broadcast_to(out, expect).contiguous()
        return out

    def _vmap_eval(self, nodes, point):
        """Named nodes evaluated at every sample of a batched point."""
        def evaluate_all(env):
            memo = {}
            return [_ev(n, env, memo) for n in nodes]
        return {n.name: v.contiguous()
                for n, v in zip(nodes, point.vmap(evaluate_all))}

    @staticmethod
    def _add_transformed(point, rv, forward):
        """Add a transformed variable's value in its other space at every
        sample: unconstrained from constrained (``forward``), or back."""
        src, dst = (rv.orig_name, rv.name) if forward else \
            (rv.name, rv.orig_name)
        fn = rv.transform.forward if forward else rv.transform.backward
        point.add(dst, point.vmap(lambda env: [fn(env[src], env, {})])[0])

    def sample_forward(self, samples, point=None, gen=None, observed=True):
        """Prior (predictive) draws ``{name: (samples, *shape)}`` of every
        variable in declaration order, then the deterministics
        (cf. ``model.py:863``). Entries of ``point`` whose leading axis is
        ``samples`` long are per-sample values; the others are shared. With
        ``observed=False`` the observed variables are not drawn (a
        deterministic that reads one reads its data)."""
        gen = self._generator(gen)
        for obs in self.observed_RVs:
            obs.refresh_shape()
        vals = {k: _as_tensor(v, self.device)
                for k, v in (point or {}).items()}
        batched = {k for k, v in vals.items()
                   if v.ndim and v.shape[0] == samples}
        bp = BatchedPoint(vals, batched, samples)
        for factor in self._factor_order:
            orig = getattr(factor, "orig_name", factor.name)
            if orig in bp or factor.name in bp or (
                    not observed and isinstance(factor, ObservedRV)):
                continue
            bp.add(orig, self._batched_random(factor.distribution, bp,
                                              (samples,), gen))
            if isinstance(factor, FreeRV) and factor.transform is not None:
                self._add_transformed(bp, factor, forward=True)
        if self.deterministics:
            bp.update(self._vmap_eval(self.deterministics, bp))
        return dict(bp)

    def sample_forward_conditional(self, points, idx, vars, size=None,
                                   gen=None):
        """Posterior predictive: ``vars`` drawn forward at the trace points
        ``idx`` (cf. ``model.py:912``). ``points`` is the trace as stacked
        arrays ``{name: (n_points, *shape)}``. Returns
        ``{name: (len(idx), *shape)}``, or ``(len(idx), size, *shape)`` for
        observed variables when ``size`` is given."""
        gen = self._generator(gen)
        for obs in self.observed_RVs:
            obs.refresh_shape()
        idx = np.asarray(idx)
        n = int(idx.shape[0])
        bp = BatchedPoint({}, (), n)
        for k, v in points.items():
            if isinstance(v, torch.Tensor):
                v = v[torch.as_tensor(idx, device=v.device)]
            else:
                v = np.asarray(v)[idx]
            bp.add(k, _as_tensor(v, self.device))
        # constrained views of transformed values, parents first
        for rv in self.free_RVs:
            if rv.transform is not None and rv.name in bp \
                    and rv.orig_name not in bp:
                self._add_transformed(bp, rv, forward=False)
        obs_size = (n,) if size is None else (n, int(size))
        out = {}
        dets = []
        for var in vars:
            var = self.named_vars.get(getattr(var, "name", var), var)
            if isinstance(var, ObservedRV):
                out[var.name] = self._batched_random(var.distribution, bp,
                                                     obs_size, gen)
            elif isinstance(var, DeterministicRV):
                dets.append(var)
            elif isinstance(var, (FreeRV, TransformedRV)):
                out[var.name] = bp[var.name] if var.name in bp else \
                    self._batched_random(var.distribution, bp, (n,), gen)
            else:
                raise ValueError(f"cannot draw {var!r} forward: not a "
                                 "random variable or deterministic")
        if dets:
            out.update(self._vmap_eval(dets, bp))
        return out

    def __str__(self):
        return f"Model({self.name or 'unnamed'}: {len(self.free_RVs)} free, " \
               f"{len(self.observed_RVs)} observed, on {self.device})"

    __repr__ = __str__


def all_continuous(vars) -> bool:
    return all(str(np.dtype(v.distribution.dtype)) in continuous_types
               for v in vars if hasattr(v, "distribution"))


def Point(*args, model=None, **kwargs) -> Dict[str, np.ndarray]:
    """Build a point dict (cf. ``model.py:1331``)."""
    modelcontext(model)
    return {get_var_name(k): np.asarray(v)
            for k, v in dict(*args, **kwargs).items()}


def Deterministic(name, var, model=None):
    """Register a named deterministic (cf. ``model.py:1667``)."""
    model = modelcontext(model)
    det = DeterministicRV(model.name_for(name), var, model)
    model.add_named_variable(det)
    model.deterministics.append(det)
    return det


def Potential(name, var, model=None):
    """Add an arbitrary factor to the joint logp (cf. ``model.py:1688``)."""
    model = modelcontext(model)
    node = as_node(var, name=model.name_for(name))
    model.potentials.append(node)
    model.named_vars.setdefault(model.name_for(name), node)
    return node


def set_data(new_data: Dict, model=None):
    """Replace the values of ``Data`` containers by name
    (cf. ``model.py:1031``)."""
    model = modelcontext(model)
    for name, values in new_data.items():
        model.set_data(name, values)


class ValueGradFunction:
    """Batched ``q: (chains, n) -> (logp (chains,), dlogp (chains, n))``
    (cf. ``model.py:1052``).

    The model's logp is written for one point; ``torch.func.vmap`` carries
    the chain dimension through every op (see ``torchf``), and a
    hand-written kernel on the path (the GP covariance) receives the whole
    chain batch in one launch through its ``vmap`` rule.
    """

    def __init__(self, model):
        self.model = model
        self.ordering = model.ordering
        self.size = self.ordering.size
        self.dtype = torch_floatX()
        self._vag = batched_value_and_grad(
            lambda q: model.logp_point(q, self.ordering))

    def __call__(self, q):
        if q.ndim != 2 or q.shape[1] != self.size:
            raise ValueError(f"expected q of shape (chains, {self.size}), "
                             f"got {tuple(q.shape)}")
        return self._vag(q)
