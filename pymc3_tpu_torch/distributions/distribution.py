"""Distribution base machinery (cf. ``pymc3_tpu/distributions/distribution.py``).

``Distribution.__new__`` registers into the ambient model; ``.dist(...)``
builds an unregistered instance. Log-densities are tensor functions of the
value and the parameters; parameters are symbolic nodes resolved against the
evaluation environment, so the joint logp is one function of the flat point.
``dist.logp(node)`` and ``dist.logcdf(node)`` on a symbolic value return a
node, as in the JAX package.

Forward sampling. The JAX package draws on the host from numpy's global
generator. Here every draw comes from a ``torch.Generator`` that is passed
down explicitly (``gen``) and lives on the model's device, and draws stay
on the device:

- ``draw_values`` evaluates parameter nodes against a point. A
  :class:`BatchedPoint` carries a leading axis of ``n`` samples on some of
  its entries (the prior draws so far, or the posterior points); the
  parameters are then evaluated once per sample under ``torch.func.vmap``
  and come back with that leading axis ("lead");
- ``generate_samples`` lines each parameter up with the output shape
  ``size + core`` (the lead under ``size``'s first axis, the parameter's
  own shape right-aligned with the core) and hands them to a sampler
  ``sampler(gen, shape, *params)`` that returns a tensor of that shape.

A shape that cannot be drawn this way raises; nothing falls back to a
per-sample loop or to the host. The one host path is a user's own numpy
sampler (``generate_samples`` called without ``gen``, as in a PyMC3
``DensityDist``'s ``random``): its draws are copied to the device once.

A distribution's public ``random()`` answers as the JAX package's does: it
copies its draws to the host once and returns a numpy array of the JAX
package's dtype for that family. The port's own callers (the model's
forward draws, ``Bound``, ``Mixture``, ``LKJCholeskyCov``) keep the tensors
on the device through ``_random()``.
"""
from __future__ import annotations

import contextvars
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import floatX, intX, torch_floatX
from ..node import Node, evaluate, _ev, _to_numpy, current_device
from .shape_utils import to_tuple

__all__ = [
    "DensityDist", "Distribution", "Continuous", "Discrete", "NoDistribution",
    "TensorType", "draw_values", "generate_samples", "TransformedDistribution",
    "BatchedPoint", "point_lead", "make_generator",
]

#: Set while posterior predictive draws are made in one vectorized call
#: (cf. ``distribution.py:35``); the port's draws always are.
vectorized_ppc = contextvars.ContextVar("vectorized_ppc", default=None)


def TensorType(dtype, shape, broadcastable=None):
    """A ``(numpy dtype, shape)`` spec, Theano's ``TensorType`` stand-in
    (cf. ``distribution.py:45``); ``broadcastable`` is accepted and unused,
    as in the JAX package."""
    return (np.dtype(dtype), tuple(shape))


def _as_tensor(x, device):
    """A point value or constant as a tensor on ``device``; float64 data
    becomes ``floatX``."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        arr = floatX(arr)
    return torch.as_tensor(arr, device=device)


class _DistMethodNode(Node):
    """Symbolic ``dist.logp(value_node)`` / ``logcdf``: evaluating it
    resolves both the value and the distribution's parameters
    (cf. ``distribution.py:50``)."""

    def __init__(self, dist, value, method):
        self.dist = dist
        self.value = value
        self.method = method
        self.name = None
        self._test_value = _to_numpy(
            getattr(dist, method)(value.test_value, {}, {}))

    def _eval(self, env, memo):
        return getattr(self.dist, self.method)(_ev(self.value, env, memo),
                                               env, memo)


class BatchedPoint(dict):
    """A point whose entries named in ``batched`` carry a leading axis of
    ``n`` samples; the other entries are shared by all samples."""

    def __init__(self, values, batched, n):
        super().__init__(values)
        self.batched = set(batched)
        self.n = int(n)

    def add(self, name, value):
        """Set a batched entry."""
        self[name] = value
        self.batched.add(name)

    def vmap(self, fn):
        """``fn(env)`` for every sample, with one leading axis of ``n`` on
        each tensor it returns (shared results are broadcast)."""
        batched = {k: self[k] for k in self.batched}
        static = {k: v for k, v in self.items() if k not in self.batched}
        if not batched:
            out = fn(dict(static))
            return [torch.broadcast_to(o, (self.n,) + tuple(o.shape))
                    for o in out]

        def one(benv):
            env = dict(static)
            env.update(benv)
            return fn(env)
        return torch.func.vmap(one)(batched)


def make_generator(device, seed=None):
    """A ``torch.Generator`` on ``device``, seeded with ``seed`` or, when
    it is None, from the operating system."""
    gen = torch.Generator(device=device)
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


def point_lead(point):
    """How many leading sample axes the parameters drawn at ``point``
    carry: 1 for a batched point, else 0."""
    return 1 if isinstance(point, BatchedPoint) and point.batched else 0


class Distribution:
    """Statistical distribution base (cf. ``distribution.py:72``)."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        # dist.logp(node) -> node; numpy values -> tensors on the device
        for method in ("logp", "logcdf"):
            raw = cls.__dict__.get(method)
            if raw is None:
                continue

            def wrapped(self, value, env=None, memo=None, _raw=raw,
                        _name=method):
                if isinstance(value, Node):
                    if env is None:
                        return _DistMethodNode(self, value, _name)
                    value = _ev(value, env, {} if memo is None else memo)
                if not isinstance(value, torch.Tensor):
                    value = _as_tensor(value, self.device)
                return _raw(self, value, env, memo)

            wrapped.__name__ = method
            wrapped.__doc__ = raw.__doc__
            setattr(cls, method, wrapped)

    def __new__(cls, name, *args, **kwargs):
        from ..model import Model
        model = Model.get_context(error_if_none=False)
        if model is None:
            raise TypeError(
                "No model on context stack, which is needed to instantiate "
                "distributions. Add variable inside a 'with model:' block, or "
                "use the '.dist' syntax for a standalone distribution.")
        if not isinstance(name, str):
            raise TypeError(f"Name needs to be a string but got: {name}")
        data = kwargs.pop("observed", None)
        if isinstance(data, Distribution):
            raise TypeError("An observed variable cannot be a distribution "
                            "instance.")
        total_size = kwargs.pop("total_size", None)
        dims = kwargs.pop("dims", None)
        dist = cls.dist(*args, **kwargs)
        return model.Var(name, dist, data=data, total_size=total_size,
                         dims=dims)

    @classmethod
    def dist(cls, *args, **kwargs):
        dist = object.__new__(cls)
        dist.__init__(*args, **kwargs)
        return dist

    def __init__(self, shape=(), dtype=None, testval=None, defaults=(),
                 transform=None, broadcastable=None):
        # broadcastable: accepted and unused, as in the JAX package
        self.shape = to_tuple(shape)
        self.dtype = np.dtype(dtype if dtype is not None else floatX())
        self.testval = testval
        self.defaults = tuple(defaults)
        self.transform = transform
        self.device = current_device()

    def _infer_shape(self, shape, *param_nodes):
        """shape kwarg wins; else broadcast of parameter test shapes."""
        if shape is not None:
            return to_tuple(shape)
        shapes = [tuple(np.shape(p.test_value)) for p in param_nodes
                  if p is not None]
        return tuple(np.broadcast_shapes(*shapes)) if shapes else ()

    def param_nodes(self) -> Dict[str, Node]:
        """Named symbolic parameters of this distribution."""
        return {k: v for k, v in self.__dict__.items() if isinstance(v, Node)}

    def _ev_params(self, names, env, memo):
        env = env or {}
        memo = {} if memo is None else memo
        return [evaluate(getattr(self, n), env, memo) for n in names]

    # -- densities -----------------------------------------------------------
    def logp(self, value, env: Optional[Dict] = None,
             memo: Optional[Dict] = None):
        """Elementwise log-density at ``value`` (a tensor)."""
        raise NotImplementedError

    def logp_sum(self, value, env=None, memo=None):
        """Summed log-density (cf. ``distribution.py:160``)."""
        out = self.logp(value, env, memo)
        if isinstance(out, Node):
            from ..node import apply
            return apply(torch.sum, out)
        return torch.sum(out)

    def logp_nojac(self, value, env=None, memo=None):
        """logp without a transform jacobian: jacobians are added by the
        model, so this is ``logp`` (cf. ``distribution.py:168``)."""
        return self.logp(value, env, memo)

    def logcdf(self, value, env=None, memo=None):
        raise NotImplementedError(
            f"logcdf not implemented for {type(self).__name__}")

    # -- testval machinery (cf. distribution.py:179-200) ---------------------
    def default(self):
        return np.asarray(self.get_test_val(self.testval, self.defaults),
                          dtype=self.dtype)

    def get_test_val(self, val, defaults):
        if val is None:
            for v in defaults:
                attr = getattr(self, v, None)
                if attr is not None and np.all(np.isfinite(
                        self.getattr_value(attr))):
                    return self.getattr_value(attr)
            raise AttributeError(
                f"{self} has no finite default value to use, checked: "
                f"{defaults}. Pass testval argument or adjust so value is "
                "finite.")
        return self.getattr_value(val)

    def getattr_value(self, val):
        if isinstance(val, str):
            val = getattr(self, val)
        if isinstance(val, Node):
            val = val.test_value
        val = np.asarray(val)
        return np.broadcast_to(val, self.shape) if self.shape else val

    # -- forward sampling ----------------------------------------------------
    def _host_dtype(self):
        """The numpy dtype that ``random()`` returns, the JAX package's
        numpy samplers': int64 for an integer distribution, else float64
        (a family that differs says so)."""
        return np.dtype("int64" if self.dtype.kind in "iu" else "float64")

    def random(self, point=None, size=None, gen=None):
        """Draws of shape ``size + self.shape`` as a numpy array of the JAX
        package's dtype for this distribution. They are drawn on this
        distribution's device from ``gen`` (a ``torch.Generator`` there; a
        freshly seeded one by default) and copied to the host once."""
        draws = self._random(point=point, size=size, gen=gen)
        return draws.detach().cpu().numpy().astype(self._host_dtype(),
                                                    copy=False)

    def _random(self, point=None, size=None, gen=None):
        """The draws of :meth:`random` as a tensor on this distribution's
        device: what the port's own callers use."""
        raise NotImplementedError(
            f"random() not implemented for {type(self).__name__}")

    def _generator(self, gen):
        """``gen``, or a freshly seeded generator on this distribution's
        device."""
        return gen if gen is not None else make_generator(self.device)

    def _draw(self, sampler, names, point, size, gen):
        """The usual ``random``: parameters ``names`` drawn at ``point``,
        then ``sampler(gen, shape, *params)``."""
        gen = self._generator(gen)
        params = draw_values([getattr(self, n) for n in names], point=point,
                             size=size, gen=gen)
        return generate_samples(sampler, *params, dist_shape=self.shape,
                                size=size, gen=gen, lead=point_lead(point))

    def _draw_core(self):
        """Trailing shape of one draw: the distribution's shape, else the
        broadcast of its parameters' shapes."""
        if self.shape:
            return tuple(self.shape)
        shapes = [tuple(np.shape(p.test_value))
                  for p in self.param_nodes().values()]
        return tuple(np.broadcast_shapes(*shapes)) if shapes else ()

    def __str__(self):
        return type(self).__name__

    __repr__ = __str__


class NoDistribution(Distribution):
    """A distribution with no density (cf. ``distribution.py:219``)."""

    def __init__(self, shape, dtype, testval=None, defaults=(),
                 parent_dist=None, *args, **kwargs):
        super().__init__(shape=shape, dtype=dtype, testval=testval,
                         defaults=defaults, *args, **kwargs)
        self.parent_dist = parent_dist

    def __getattr__(self, name):
        # unknown attributes come from the parent distribution
        if name in ("parent_dist", "__getstate__", "__setstate__"):
            raise AttributeError(name)
        pd = self.__dict__.get("parent_dist")
        if pd is not None:
            return getattr(pd, name)
        raise AttributeError(name)

    def logp(self, value, env=None, memo=None):
        return torch.zeros_like(value, dtype=torch_floatX())


class Discrete(Distribution):
    """Base for discrete distributions (cf. ``distribution.py:242``)."""

    def __init__(self, shape=(), dtype=None, defaults=("mode",), *args,
                 **kwargs):
        super().__init__(shape=shape, dtype=dtype or intX(),
                         defaults=defaults, *args, **kwargs)


class Continuous(Distribution):
    """Base for continuous distributions (cf. ``distribution.py:252``)."""

    def __init__(self, shape=(), dtype=None,
                 defaults=("median", "mean", "mode"), *args, **kwargs):
        super().__init__(shape=shape, dtype=dtype or floatX(),
                         defaults=defaults, *args, **kwargs)


class DensityDist(Distribution):
    """A distribution from a user-supplied log-density
    (cf. ``distribution.py:263``). ``logp`` takes the value as a tensor and
    returns the elementwise log-density (a tensor or a node)."""

    def __init__(self, logp, shape=(), dtype=None, testval=0, random=None,
                 wrap_random_with_dist_shape=True, check_shape_in_random=True,
                 *args, **kwargs):
        super().__init__(shape=shape, dtype=dtype or floatX(),
                         testval=testval, *args, **kwargs)
        self._logp_fn = logp
        self.rand = random
        self.wrap_random_with_dist_shape = wrap_random_with_dist_shape
        self.check_shape_in_random = check_shape_in_random

    def logp(self, value, env=None, memo=None):
        out = self._logp_fn(value)
        if isinstance(out, Node):
            out = evaluate(out, env or {}, memo)
        return out

    def random(self, point=None, size=None, gen=None):
        """The user's ``random(point=point, size=size)``, as it returns it
        (``gen`` is not used), as in the JAX package."""
        if self.rand is None:
            raise ValueError(
                "Distribution was not passed any random method. Define a "
                "custom random method and pass it as kwarg random")
        return self.rand(point=point, size=size)

    def _random(self, point=None, size=None, gen=None):
        return _as_tensor(self.random(point=point, size=size), self.device)


class TransformedDistribution(Distribution):
    """A distribution pushed through a transform (cf. ``distribution.py:296``).
    Models apply transforms themselves; this serves ``Transform.apply`` and
    standalone use."""

    @classmethod
    def dist(cls, dist, transform):
        obj = object.__new__(cls)
        obj.dist_ = dist
        obj.transform_used = transform
        obj.shape = transform.forward_shape(dist.shape)
        obj.dtype = dist.dtype
        obj.testval = None
        obj.defaults = ()
        obj.transform = None
        obj.device = dist.device
        return obj

    def logp(self, value, env=None, memo=None):
        x = self.transform_used.backward(value, env, memo)
        return self.dist_.logp(x, env, memo) \
            + self.transform_used.jacobian_det(value, env, memo)


def draw_values(params: Sequence, point: Optional[Dict] = None, size=None,
                gen=None):
    """Values of each parameter at ``point``, as tensors on ``gen``'s
    device (cf. ``distribution.py:320``).

    Parameters are the node DAG itself, so drawing them is evaluating them
    against the point. A distribution given as a parameter is drawn from
    at ``size``. At a :class:`BatchedPoint` each value carries the point's
    leading sample axis, and ``size`` must start with it.
    """
    point = point if point is not None else {}
    device = gen.device if gen is not None else current_device()
    nodes = [p for p in params if isinstance(p, Node)]

    def evaluate_nodes(env):
        memo = {}
        return [_ev(n, env, memo) for n in nodes]

    lead = point_lead(point)
    if lead:
        size_t = to_tuple(size)
        if not size_t or size_t[0] != point.n:
            raise ValueError(f"draws at a batched point of {point.n} samples "
                             f"need size ({point.n}, ...), got {size!r}")
        vals = point.vmap(evaluate_nodes) if nodes else []
    else:
        vals = evaluate_nodes({k: _as_tensor(v, device)
                               for k, v in point.items()})
    vals = iter(vals)
    out = []
    for p in params:
        if isinstance(p, Node):
            out.append(next(vals))
        elif isinstance(p, Distribution):
            out.append(p._random(point=point, size=size, gen=gen))
        else:
            val = _as_tensor(p, device)
            if lead:
                val = torch.broadcast_to(val, (point.n,) + tuple(val.shape))
            out.append(val)
    return out


def _align(x, lead, n_size, n_core):
    """Reshape a parameter with ``lead`` leading sample axes and its own
    trailing shape so that it broadcasts against ``size + core``."""
    own = tuple(x.shape[lead:])
    if len(own) > n_core:
        raise ValueError(f"a parameter of shape {own} has more dimensions "
                         f"than a draw of {n_core}")
    return x.reshape(tuple(x.shape[:lead]) + (1,) * (n_size - lead)
                     + (1,) * (n_core - len(own)) + own)


def generate_samples(generator, *args, dist_shape=(), size=None, gen=None,
                     lead=0, broadcast_shape=None, not_broadcast_kwargs=None,
                     **kwargs):
    """Draws of shape ``size + core`` (cf. ``distribution.py:344``).

    ``core`` is ``dist_shape`` if given, else the parameters' broadcast
    shape. With ``gen``, a ``torch.Generator``, the draws are made on its
    device: each parameter carries ``lead`` leading sample axes that stand
    under the first axes of ``size``, and ``generator(gen, shape,
    *params)`` receives the parameters reshaped to broadcast against
    ``shape``.

    Without ``gen``, ``generator`` is a numpy-style host sampler, as
    PyMC3's: ``generator(*args, size=shape, **not_broadcast_kwargs,
    **kwargs)`` (``scipy.stats.norm.rvs``, ``np.random.normal``). It draws
    on the host, and the draws are copied to the device once: the tensor
    returned is on the model's device (the configured one outside a
    model).
    """
    if gen is None:
        return _host_samples(generator, args, dist_shape, size,
                             broadcast_shape, not_broadcast_kwargs or {},
                             kwargs)
    if kwargs or not_broadcast_kwargs:
        raise TypeError("keyword parameters go to a host generator, which "
                        "is called without gen=")
    size_t = to_tuple(size)
    if lead > len(size_t):
        raise ValueError(f"parameters with {lead} sample axes need a size "
                         f"of at least that many axes, got {size!r}")
    args = [torch.as_tensor(a) for a in args]
    if broadcast_shape is None:
        broadcast_shape = np.broadcast_shapes(
            *[tuple(a.shape[lead:]) for a in args]) if args else ()
    dist_shape = to_tuple(dist_shape)
    core = dist_shape if dist_shape else tuple(broadcast_shape)
    out_shape = size_t + core
    aligned = [_align(a, lead, len(size_t), len(core)) for a in args]
    samples = generator(gen, out_shape, *aligned)
    if tuple(samples.shape) != out_shape:
        raise ValueError(f"a sampler drew shape {tuple(samples.shape)}, "
                         f"expected {out_shape}")
    return samples


def _host_samples(generator, args, dist_shape, size, broadcast_shape,
                  not_broadcast_kwargs, kwargs):
    """The host path of :func:`generate_samples`: the JAX package's
    contract (``distribution.py:344-383``), then one copy to the device."""
    args = [np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor)
                       else a) for a in args]
    kwargs = {k: (np.asarray(v.detach().cpu()) if isinstance(v, torch.Tensor)
                  else v) for k, v in kwargs.items()}
    if broadcast_shape is None:
        try:
            broadcast_shape = np.broadcast_shapes(
                *[np.shape(a) for a in args]) if args else ()
        except ValueError:
            broadcast_shape = dist_shape
    dist_shape = to_tuple(dist_shape)
    size_t = to_tuple(size) if size is not None else ()
    core = dist_shape if dist_shape else tuple(broadcast_shape)
    out_shape = size_t + core
    samples = np.asarray(generator(*args, size=out_shape or None,
                                   **not_broadcast_kwargs, **kwargs))
    if size is None and samples.shape == (1,) + core:
        samples = samples.reshape(core)
    return _as_tensor(samples, current_device())


# -- random primitives: every draw from an explicit generator ---------------
def rand_uniform(gen, shape, dtype=None):
    return torch.rand(shape, generator=gen, device=gen.device,
                      dtype=dtype or torch_floatX())


def rand_normal(gen, shape, dtype=None):
    return torch.randn(shape, generator=gen, device=gen.device,
                       dtype=dtype or torch_floatX())


def rand_exponential(gen, shape, dtype=None):
    return torch.empty(shape, device=gen.device,
                       dtype=dtype or torch_floatX()).exponential_(
                           generator=gen)


def rand_gamma(gen, shape, alpha):
    """Standard gamma draws in float64 (small shapes underflow float32)."""
    alpha = torch.broadcast_to(alpha.double(), shape).contiguous()
    return torch._standard_gamma(alpha, generator=gen)
