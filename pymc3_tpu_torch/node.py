"""Symbolic expression graph for the model DSL (cf. ``pymc3_tpu/node.py``).

Every node knows how to compute itself from an environment
``{rv_name: tensor}``. The same evaluation runs eagerly in PyTorch and under
``torch.func`` transforms (``vmap`` over chains, ``grad`` for the logp), so
a model's log-density is written once, for one point.

Constants live on the model's device: a :class:`ConstantNode` converts its
numpy value once, when the model is built, so evaluating the graph at every
leapfrog never copies host data to the card.

Test values (numpy) are computed eagerly at construction, so shape and dtype
errors surface when the model is declared.
"""
from __future__ import annotations

import numbers
import operator
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

from .config import default_device, floatX

__all__ = ["Node", "ConstantNode", "OpNode", "NamedNode", "apply", "as_node",
           "evaluate", "evaluate_many", "constant_fold", "current_device"]


def current_device() -> torch.device:
    """Device of the model on the context stack; the configured device
    (``config.default_device``) when there is none."""
    from .model import Model
    model = Model.get_context(error_if_none=False)
    if model is not None:
        return model.device
    return default_device()


def _to_numpy(x):
    if isinstance(x, (tuple, list)):
        return tuple(_to_numpy(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _test_operand(x, device):
    """Tensor test value of an operand, on ``device``."""
    if isinstance(x, ConstantNode):
        return x.value
    if isinstance(x, Node):
        tv = x.test_value
        if isinstance(tv, tuple):
            return tuple(torch.as_tensor(v, device=device) for v in tv)
        return torch.as_tensor(tv, device=device)
    return x


def _reduce(fn, x, axis, keepdims):
    if axis is None:
        out = fn(x)
        return out.reshape((1,) * x.ndim) if keepdims else out
    return fn(x, dim=axis, keepdim=keepdims)


def _prod(x, dim=None, keepdim=False):
    """``torch.prod`` over one axis or several (it takes one)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted((d % x.ndim for d in np.atleast_1d(dim)), reverse=True):
        x = torch.prod(x, dim=int(d), keepdim=keepdim)
    return x


def _std(x, dim=None, keepdim=False):
    """numpy's ``std``: the population sd (``ddof=0``)."""
    if dim is None:
        return torch.std(x, correction=0)
    return torch.std(x, dim=dim, correction=0, keepdim=keepdim)


def _cumsum(x, axis):
    """numpy's ``cumsum``: over the flattened value when ``axis`` is
    None."""
    return torch.cumsum(x.reshape(-1), 0) if axis is None else \
        torch.cumsum(x, axis)


def _clip(x, lo, hi):
    """numpy's ``clip``: either bound may be None, a number or a tensor."""
    def bound(b):
        return None if b is None else torch.as_tensor(b, dtype=x.dtype,
                                                      device=x.device)
    return torch.clamp(x, bound(lo), bound(hi))


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (or its name)."""
    return torch.from_numpy(np.zeros(0, dtype=np.dtype(dtype))).dtype


def _transpose(x, axes):
    """numpy's ``transpose``: the axes reversed when ``axes`` is None, so
    a 1-D value is its own transpose."""
    axes = tuple(range(x.ndim))[::-1] if axes is None else axes
    return x.permute(*axes)


class Node:
    """Base class for symbolic expression nodes.

    Sub-classes implement ``_eval(env, memo)`` returning a tensor. Arithmetic
    on nodes builds :class:`OpNode` trees via operator overloading.
    """

    __array_ufunc__ = None  # keep numpy from consuming us in `np_array + node`
    __array_priority__ = 1000

    name: Optional[str] = None
    _test_value: Optional[np.ndarray] = None

    def _eval(self, env: Dict[str, Any], memo: Dict[int, Any]):
        raise NotImplementedError

    def eval(self, env: Optional[Dict[str, Any]] = None):
        """Evaluate against an environment of RV values."""
        return evaluate(self, env or {})

    @property
    def test_value(self) -> np.ndarray:
        if self._test_value is None:
            raise ValueError(f"node {self!r} has no test value")
        return self._test_value

    @property
    def tag(self):
        """The node itself: ``var.tag.test_value`` reads as in Theano."""
        return self

    @property
    def shape(self):
        return self.test_value.shape

    @property
    def ndim(self):
        return self.test_value.ndim

    @property
    def size(self):
        return int(self.test_value.size)

    @property
    def dtype(self):
        return self.test_value.dtype

    # -- operators -----------------------------------------------------------
    @staticmethod
    def _operable(other):
        """Can a tensor op consume ``other``? Operands with their own
        operator protocol (``gp.cov.Covariance`` in ``eta**2 * ExpQuad``)
        must get the reflected call."""
        return isinstance(other, (Node, numbers.Number, np.ndarray,
                                  torch.Tensor, list, tuple))

    def __add__(self, other):
        if not self._operable(other):
            return NotImplemented
        return apply(operator.add, self, other)

    def __radd__(self, other):
        return apply(operator.add, other, self)

    def __sub__(self, other):
        return apply(operator.sub, self, other)

    def __rsub__(self, other):
        return apply(operator.sub, other, self)

    def __mul__(self, other):
        if not self._operable(other):
            return NotImplemented
        return apply(operator.mul, self, other)

    def __rmul__(self, other):
        return apply(operator.mul, other, self)

    def __truediv__(self, other):
        return apply(operator.truediv, self, other)

    def __rtruediv__(self, other):
        return apply(operator.truediv, other, self)

    def __floordiv__(self, other):
        return apply(operator.floordiv, self, other)

    def __rfloordiv__(self, other):
        return apply(operator.floordiv, other, self)

    def __mod__(self, other):
        return apply(operator.mod, self, other)

    def __rmod__(self, other):
        return apply(operator.mod, other, self)

    def __pow__(self, other):
        return apply(operator.pow, self, other)

    def __rpow__(self, other):
        return apply(operator.pow, other, self)

    def __matmul__(self, other):
        return apply(operator.matmul, self, other)

    def __rmatmul__(self, other):
        return apply(operator.matmul, other, self)

    def __neg__(self):
        return apply(operator.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply(torch.abs, self)

    def __invert__(self):
        return apply(torch.logical_not, self)

    def __lt__(self, other):
        return apply(operator.lt, self, other)

    def __le__(self, other):
        return apply(operator.le, self, other)

    def __gt__(self, other):
        return apply(operator.gt, self, other)

    def __ge__(self, other):
        return apply(operator.ge, self, other)

    def eq(self, other):
        return apply(torch.eq, self, other)

    def neq(self, other):
        return apply(torch.ne, self, other)

    def __getitem__(self, idx):
        if isinstance(idx, (np.ndarray, list)):
            idx = np.asarray(idx)
            if np.issubdtype(idx.dtype, np.integer):
                # a gather index (radon's a[county_idx]) lives on the
                # device as int64, the dtype torch indexes with
                idx = idx.astype(np.int64)
            idx = as_node(idx)
        if isinstance(idx, Node):
            return apply(operator.getitem, self, idx)
        return apply(lambda x: x[idx], self)

    # -- tensor-method conveniences -----------------------------------------
    # Reductions and shapes follow numpy, as the JAX package's do: ``std``
    # is the population sd, ``axis=None`` reduces (or flattens) everything,
    # ``//`` and ``%`` take the sign of the divisor.
    @property
    def T(self):
        """The axes reversed, as numpy's ``.T``: a 1-D node is its own
        transpose, a matrix is swapped."""
        return self.transpose()

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        return apply(lambda x: _transpose(x, axes or None), self)

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return apply(lambda x: torch.reshape(x, shape), self)

    def ravel(self):
        return apply(torch.ravel, self)

    flatten = ravel

    def sum(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(torch.sum, x, axis, keepdims), self)

    def prod(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(_prod, x, axis, keepdims), self)

    def mean(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(torch.mean, x, axis, keepdims), self)

    def std(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(_std, x, axis, keepdims), self)

    def max(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(torch.amax, x, axis, keepdims), self)

    def min(self, axis=None, keepdims=False):
        return apply(lambda x: _reduce(torch.amin, x, axis, keepdims), self)

    def cumsum(self, axis=None):
        return apply(lambda x: _cumsum(x, axis), self)

    def dot(self, other):
        return apply(operator.matmul, self, other)

    def astype(self, dtype):
        dt = torch_dtype(dtype)
        return apply(lambda x: x.to(dt), self)

    def clip(self, a_min, a_max):
        return apply(_clip, self, a_min, a_max)

    def squeeze(self, axis=None):
        if axis is None:
            return apply(torch.squeeze, self)
        return apply(lambda x: torch.squeeze(x, axis), self)

    def exp(self):
        return apply(torch.exp, self)

    def log(self):
        return apply(torch.log, self)

    def __iter__(self):
        if self.ndim == 0:
            raise TypeError("iteration over a 0-d symbolic node")
        return (self[i] for i in range(self.shape[0]))

    def __len__(self):
        if self.ndim == 0:
            raise TypeError("len() of 0-d symbolic node")
        return self.shape[0]

    def __bool__(self):
        raise TypeError("the truth value of a symbolic node is undefined; "
                        "use torch.where inside wrapped functions")

    def __hash__(self):
        return id(self)

    def __repr__(self):
        nm = self.name if self.name is not None else type(self).__name__
        try:
            return f"{nm}{list(self.shape)!r}"
        except (ValueError, AttributeError):
            return nm

    def __str__(self):
        return self.name if self.name is not None else repr(self)


class ConstantNode(Node):
    """A node wrapping a concrete tensor, held on the model's device."""

    __slots__ = ("value", "_test_value", "name")

    def __init__(self, value, name: Optional[str] = None, device=None):
        device = current_device() if device is None else device
        if isinstance(value, torch.Tensor):
            self.value = value.to(device)
            self._test_value = _to_numpy(value)
        else:
            self._test_value = np.asarray(value)
            # torch takes no negative strides (``x[::-1]``)
            self.value = torch.as_tensor(
                self._test_value.copy() if any(
                    st < 0 for st in self._test_value.strides)
                else self._test_value, device=device)
        self.name = name

    def _eval(self, env, memo):
        return self.value


class NamedNode(Node):
    """A node addressable by name in the evaluation environment: a value for
    ``self.name`` in the environment wins, else ``_eval_default``."""

    def _eval_default(self, env, memo):
        raise KeyError(
            f"variable {self.name!r} not in environment and has no default")

    def _eval(self, env, memo):
        if self.name is not None and self.name in env:
            return env[self.name]
        return self._eval_default(env, memo)


class OpNode(Node):
    """fn(*args, **kwargs) over symbolic/constant operands."""

    __slots__ = ("fn", "args", "kwargs", "_test_value", "_device", "name")

    def __init__(self, fn: Callable, args: Sequence[Any], kwargs=None,
                 name: Optional[str] = None, test_value=None):
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.name = name
        self._device = current_device()
        self._test_value = None if test_value is None else \
            _to_numpy(test_value)

    @property
    def test_value(self):
        """The given ``test_value``, or the value at the operands' test
        values, computed on the device the node was built for when first
        asked for (a shape query, a distribution's default) and kept on the
        host. A graph that is only evaluated, as GP prediction at thousands
        of new inputs, never computes it."""
        if self._test_value is None:
            tv_args = [_test_operand(a, self._device) for a in self.args]
            self._test_value = _to_numpy(self.fn(*tv_args, **self.kwargs))
        return self._test_value

    def _eval(self, env, memo):
        vals = [_ev(a, env, memo) for a in self.args]
        return self.fn(*vals, **self.kwargs)


def as_node(x, name: Optional[str] = None, dtype=None) -> Node:
    """Wrap a value as a node (pass nodes through). float64 data becomes
    ``floatX``."""
    if isinstance(x, Node):
        return x
    if isinstance(x, torch.Tensor):
        return ConstantNode(x, name=name)
    arr = np.asarray(x)
    if dtype is not None:
        arr = arr.astype(dtype)
    elif arr.dtype == np.float64 and floatX() == "float32":
        arr = arr.astype(np.float32)
    return ConstantNode(arr, name=name)


def _operand(a):
    if isinstance(a, np.generic):
        # numpy scalars would promote float32 tensors to float64
        return a.item()
    if isinstance(a, (np.ndarray, list, tuple)):
        return as_node(a)
    return a


def apply(fn: Callable, *args, **kwargs) -> Node:
    """Build an OpNode from a tensor-level callable and operands.

    Array operands become device constants. With no symbolic operand the
    result is folded into a ConstantNode at model-build time.
    """
    args = [_operand(a) for a in args]
    if any(isinstance(a, Node) and not isinstance(a, ConstantNode)
           for a in args):
        return OpNode(fn, args, kwargs)
    out = fn(*[a.value if isinstance(a, ConstantNode) else a for a in args],
             **kwargs)
    if isinstance(out, (tuple, list)):
        return OpNode(fn, args, kwargs)
    return as_node(out)


def _ev(x, env, memo):
    if not isinstance(x, Node):
        return x
    key = id(x)
    if key in memo:
        return memo[key]
    val = x._eval(env, memo)
    memo[key] = val
    return val


def evaluate(node, env: Dict[str, Any], memo: Optional[Dict[int, Any]] = None):
    """Evaluate one node against ``env`` (dict of name -> tensor)."""
    return _ev(node, env, {} if memo is None else memo)


def evaluate_many(nodes: Sequence[Any], env: Dict[str, Any]):
    """Evaluate several nodes with one memo, so a shared subgraph is
    evaluated once (cf. ``node.py:392``)."""
    memo: Dict[int, Any] = {}
    return [_ev(n, env, memo) for n in nodes]


def constant_fold(node):
    """The node's value as numpy when it needs no named variable from the
    environment (free variables read their test values), else None
    (cf. ``node.py:398``)."""
    try:
        return _to_numpy(evaluate(node, {}))
    except KeyError:
        return None
