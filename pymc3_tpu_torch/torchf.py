"""Function transforms over the model's logp (cf. ``pymc3_tpu/jaxf.py``).

The JAX package differentiates with ``jax.value_and_grad`` and batches
chains with ``jax.vmap``. Here a logp written for ONE point is batched with
``torch.func.vmap`` and differentiated by reverse-mode autograd of the sum
over chains: chains do not interact, so the gradient of the sum is each
chain's own gradient. This gives the same numbers as
``vmap(grad_and_value(logp))`` and runs the backward pass in autograd's
engine instead of through a second functorch layer (about 1.8x less host
time per call on the radon and GP models).

``gradient``, ``jacobian``, ``hessian`` and ``hessian_diag`` are the JAX
package's graph helpers (``jaxf.py:129-146``): each builds a node that
differentiates a node's evaluation with ``torch.func`` with respect to the
flat concatenation of named inputs. ``flat_derivative`` is the same
derivative of a plain function of one flat tensor. The rest of
``jaxf.py``'s surface (``jaxf.py:78-282``) follows: ``smartfloatX``,
``CallableTensor``, ``join_nonshared_inputs``, ``make_shared_replacements``,
``generator``, the global random stream ``tt_rng``/``set_tt_rng`` (a
``torch.Generator``) and ``take_along_axis``.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from .config import floatX, intX, torch_floatX
from .node import NamedNode, Node, apply, as_node, current_device, evaluate
from .vartypes import continuous_types

__all__ = ["batched_value_and_grad", "batched_value", "floatX", "intX",
           "gradient", "jacobian", "hessian", "hessian_diag", "inputvars",
           "cont_inputs", "flat_derivative", "smartfloatX", "CallableTensor",
           "join_nonshared_inputs", "make_shared_replacements", "generator",
           "tt_rng", "set_tt_rng", "take_along_axis"]


def batched_value_and_grad(logp_point: Callable) -> Callable:
    """``q: (chains, n) -> (logp (chains,), grad (chains, n))`` from a
    scalar ``logp_point(q: (n,))``."""
    batched = torch.func.vmap(logp_point)

    def value_and_grad(q):
        with torch.enable_grad():
            q = q.detach().requires_grad_()
            logp = batched(q)
            grad, = torch.autograd.grad(logp.sum(), q)
        return logp.detach(), grad
    return value_and_grad


def batched_value(logp_point: Callable) -> Callable:
    """``q: (chains, n) -> logp (chains,)`` from a scalar ``logp_point(q:
    (n,))``, with no autograd graph: what a gradient-free stepper calls.
    Further arguments (a minibatch draw) are batched with ``q``."""
    batched = torch.func.vmap(logp_point)

    def value(q, *args):
        with torch.no_grad():
            return batched(q, *args)
    return value


def _walk(node) -> List[Node]:
    """Every node reachable from ``node`` through operands, a
    deterministic's expression and a symbolic logp's value."""
    seen, order, stack = set(), [], [node]
    while stack:
        n = stack.pop()
        if not isinstance(n, Node) or id(n) in seen:
            continue
        seen.add(id(n))
        order.append(n)
        stack.extend(getattr(n, "args", ()))
        stack.extend(getattr(n, a, None) for a in ("expr", "value"))
    return order


def inputvars(a):
    """Named input variables feeding the graph (cf. ``jaxf.py:60``)."""
    out, names = [], set()
    for n in _walk(a):
        if isinstance(n, NamedNode) and n.name is not None \
                and n.name not in names:
            names.add(n.name)
            out.append(n)
    return out


def cont_inputs(a):
    """Continuous-dtype named inputs (cf. ``jaxf.py:71``)."""
    return [v for v in inputvars(a)
            if np.asarray(v.test_value).dtype.name in continuous_types]


def flat_derivative(fun, flat, mode):
    """``mode`` in {"grad", "jac", "hess", "hess_diag"} of ``fun`` at the
    flat tensor ``flat`` (forward over reverse for the Hessian)."""
    if mode == "grad":
        return torch.func.grad(fun)(flat)
    if mode == "jac":
        return torch.func.jacrev(fun)(flat)
    hess = torch.func.hessian(fun)(flat)
    return hess if mode == "hess" else torch.diagonal(hess)


def _diff_node(f, vars, mode):
    """A node computing a derivative of node ``f`` with respect to the flat
    concatenation of ``vars`` (named nodes; the continuous inputs of ``f``
    by default), cf. ``jaxf.py:85``."""
    if vars is None:
        vars = cont_inputs(f)
    if not vars:
        raise ValueError("no differentiable inputs found")
    dnames = [v.name for v in vars]
    rest = [v for v in inputvars(f) if v.name not in set(dnames)]
    shapes = [tuple(np.shape(v.test_value)) for v in vars]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]

    def run(*vals):
        env_rest = dict(zip([v.name for v in rest], vals[len(vars):]))

        def fun(flat):
            env = dict(env_rest)
            for name, part, shape in zip(dnames, torch.split(flat, sizes),
                                         shapes):
                env[name] = part.reshape(shape)
            return evaluate(f, env, {})

        flat0 = torch.cat([torch.as_tensor(v).reshape(-1)
                           for v in vals[:len(vars)]])
        return flat_derivative(fun, flat0, mode)

    return apply(run, *vars, *rest)


def gradient(f, vars=None):
    """Gradient node of scalar node ``f`` (cf. ``jaxf.py:129``)."""
    return _diff_node(f, vars, "grad")


def jacobian(f, vars=None):
    """Jacobian node of vector node ``f`` (cf. ``jaxf.py:134``)."""
    return _diff_node(f, vars, "jac")


def hessian(f, vars=None):
    """Dense Hessian node (cf. ``jaxf.py:139``)."""
    return _diff_node(f, vars, "hess")


def hessian_diag(f, vars=None):
    """Hessian-diagonal node (cf. ``jaxf.py:144``)."""
    return _diff_node(f, vars, "hess_diag")


def smartfloatX(x):
    """Float arrays as ``floatX``, other arrays as they are
    (cf. ``jaxf.py:78``)."""
    x = np.asarray(x)
    if np.issubdtype(x.dtype, np.floating):
        return x.astype(floatX())
    return x


class CallableTensor:
    """A graph with one named input made callable on a replacement for it
    (cf. ``jaxf.py:150``): ``CallableTensor(out)(input)`` is a node."""

    def __init__(self, tensor):
        self.tensor = as_node(tensor)

    def __call__(self, input):
        ins = inputvars(self.tensor)
        if len(ins) != 1:
            raise ValueError(
                f"graph has {len(ins)} named inputs, need exactly 1")
        name, tensor = ins[0].name, self.tensor
        return apply(lambda x: evaluate(tensor, {name: x}, {}),
                     as_node(input))


def join_nonshared_inputs(xs: Sequence, vars: Sequence, shared: Dict,
                          make_shared: bool = False):
    """``vars`` joined into one flat input (cf. ``jaxf.py:168``).

    Returns ``(new_xs, joined)``: ``joined`` is a named node
    ``'__joined__'`` holding the flat concatenation of the variables' test
    values, and each graph of ``xs`` is rewritten to read its variables as
    reshaped slices of it. ``shared`` maps a variable (or its name) to a
    fixed value for the inputs left out of the join. ``make_shared`` is
    accepted and unused, as in the JAX package: the joined input is always
    a named node, fed through the environment."""
    if not vars:
        raise ValueError("Empty list of variables.")
    vars = [as_node(v) for v in vars]
    names = [v.name for v in vars]
    shapes = [tuple(np.shape(v.test_value)) for v in vars]
    sizes = [int(np.prod(s, dtype=int)) for s in shapes]
    joined = NamedNode.__new__(NamedNode)
    joined.name = "__joined__"
    joined._test_value = np.concatenate(
        [np.ravel(np.asarray(v.test_value, floatX())) for v in vars])
    frozen = {getattr(k, "name", k): np.asarray(v)
              for k, v in (shared or {}).items()}

    def rewrite(x):
        x = as_node(x)

        def run(flat):
            env = {name: part.reshape(shape) for name, part, shape in
                   zip(names, torch.split(flat, sizes), shapes)}
            for name, v in frozen.items():
                env[name] = torch.as_tensor(v, device=flat.device)
            return evaluate(x, env, {})
        return apply(run, joined)

    return [rewrite(x) for x in xs], joined


def make_shared_replacements(vars, model) -> Dict:
    """Every free variable of ``model`` not in ``vars``, fixed at its test
    value (cf. ``jaxf.py:214``): the ``shared`` of
    :func:`join_nonshared_inputs`."""
    othervars = set(model.vars) - set(vars)
    return {var: np.asarray(var.test_value) for var in othervars}


def generator(gen, default=None):
    """A node fed from a Python generator of arrays
    (cf. ``jaxf.py:222``)."""
    from .data import GeneratorAdapter
    return GeneratorAdapter(gen).make_variable("generator")


class _RandomStream:
    """The global random stream (cf. ``jaxf.py:229``): a
    ``torch.Generator`` seeded with ``seed``, made on the configured device
    when first used, from which ``normal`` and ``uniform`` draw tensors of
    ``floatX`` there."""

    def __init__(self, seed=42):
        self.seed(seed)

    def seed(self, seed):
        self._seed = int(seed)
        self._generator = None

    @property
    def generator(self) -> torch.Generator:
        if self._generator is None:
            self._generator = torch.Generator(device=current_device())
            self._generator.manual_seed(self._seed)
        return self._generator

    def normal(self, size=()):
        gen = self.generator
        return torch.randn(size, generator=gen, device=gen.device,
                           dtype=torch_floatX())

    def uniform(self, size=()):
        gen = self.generator
        return torch.rand(size, generator=gen, device=gen.device,
                          dtype=torch_floatX())


_tt_rng = None


def tt_rng(random_seed=None):
    """The global random stream, reseeded when ``random_seed`` is given
    (cf. ``jaxf.py:257``)."""
    global _tt_rng
    if random_seed is not None:
        _tt_rng = _RandomStream(random_seed)
    elif _tt_rng is None:
        _tt_rng = _RandomStream(42)
    return _tt_rng


def set_tt_rng(new_rng):
    """Replace the global random stream; an int seeds a new one
    (cf. ``jaxf.py:268``)."""
    global _tt_rng
    if isinstance(new_rng, int):
        new_rng = _RandomStream(new_rng)
    _tt_rng = new_rng


def _take_along(a, i, axis):
    return torch.take_along_dim(a, i.to(torch.int64), dim=axis)


def take_along_axis(arr, indices, axis=0):
    """numpy's ``take_along_axis``: a node when either operand is one, else
    a tensor on the configured device (cf. ``jaxf.py:276``)."""
    if isinstance(arr, Node) or isinstance(indices, Node):
        return apply(lambda a, i: _take_along(a, i, axis), arr, indices)
    device = current_device()
    return _take_along(torch.as_tensor(np.asarray(arr), device=device),
                       torch.as_tensor(np.asarray(indices), device=device),
                       axis)
