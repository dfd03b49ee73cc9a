"""Function transforms over the model's logp (cf. ``pymc3_tpu/jaxf.py``).

The JAX package differentiates with ``jax.value_and_grad`` and batches
chains with ``jax.vmap``. Here a logp written for ONE point is batched with
``torch.func.vmap`` and differentiated by reverse-mode autograd of the sum
over chains: chains do not interact, so the gradient of the sum is each
chain's own gradient. This gives the same numbers as
``vmap(grad_and_value(logp))`` and runs the backward pass in autograd's
engine instead of through a second functorch layer (about 1.8x less host
time per call on the radon and GP models).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .config import floatX, intX

__all__ = ["batched_value_and_grad", "batched_value", "floatX", "intX"]


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
