"""Optimizer update rules (cf. ``pymc3_tpu/variational/updates.py``).

Each rule is a pure functional optimizer, ``init(params) -> state`` and
``update(grads, state, params) -> (params, state)``, over nested dicts of
tensors, with the JAX package's exact formulas (``torch.optim``'s Adagrad
and Adam differ from them in detail). A step counter is a host integer, so
an update never waits for the device. Calling a rule with no loss and no
params returns the optimizer, as the JAX package does for the Lasagne
calling convention.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import floatX

__all__ = [
    "sgd", "momentum", "nesterov_momentum", "adagrad", "adagrad_window",
    "rmsprop", "adadelta", "adam", "adamax", "norm_constraint",
    "total_norm_constraint", "Optimizer", "apply_momentum",
    "apply_nesterov_momentum", "get_optimizer", "tree_map", "tree_leaves",
]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, lists and tuples of tensors
    (the trees must share one structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a tree in ``tree_map``'s order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


class Optimizer:
    """Functional optimizer: ``init(params)``, ``update(g, state, params)``."""

    def __init__(self, name, init_fn, update_fn, **hyper):
        self.name = name
        self._init = init_fn
        self._update = update_fn
        self.hyper = hyper

    def init(self, params):
        return self._init(params)

    def update(self, grads, state, params):
        return self._update(grads, state, params)

    def __call__(self, *args, **kwargs):
        return self

    def __repr__(self):
        return f"Optimizer({self.name}, {self.hyper})"


def _curried(fn):
    @functools.wraps(fn)
    def wrapper(loss_or_grads=None, params=None, *args, **kwargs):
        return fn(*args, **kwargs)
    return wrapper


def _fx(x):
    """A host scalar of the configured float type: the bias corrections are
    taken in ``floatX`` on the host, as the JAX package takes them on the
    device (``t.astype(floatX())``)."""
    return np.dtype(floatX()).type(x)


def _zeros(p):
    return tree_map(torch.zeros_like, p)


@_curried
def sgd(learning_rate=1e-3):
    """Stochastic gradient descent (cf. ``updates.py:66``)."""
    lr = learning_rate

    def update(g, s, p):
        return tree_map(lambda p_, g_: p_ - lr * g_, p, g), s
    return Optimizer("sgd", lambda p: (), update, learning_rate=lr)


@_curried
def momentum(learning_rate=1e-3, momentum=0.9):
    """SGD with momentum (cf. ``updates.py:79``)."""
    lr, mom = learning_rate, momentum

    def update(g, v, p):
        v_new = tree_map(lambda v_, g_: mom * v_ - lr * g_, v, g)
        return tree_map(lambda p_, v_: p_ + v_, p, v_new), v_new
    return Optimizer("momentum", _zeros, update, learning_rate=lr,
                     momentum=mom)


@_curried
def nesterov_momentum(learning_rate=1e-3, momentum=0.9):
    """Nesterov momentum (cf. ``updates.py:96``)."""
    lr, mom = learning_rate, momentum

    def update(g, v, p):
        v_new = tree_map(lambda v_, g_: mom * v_ - lr * g_, v, g)
        p_new = tree_map(lambda p_, g_, vn: p_ + mom * vn - lr * g_,
                         p, g, v_new)
        return p_new, v_new
    return Optimizer("nesterov_momentum", _zeros, update, learning_rate=lr,
                     momentum=mom)


def _rate(opt_or_lr, kwargs):
    lr = kwargs.pop("learning_rate", None)
    if isinstance(opt_or_lr, Optimizer):
        return opt_or_lr.hyper.get("learning_rate", 1e-3)
    if lr is None:
        lr = opt_or_lr if opt_or_lr is not None else 1e-3
    return lr


def apply_momentum(opt_or_lr=None, momentum_=0.9, **kwargs):
    """A momentum optimizer at the rate of ``opt_or_lr`` (an optimizer or a
    number), cf. ``updates.py:113``."""
    return momentum(learning_rate=_rate(opt_or_lr, kwargs),
                    momentum=momentum_)


def apply_nesterov_momentum(opt_or_lr=None, momentum_=0.9, **kwargs):
    """The Nesterov variant of :func:`apply_momentum` (cf.
    ``updates.py:125``)."""
    return nesterov_momentum(learning_rate=_rate(opt_or_lr, kwargs),
                             momentum=momentum_)


@_curried
def adagrad(learning_rate=1.0, epsilon=1e-6):
    """Adagrad (cf. ``updates.py:136``)."""
    lr, eps = learning_rate, epsilon

    def update(g, acc, p):
        acc_new = tree_map(lambda a, g_: a + g_ ** 2, acc, g)
        p_new = tree_map(lambda p_, g_, a: p_ - lr * g_ / torch.sqrt(a + eps),
                         p, g, acc_new)
        return p_new, acc_new
    return Optimizer("adagrad", _zeros, update, learning_rate=lr)


@_curried
def adagrad_window(learning_rate=0.001, epsilon=0.1, n_win=10):
    """Windowed Adagrad, the default VI optimizer (cf. ``updates.py:153``):
    squared gradients summed over the last ``n_win`` steps. The state is
    ``(history of (n_win, *shape) per leaf, t)`` with ``t`` a host
    integer."""
    lr, eps = learning_rate, epsilon

    def init(p):
        hist = tree_map(lambda x: torch.zeros((n_win,) + tuple(x.shape),
                                              dtype=x.dtype, device=x.device),
                        p)
        return (hist, 0)

    def update(g, s, p):
        hist, t = s
        slot = t % n_win
        hist = tree_map(lambda h, g_: torch.cat(
            [h[:slot], (g_ ** 2)[None], h[slot + 1:]]), hist, g)
        p_new = tree_map(lambda p_, g_, h: p_ - lr * g_ / torch.sqrt(
            torch.sum(h, dim=0) + eps), p, g, hist)
        return p_new, (hist, t + 1)
    return Optimizer("adagrad_window", init, update, learning_rate=lr,
                     n_win=n_win)


@_curried
def rmsprop(learning_rate=1.0, rho=0.9, epsilon=1e-6):
    """RMSProp (cf. ``updates.py:182``)."""
    lr, eps = learning_rate, epsilon

    def update(g, acc, p):
        acc_new = tree_map(lambda a, g_: rho * a + (1 - rho) * g_ ** 2,
                           acc, g)
        p_new = tree_map(lambda p_, g_, a: p_ - lr * g_ / torch.sqrt(a + eps),
                         p, g, acc_new)
        return p_new, acc_new
    return Optimizer("rmsprop", _zeros, update, learning_rate=lr, rho=rho)


@_curried
def adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-6):
    """Adadelta (cf. ``updates.py:199``)."""
    lr, eps = learning_rate, epsilon

    def update(g, s, p):
        acc, delta_acc = s
        acc_new = tree_map(lambda a, g_: rho * a + (1 - rho) * g_ ** 2,
                           acc, g)
        upd = tree_map(lambda g_, a, d: g_ * torch.sqrt(d + eps)
                       / torch.sqrt(a + eps), g, acc_new, delta_acc)
        p_new = tree_map(lambda p_, u: p_ - lr * u, p, upd)
        delta_new = tree_map(lambda d, u: rho * d + (1 - rho) * u ** 2,
                             delta_acc, upd)
        return p_new, (acc_new, delta_new)
    return Optimizer("adadelta", lambda p: (_zeros(p), _zeros(p)), update,
                     learning_rate=lr, rho=rho)


@_curried
def adam(learning_rate=0.001, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Adam (cf. ``updates.py:223``)."""
    lr, b1, b2, eps = learning_rate, beta1, beta2, epsilon

    def update(g, s, p):
        m, v, t = s
        t = t + 1
        m = tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, m, g)
        v = tree_map(lambda v_, g_: b2 * v_ + (1 - b2) * g_ ** 2, v, g)
        a_t = float(lr * np.sqrt(1 - _fx(b2) ** _fx(t))
                    / (1 - _fx(b1) ** _fx(t)))
        p_new = tree_map(lambda p_, m_, v_: p_ - a_t * m_
                         / (torch.sqrt(v_) + eps), p, m, v)
        return p_new, (m, v, t)
    return Optimizer("adam", lambda p: (_zeros(p), _zeros(p), 0), update,
                     learning_rate=lr)


@_curried
def adamax(learning_rate=0.002, beta1=0.9, beta2=0.999, epsilon=1e-8):
    """Adamax (cf. ``updates.py:248``)."""
    lr, b1, b2, eps = learning_rate, beta1, beta2, epsilon

    def update(g, s, p):
        m, u, t = s
        t = t + 1
        m = tree_map(lambda m_, g_: b1 * m_ + (1 - b1) * g_, m, g)
        u = tree_map(lambda u_, g_: torch.maximum(b2 * u_, torch.abs(g_)),
                     u, g)
        a_t = float(lr / (1 - _fx(b1) ** _fx(t)))
        p_new = tree_map(lambda p_, m_, u_: p_ - a_t * m_ / (u_ + eps),
                         p, m, u)
        return p_new, (m, u, t)
    return Optimizer("adamax", lambda p: (_zeros(p), _zeros(p), 0), update,
                     learning_rate=lr)


def norm_constraint(tensor_var, max_norm, norm_axes=None, epsilon=1e-7):
    """Rescale so that the norms along ``norm_axes`` are at most
    ``max_norm`` (cf. ``updates.py:272``)."""
    x = torch.as_tensor(tensor_var)
    if norm_axes is not None:
        sum_over = tuple(norm_axes)
    elif x.ndim in (3, 4, 5):
        sum_over = tuple(range(1, x.ndim))
    else:
        sum_over = (0,)
    norms = torch.sqrt(torch.sum(x ** 2, dim=sum_over, keepdim=True))
    target = torch.clamp(norms, 0, max_norm)
    return x * (target / (epsilon + norms)).to(x.dtype)


def total_norm_constraint(tensor_vars, max_norm, epsilon=1e-7,
                          return_norm=False):
    """Rescale a list of tensors by their joint norm
    (cf. ``updates.py:290``)."""
    norm = torch.sqrt(sum(torch.sum(torch.as_tensor(t) ** 2)
                          for t in tensor_vars))
    target = torch.clamp(norm, 0, max_norm)
    multiplier = (target / (epsilon + norm)).to(
        torch.as_tensor(tensor_vars[0]).dtype)
    out = [torch.as_tensor(t) * multiplier for t in tensor_vars]
    return (out, norm) if return_norm else out


def get_optimizer(obj, **kwargs):
    """An :class:`Optimizer` from an optimizer, a rule or a rule's name."""
    if isinstance(obj, Optimizer):
        return obj
    if isinstance(obj, str):
        table = {
            "sgd": sgd, "momentum": momentum,
            "nesterov_momentum": nesterov_momentum, "adagrad": adagrad,
            "adagrad_window": adagrad_window, "rmsprop": rmsprop,
            "adadelta": adadelta, "adam": adam, "adamax": adamax,
        }
        return table[obj](**kwargs)
    if callable(obj):
        out = obj(**kwargs) if kwargs else obj()
        if isinstance(out, Optimizer):
            return out
    raise TypeError(f"Cannot interpret optimizer {obj!r}")
