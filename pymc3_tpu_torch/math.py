"""Node-aware math (cf. ``pymc3_tpu/math.py``): each function takes
symbolic nodes or concrete values and returns a node. The Kronecker helpers
apply a Kronecker product of factors to a matrix one factor at a time,
never forming the product."""
from __future__ import annotations

import functools
import numbers

import numpy as np
import torch
import torch.nn.functional as F

from .node import apply, as_node

__all__ = [
    "abs_", "exp", "log", "log1p", "log2", "log10", "sqrt", "sgn", "sqr",
    "ceil", "floor", "round_", "tround", "erf", "erfc", "erfinv", "erfcinv",
    "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos",
    "arctan", "arctan2", "arcsinh", "arccosh", "arctanh",
    "dot", "matmul", "outer", "maximum", "minimum", "where", "switch",
    "clip", "stack", "concatenate", "sum", "prod", "mean", "cumsum",
    "cumprod", "flatten", "ones_like", "zeros_like", "eye", "diag",
    "extract_diag", "tril", "triu", "constant", "sigmoid", "softmax",
    "log_softmax", "logsumexp", "logaddexp", "logdiffexp", "logit",
    "invlogit", "probit", "invprobit", "expand_packed_triangular",
    "log1pexp", "log1mexp", "flatten_list", "logdet", "cholesky", "solve",
    "solve_lower", "solve_upper", "matrix_inverse", "batched_diag",
    "block_diagonal", "kronecker", "cartesian", "kron_matrix_op",
    "kron_dot", "kron_solve_lower", "kron_solve_upper", "kron_diag",
]


def _wrap(fn):
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        # a number as the operand becomes a device constant, as jnp takes
        # one (``pm.math.log(2)`` in PyMC3's ODE notebook); later numbers
        # are options (``tril(x, -1)``)
        if args and isinstance(args[0], (numbers.Number, np.generic)):
            args = (as_node(np.asarray(args[0])),) + tuple(args[1:])
        return apply(lambda *a: fn(*a, **kwargs), *args)
    return wrapped


def _dims(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def _reduce(fn, v, axis, keepdims):
    if axis is None:
        out = fn(v)
        return out.reshape((1,) * v.ndim) if keepdims else out
    return fn(v, dim=_dims(axis), keepdim=keepdims)


# -- elementwise ------------------------------------------------------------
abs_ = _wrap(torch.abs)
exp = _wrap(torch.exp)
log = _wrap(torch.log)
log1p = _wrap(torch.log1p)
log2 = _wrap(torch.log2)
log10 = _wrap(torch.log10)
sqrt = _wrap(torch.sqrt)
sgn = _wrap(torch.sign)
ceil = _wrap(torch.ceil)
floor = _wrap(torch.floor)
round_ = tround = _wrap(torch.round)
erf = _wrap(torch.special.erf)
erfc = _wrap(torch.special.erfc)
erfinv = _wrap(torch.special.erfinv)
sin = _wrap(torch.sin)
cos = _wrap(torch.cos)
tan = _wrap(torch.tan)
sinh = _wrap(torch.sinh)
cosh = _wrap(torch.cosh)
tanh = _wrap(torch.tanh)
arcsin = _wrap(torch.asin)
arccos = _wrap(torch.acos)
arctan = _wrap(torch.atan)
arctan2 = _wrap(torch.atan2)
arcsinh = _wrap(torch.asinh)
arccosh = _wrap(torch.acosh)
arctanh = _wrap(torch.atanh)
maximum = _wrap(torch.maximum)
minimum = _wrap(torch.minimum)
logaddexp = _wrap(torch.logaddexp)
sigmoid = _wrap(torch.sigmoid)
logit = _wrap(torch.special.logit)
where = switch = _wrap(torch.where)


def sqr(x):
    return apply(torch.square, x)


def erfcinv(x):
    return apply(lambda v: torch.special.erfinv(1.0 - v), x)


def invlogit(x, eps=None):
    """Inverse logit; ``eps`` shrinks the output into (eps, 1 - eps)
    (cf. ``pymc3/math.py:146``)."""
    if eps is None:
        return apply(torch.sigmoid, x)
    return apply(lambda v: (1.0 - 2.0 * eps) * torch.sigmoid(v) + eps, x)


def probit(p):
    """Inverse of the standard-normal CDF (cf. ``pymc3/math.py:211``)."""
    return apply(torch.special.ndtri, p)


def invprobit(x):
    """Standard-normal CDF (cf. ``pymc3/math.py:215``)."""
    return apply(torch.special.ndtr, x)


def log1pexp(x):
    """log(1 + exp(x)), stable (softplus)."""
    return apply(F.softplus, x)


_LOG2 = 0.6931471805599453


def _log1mexp(x):
    # log(1 - exp(-x)) for x > 0, switching formulations at log(2)
    # (cf. pymc3/math.py:156, after Maechler 2012)
    small = x < _LOG2
    return torch.where(
        small, torch.log(-torch.expm1(-torch.where(small, x, 1.0))),
        torch.log1p(-torch.exp(-torch.where(small, 1.0, x))))


def log1mexp(x):
    """log(1 - exp(-x)), stable for both small and large x."""
    return apply(_log1mexp, x)


def logdiffexp(a, b):
    """log(exp(a) - exp(b)) (cf. ``pymc3/math.py:166``)."""
    return apply(lambda x, y: x + _log1mexp(x - y), a, b)


def logsumexp(x, axis=None, keepdims=True):
    """cf. ``pymc3/math.py:121`` (keepdims defaults to True, as there)."""
    def lse(v):
        if axis is None:
            out = torch.logsumexp(v.reshape(-1), dim=0)
            return out.reshape((1,) * v.ndim) if keepdims else out
        return torch.logsumexp(v, dim=_dims(axis), keepdim=keepdims)
    return apply(lse, x)


def softmax(x, axis=-1):
    return apply(lambda v: torch.softmax(v, dim=axis), x)


def log_softmax(x, axis=-1):
    return apply(lambda v: torch.log_softmax(v, dim=axis), x)


# -- structural -------------------------------------------------------------
def dot(a, b):
    return apply(torch.matmul, a, b)


matmul = _wrap(torch.matmul)
outer = _wrap(torch.outer)


def clip(x, lo, hi):
    return apply(torch.clamp, x, lo, hi)


def stack(*tensors, **kwargs):
    axis = kwargs.get("axis", 0)
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    return apply(lambda *ts: torch.stack(ts, dim=axis), *tensors)


def concatenate(tensor_list, axis=0):
    return apply(lambda *ts: torch.cat(ts, dim=axis), *tensor_list)


def sum(x, axis=None, keepdims=False):
    return apply(lambda v: _reduce(torch.sum, v, axis, keepdims), x)


def prod(x, axis=None, keepdims=False):
    def p(v):
        if axis is None:
            out = torch.prod(v)
            return out.reshape((1,) * v.ndim) if keepdims else out
        out = v
        for d in sorted(np.atleast_1d(axis) % v.ndim, reverse=True):
            out = torch.prod(out, dim=int(d), keepdim=keepdims)
        return out
    return apply(p, x)


def mean(x, axis=None, keepdims=False):
    return apply(lambda v: _reduce(torch.mean, v, axis, keepdims), x)


def cumsum(x, axis=0):
    return apply(lambda v: torch.cumsum(v, dim=axis), x)


def cumprod(x, axis=0):
    return apply(lambda v: torch.cumprod(v, dim=axis), x)


ones_like = _wrap(torch.ones_like)
zeros_like = _wrap(torch.zeros_like)
diag = _wrap(torch.diag)
tril = _wrap(torch.tril)
triu = _wrap(torch.triu)


def extract_diag(x):
    return apply(lambda m: torch.diagonal(m, dim1=-2, dim2=-1), x)


def eye(n, m=None, k=0):
    """An (n, m) identity on torch's default device, shifted by ``k``."""
    m = n if m is None else m
    return torch.as_tensor(np.eye(n, m, k, dtype=np.float32))


def constant(x, name=None):
    return as_node(x, name=name)


def flatten(x):
    return apply(torch.ravel, x)


def flatten_list(tensors):
    return concatenate([flatten(t) for t in tensors])


# -- linear algebra ---------------------------------------------------------
def cholesky(x, lower=True):
    return apply(lambda m: torch.linalg.cholesky(m, upper=not lower), x)


def solve(a, b):
    return apply(torch.linalg.solve, a, b)


def _solve_triangular(m, v, upper):
    vec = v.ndim == m.ndim - 1
    out = torch.linalg.solve_triangular(m, v[..., None] if vec else v,
                                        upper=upper)
    return out[..., 0] if vec else out


def solve_lower(a, b):
    return apply(lambda m, v: _solve_triangular(m, v, upper=False), a, b)


def solve_upper(a, b):
    return apply(lambda m, v: _solve_triangular(m, v, upper=True), a, b)


def matrix_inverse(x):
    return apply(torch.linalg.inv, x)


def logdet(m):
    """log|det(M)| through ``slogdet`` (cf. ``pymc3/math.py:174``)."""
    return apply(lambda x: torch.linalg.slogdet(x)[1], m)


def expand_packed_triangular(n, packed, lower=True, diagonal_only=False):
    """A packed triangular vector as an (n, n) triangular matrix, or its
    diagonal (cf. ``pymc3/math.py:219``)."""
    if diagonal_only:
        if lower:
            idx = np.arange(n) * (np.arange(n) + 3) // 2
        else:
            idx = np.arange(n) * (2 * n - np.arange(n) + 1) // 2
        return apply(lambda p: p[..., torch.as_tensor(idx, device=p.device)],
                     packed)
    rows, cols = np.tril_indices(n) if lower else np.triu_indices(n)
    # position of each (i, j) cell in the packed vector; the other cells
    # read an appended zero
    pos = np.full((n, n), rows.size, dtype=np.int64)
    pos[rows, cols] = np.arange(rows.size)

    def _expand(p):
        padded = torch.cat([p, torch.zeros_like(p[..., :1])], dim=-1)
        return padded[..., torch.as_tensor(pos, device=p.device)]
    return apply(_expand, packed)


def batched_diag(x):
    """A stack of vectors -> a stack of diagonal matrices, or a stack of
    matrices -> their diagonals (cf. ``pymc3/math.py:299``)."""
    def _bd(v):
        if v.ndim == 2:
            return torch.diag_embed(v)
        if v.ndim == 3:
            return torch.diagonal(v, dim1=-2, dim2=-1)
        raise ValueError("batched_diag expects 2d or 3d input")
    return apply(_bd, x)


def block_diagonal(matrices, sparse=False, format=None):
    """Matrices (a list, or a stack ``(k, n, m)``) -> their block-diagonal
    matrix (cf. ``pymc3/math.py:314``); ``sparse`` is accepted and ignored."""
    if isinstance(matrices, (list, tuple)):
        return apply(lambda *ms: torch.block_diag(*ms), *matrices)
    return apply(lambda m: torch.block_diag(*m.unbind(0)), matrices)


def kronecker(*Ks):
    """Kronecker product of a sequence of matrices (``math.py:336``)."""
    def _kron(*ms):
        out = ms[0]
        for m in ms[1:]:
            out = torch.kron(out, m)
        return out
    return apply(_kron, *Ks)


def cartesian(*arrays):
    """Cartesian product of 1-d arrays, row-major (host numpy,
    ``math.py:346``)."""
    arrays = [np.atleast_1d(np.asarray(a)) for a in arrays]
    grid = np.meshgrid(*arrays, indexing="ij")
    return np.stack([g.ravel() for g in grid], axis=-1)


def _kron_apply(ms, x, op):
    """``op`` of each factor across the Kronecker factorization, applied
    to the rows of ``x`` (cf. ``_kron_matrix_op``, ``math.py:353``)."""
    if x.ndim == 1:
        x = x[:, None]
    n = x.shape[0]
    res = x
    for K in ms:
        kn = K.shape[1]
        cols = res.shape[1]
        r = op(K, res.reshape(kn, n // kn * cols))
        r = r.reshape(K.shape[0], n // kn, cols)
        res = r.movedim(0, 1).reshape(n // kn * K.shape[0], cols)
        n = res.shape[0]
    return res


def kron_matrix_op(krons, m, op):
    return apply(lambda *a: _kron_apply(a[:-1], a[-1], op), *krons, m)


def kron_dot(krons, m):
    return kron_matrix_op(krons, m, lambda K, x: K @ x)


def kron_solve_lower(krons, m):
    return kron_matrix_op(krons, m, lambda K, x: torch.linalg.solve_triangular(
        K, x, upper=False))


def kron_solve_upper(krons, m):
    return kron_matrix_op(krons, m, lambda K, x: torch.linalg.solve_triangular(
        K, x, upper=True))


def kron_diag(*diags):
    """Kronecker product of diagonal vectors (``math.py:399``)."""
    def _kd(*ds):
        out = ds[0]
        for d in ds[1:]:
            out = (out[:, None] * d[None, :]).reshape(-1)
        return out
    return apply(_kd, *diags)
