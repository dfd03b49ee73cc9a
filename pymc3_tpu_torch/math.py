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

from .config import floatX, torch_floatX
from .node import apply, as_node, current_device

__all__ = [
    "abs_", "exp", "log", "log1p", "log2", "log10", "sqrt", "sgn", "sqr",
    "ceil", "floor", "round_", "tround", "erf", "erfc", "erfinv", "erfcinv",
    "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos",
    "arctan", "arctan2", "arcsinh", "arccosh", "arctanh",
    "dot", "matmul", "outer", "maximum", "minimum", "where", "switch",
    "clip", "stack", "concatenate", "sum", "prod", "mean", "cumsum",
    "cumprod", "flatten", "ones_like", "zeros_like", "full_like", "eye",
    "diag",
    "extract_diag", "tril", "triu", "constant", "sigmoid", "softmax",
    "log_softmax", "logsumexp", "logaddexp", "logdiffexp", "logit",
    "invlogit", "probit", "invprobit", "expand_packed_triangular",
    "log1pexp", "log1mexp", "flatten_list", "logdet", "cholesky", "solve",
    "solve_lower", "solve_upper", "matrix_inverse", "batched_diag",
    "block_diagonal", "kronecker", "cartesian", "kron_matrix_op",
    "kron_dot", "kron_solve_lower", "kron_solve_upper", "kron_diag",
    "flat_outer", "log1mexp_numpy", "largest_common_dtype", "floatX_array",
]


def _floating(v):
    """An integer or bool tensor in ``floatX``, as ``jnp`` promotes the
    operand of a function whose result is inexact."""
    if isinstance(v, torch.Tensor) and not (v.is_floating_point()
                                            or v.is_complex()):
        return v.to(torch_floatX())
    return v


def _wrap(fn, inexact=False):
    """``fn`` over the positional operands, each a node, a tensor, an
    array or a number; ``inexact``: integer operands in ``floatX`` first."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        # a number becomes a device constant, as jnp takes one
        # (``pm.math.log(2)`` in PyMC3's ODE notebook); options go to
        # ``fn`` by keyword or in a closure
        args = [as_node(np.asarray(a))
                if isinstance(a, (numbers.Number, np.generic)) else a
                for a in args]
        if inexact:
            return apply(lambda *a: fn(*map(_floating, a), **kwargs), *args)
        return apply(lambda *a: fn(*a, **kwargs), *args)
    return wrapped


def _inexact(fn):
    return _wrap(fn, inexact=True)


def _dims(axis):
    return tuple(axis) if isinstance(axis, (tuple, list)) else axis


def _reduce(fn, v, axis, keepdims):
    if axis is None:
        out = fn(v)
        return out.reshape((1,) * v.ndim) if keepdims else out
    return fn(v, dim=_dims(axis), keepdim=keepdims)


# -- elementwise ------------------------------------------------------------
abs_ = _wrap(torch.abs)
exp = _inexact(torch.exp)
log = _inexact(torch.log)
log1p = _inexact(torch.log1p)
log2 = _inexact(torch.log2)
log10 = _inexact(torch.log10)
sqrt = _inexact(torch.sqrt)
ceil = _wrap(torch.ceil)
floor = _wrap(torch.floor)


def _sign(v):
    """``jnp.sign``: NaN where ``v`` is NaN."""
    return torch.where(torch.isnan(v), v, torch.sign(v)) \
        if v.is_floating_point() else torch.sign(v)


sgn = _wrap(_sign)


def _round(v, decimals):
    """``jnp.round``: an integer is its own value."""
    return torch.round(v, decimals=decimals) if v.is_floating_point() \
        else v


def round_(a, decimals=0, out=None):
    """numpy's ``round`` (the JAX package's is ``jnp.round``)."""
    _no_out("round", out)
    return _wrap(lambda v: _round(v, decimals))(a)


tround = round_


# the operand of ``jax.scipy.special``'s functions is named ``x``
def erf(x):
    return _inexact(torch.special.erf)(x)


def erfc(x):
    return _inexact(torch.special.erfc)(x)


def erfinv(x):
    return _inexact(torch.special.erfinv)(x)


sin = _inexact(torch.sin)
cos = _inexact(torch.cos)
tan = _inexact(torch.tan)
sinh = _inexact(torch.sinh)
cosh = _inexact(torch.cosh)
tanh = _inexact(torch.tanh)
arcsin = _inexact(torch.asin)
arccos = _inexact(torch.acos)
arctan = _inexact(torch.atan)
arctan2 = _inexact(torch.atan2)
arcsinh = _inexact(torch.asinh)
arccosh = _inexact(torch.acosh)
arctanh = _inexact(torch.atanh)


def sigmoid(x):
    return _inexact(torch.sigmoid)(x)


def logit(x):
    return _inexact(torch.special.logit)(x)


def _no_out(name, out, where=None):
    """``jnp``'s ``out`` and ``where`` must be None: so here."""
    if out is not None or where is not None:
        raise NotImplementedError(
            f"The 'out' and 'where' arguments to {name} are not supported.")


def maximum(x1, x2, out=None, where=None):
    _no_out("maximum", out, where)
    return _wrap(torch.maximum)(x1, x2)


def minimum(x1, x2, out=None, where=None):
    _no_out("minimum", out, where)
    return _wrap(torch.minimum)(x1, x2)


def logaddexp(a, b):
    return _inexact(torch.logaddexp)(a, b)


def _where(cond, a, b):
    """``jnp.where``: a condition that is not bool is tested against 0."""
    return torch.where(cond if cond.dtype == torch.bool else cond != 0, a, b)


def where(cond, a, b):
    return _wrap(_where)(cond, a, b)


switch = where


def sqr(x):
    return _wrap(torch.square)(x)


def erfcinv(x):
    return _inexact(lambda v: torch.special.erfinv(1.0 - v))(x)


def invlogit(x, eps=None):
    """Inverse logit; ``eps`` shrinks the output into (eps, 1 - eps)
    (cf. ``pymc3/math.py:146``)."""
    if eps is None:
        return _inexact(torch.sigmoid)(x)
    return _inexact(lambda v: (1.0 - 2.0 * eps) * torch.sigmoid(v) + eps)(x)


def probit(p):
    """Inverse of the standard-normal CDF (cf. ``pymc3/math.py:211``)."""
    return _inexact(torch.special.ndtri)(p)


def invprobit(x):
    """Standard-normal CDF (cf. ``pymc3/math.py:215``)."""
    return _inexact(torch.special.ndtr)(x)


def log1pexp(x):
    """log(1 + exp(x)), stable (softplus)."""
    return _inexact(F.softplus)(x)


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
    return _inexact(_log1mexp)(x)


def log1mexp_numpy(x):
    """log(1 - exp(-x)) on the host, in float64 (cf. ``math.py:133``)."""
    x = np.asarray(x, dtype=float)
    out = np.empty_like(x)
    small = x < _LOG2
    out[small] = np.log(-np.expm1(-x[small]))
    out[~small] = np.log1p(-np.exp(-x[~small]))
    return out


def logdiffexp(a, b):
    """log(exp(a) - exp(b)) (cf. ``pymc3/math.py:166``)."""
    return _inexact(lambda x, y: x + _log1mexp(x - y))(a, b)


def logsumexp(x, axis=None, keepdims=True):
    """cf. ``pymc3/math.py:121`` (keepdims defaults to True, as there)."""
    def lse(v):
        if axis is None:
            out = torch.logsumexp(v.reshape(-1), dim=0)
            return out.reshape((1,) * v.ndim) if keepdims else out
        return torch.logsumexp(v, dim=_dims(axis), keepdim=keepdims)
    return _inexact(lse)(x)


def softmax(x, axis=-1):
    return _inexact(lambda v: torch.softmax(v, dim=axis))(x)


def log_softmax(x, axis=-1):
    return _inexact(lambda v: torch.log_softmax(v, dim=axis))(x)


# -- structural -------------------------------------------------------------
def _promoted(*ts):
    """The tensors in the type they promote to together, as ``jnp``'s
    products and solves take them (torch's take one type)."""
    dtype = functools.reduce(torch.promote_types, [t.dtype for t in ts])
    return [t.to(dtype) for t in ts]


def _product(x, y):
    return torch.matmul(*_promoted(x, y))


def dot(a, b):
    return _wrap(_product)(a, b)


def matmul(a, b, *, preferred_element_type=None, out_sharding=None):
    """``jnp.matmul``: the product in ``preferred_element_type`` when it is
    given. The port's tensors live on one device: ``out_sharding`` must be
    None."""
    _no_sharding(out_sharding)
    if preferred_element_type is None:
        return _wrap(_product)(a, b)
    dtype = _torch_dtype(preferred_element_type)

    def product(x, y):
        # in the wider of the operands' type and ``dtype``, as XLA
        # accumulates, then in ``dtype``
        wide = torch.promote_types(torch.result_type(x, y), dtype)
        return torch.matmul(x.to(wide), y.to(wide)).to(dtype)
    return _wrap(product)(a, b)


def _no_sharding(out_sharding):
    if out_sharding is not None:
        raise NotImplementedError("out_sharding: the port does not shard")


def _outer(x, y):
    """``jnp.outer``: the product of the flattened operands."""
    return torch.outer(x.reshape(-1), y.reshape(-1))


def outer(a, b, out=None):
    _no_out("outer", out)
    return _wrap(_outer)(a, b)


def _torch_dtype(dtype):
    return dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, np.dtype(dtype).name)


def clip(x, lo, hi):
    return _wrap(torch.clamp)(x, lo, hi)


def stack(*tensors, **kwargs):
    axis = kwargs.get("axis", 0)
    if len(tensors) == 1 and isinstance(tensors[0], (list, tuple)):
        tensors = tuple(tensors[0])
    return _wrap(lambda *ts: torch.stack(ts, dim=axis))(*tensors)


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
    return _inexact(lambda v: _reduce(torch.mean, v, axis, keepdims))(x)


def _cumulative(op, a, axis, dtype, out):
    """numpy's ``cumsum``/``cumprod`` (the JAX package's are ``jnp``'s):
    over the flattened value when ``axis`` is None, in ``dtype`` when it is
    given. ``out`` must be None, as in ``jnp``."""
    if out is not None:
        raise ValueError("out is not supported")
    dtype = None if dtype is None else getattr(torch, np.dtype(dtype).name)

    def run(v):
        return op(v.reshape(-1), 0, dtype=dtype) if axis is None else \
            op(v, axis, dtype=dtype)
    return apply(run, a)


def cumsum(a, axis=None, dtype=None, out=None):
    return _cumulative(torch.cumsum, a, axis, dtype, out)


def cumprod(a, axis=None, dtype=None, out=None):
    return _cumulative(torch.cumprod, a, axis, dtype, out)


def _filled_like(v, fill, dtype, shape, device):
    """numpy's ``full_like``: ``v``'s shape, dtype and device unless
    ``shape``, ``dtype`` or ``device`` is given; a tensor ``fill`` is
    broadcast to the shape."""
    dtype = v.dtype if dtype is None else _torch_dtype(dtype)
    device = v.device if device is None else device
    shape = v.shape if shape is None else \
        (shape,) if np.ndim(shape) == 0 else tuple(shape)
    if isinstance(fill, torch.Tensor):
        return fill.to(device=device, dtype=dtype).expand(shape).clone()
    return torch.full(shape, fill, dtype=dtype, device=device)


def full_like(a, fill_value, dtype=None, shape=None, *, device=None):
    return _wrap(lambda v, f: _filled_like(v, f, dtype, shape, device))(
        a, fill_value)


def ones_like(a, dtype=None, shape=None, *, device=None, out_sharding=None):
    _no_sharding(out_sharding)
    return _wrap(lambda v: _filled_like(v, 1, dtype, shape, device))(a)


def zeros_like(a, dtype=None, shape=None, *, device=None, out_sharding=None):
    _no_sharding(out_sharding)
    return _wrap(lambda v: _filled_like(v, 0, dtype, shape, device))(a)


def diag(v, k=0):
    return _wrap(lambda t: torch.diag(t, k))(v)


def tril(m, k=0):
    return _wrap(lambda t: torch.tril(t, k))(m)


def triu(m, k=0):
    return _wrap(lambda t: torch.triu(t, k))(m)


def extract_diag(x):
    """``jnp.diagonal``: the diagonal over the first two axes, last."""
    return _wrap(lambda m: torch.diagonal(m, dim1=0, dim2=1))(x)


def eye(n, m=None, k=0):
    """An (n, m) identity in ``floatX`` on the model's device (the
    configured one outside a model), shifted by ``k``."""
    return torch.as_tensor(np.eye(n, m, k, dtype=floatX()),
                           device=current_device())


def constant(x, name=None):
    return as_node(x, name=name)


def flatten(x):
    return _wrap(torch.ravel)(x)


def flatten_list(tensors):
    return concatenate([flatten(t) for t in tensors])


# -- linear algebra ---------------------------------------------------------
def _cholesky(m, lower):
    """``jax.scipy.linalg.cholesky``: the factor of the lower triangle of
    ``m`` (of the upper one when not ``lower``); a matrix that is not
    positive definite gives NaN on its factor's triangle, batch entry by
    batch entry, with no host sync."""
    L, info = torch.linalg.cholesky_ex(m if lower else m.mT,
                                       check_errors=False)
    tri = torch.ones(L.shape[-2:], dtype=torch.bool, device=L.device).tril()
    L = torch.where((info != 0)[..., None, None] & tri, torch.nan, L)
    return L if lower else L.mT


def cholesky(x, lower=True):
    return _inexact(lambda m: _cholesky(m, lower))(x)


def _solve(m, v):
    """``jnp.linalg.solve``: a singular ``m`` gives inf and NaN, not an
    error, with no host sync."""
    return torch.linalg.solve_ex(*_promoted(m, v), check_errors=False)[0]


def solve(a, b):
    return _inexact(_solve)(a, b)


def _solve_triangular(m, v, upper):
    m, v = _promoted(m, v)
    vec = v.ndim == m.ndim - 1
    out = torch.linalg.solve_triangular(m, v[..., None] if vec else v,
                                        upper=upper)
    return out[..., 0] if vec else out


def solve_lower(a, b):
    return _inexact(lambda m, v: _solve_triangular(m, v, upper=False))(a, b)


def solve_upper(a, b):
    return _inexact(lambda m, v: _solve_triangular(m, v, upper=True))(a, b)


def matrix_inverse(x):
    """``jnp.linalg.inv``: a singular matrix gives inf and NaN."""
    return _inexact(lambda m: torch.linalg.inv_ex(m, check_errors=False)[0])(x)


def logdet(m):
    """log|det(M)| through ``slogdet`` (cf. ``pymc3/math.py:174``)."""
    return _inexact(lambda x: torch.linalg.slogdet(x)[1])(m)


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
    return kron_matrix_op(krons, m, _product)


def kron_solve_lower(krons, m):
    return kron_matrix_op(krons, m, lambda K, x: torch.linalg.solve_triangular(
        *_promoted(K, x), upper=False))


def kron_solve_upper(krons, m):
    return kron_matrix_op(krons, m, lambda K, x: torch.linalg.solve_triangular(
        *_promoted(K, x), upper=True))


def kron_diag(*diags):
    """Kronecker product of diagonal vectors (``math.py:399``)."""
    def _kd(*ds):
        out = ds[0]
        for d in ds[1:]:
            out = (out[:, None] * d[None, :]).reshape(-1)
        return out
    return apply(_kd, *diags)


def flat_outer(a, b):
    """The outer product of the flattened operands, flattened (cf.
    ``math.py:238``)."""
    return _wrap(lambda x, y: _outer(x, y).reshape(-1))(a, b)


def floatX_array(x):
    """``x`` as a numpy array of ``floatX`` (cf. ``math.py:408``)."""
    return floatX(np.asarray(x))


def largest_common_dtype(tensors):
    """The numpy dtype every one of ``tensors`` (nodes or arrays) promotes
    to (cf. ``math.py:413``)."""
    return np.result_type(*[np.asarray(getattr(t, "test_value", t)).dtype
                            for t in tensors])
