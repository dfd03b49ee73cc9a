"""Values of ``pm.math`` in the port against the JAX package, over a table
of argument forms, at both ``floatX`` values.

Every public callable of ``pymc3_tpu.math`` (as
``tests/test_torch_submodule_surface.py`` counts them: the functions it
defines and its ``__all__``) has a row in ``FORMS``: scalars, vectors, 2-D
and batched 3-D arrays, values outside the domain (x <= 0 for the logs,
|x| > 1 for the inverse trigonometric and error functions, matrices that
are not positive definite or are singular for the linear algebra), integer
inputs where numpy takes them, a float32 operand beside float64 ones
(``_mixed``), and keyword forms. The inputs are numpy arrays made from one
seed per form, and both packages get the same ones, in three ways
(``_modes``): as arrays, as data nodes of a model (the function builds a
graph, whose value is compared), and, where a form has an array, as data
nodes whose graph the port evaluates under ``torch.func.vmap`` over two
copies of each operand, as a model's batched logp does; each row is held
to the JAX package's value of the graph.

For each form both packages are called and compared:

- whether the call raises, and where both raise, the kind of error, as
  ``_kind`` groups them: JAX reports a shape that does not fit as a
  ``TypeError`` or ``ValueError`` and PyTorch as a ``RuntimeError`` or an
  ``IndexError``, so those four are one kind ("the operands do not fit");
- the result's dtype and shape, with one rule for integers: at float32 the
  JAX package runs with x64 off, where every integer is int32, and the port
  keeps numpy's int64 (``node.as_node``); an integer result is compared by
  kind there and by width at float64 (ROADMAP, queue 3, kept differences);
- the values, with NaN equal to NaN and infinities equal in sign: rtol and
  atol ``TOL[floatX]``, 1e-5 and 1e-6 at float32 (a few ulps of the two
  libraries' transcendental functions and of sums in another order) and
  1e-12 at float64. An exact result (integer, bool, a count) is compared
  exactly.

``EXCLUDED`` names the argument forms a callable of the JAX package takes
that are not in the table, each with its reason; ``REFERENCE_FAULTS`` and
``FLOAT64_AT_FLOAT32`` the forms where the JAX package is at fault and
what the port is held to instead. Nothing is excluded because it fails.

The file takes about 100 s in one process, most of it the JAX package's
eager calls: each operation compiles once for each shape and dtype, about
50 ms a time on the CPU, so new forms reuse the table's shapes.
"""
import zlib

import jax
import numpy as np
import pytest
import scipy.special
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import node as jnode
from pymc3_tpu_torch import node as tnode

from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .test_torch_submodule_surface import _public_names

TOL = {"float32": dict(rtol=1e-5, atol=1e-6),
       "float64": dict(rtol=1e-12, atol=1e-12)}


def _spd(rng, n=3, batch=()):
    a = rng.randn(*batch, n, n)
    return a @ np.swapaxes(a, -1, -2) + n * np.eye(n)


def _tri(rng, n=3, lower=True):
    a = rng.randn(n, n) + 3 * np.eye(n)
    return np.tril(a) if lower else np.triu(a)


# one seeded numpy input maker per form: ``make(rng) -> (args, kwargs)``
def _u(shape=(5,), lo=-2.0, hi=2.0):
    return lambda rng: ((rng.uniform(lo, hi, shape),), {})


def _ints(rng):
    return (np.arange(-2, 4),), {}


# the vector forms have one length, so that the JAX package compiles each
# of its operations once for them (about 50 ms a shape on the CPU)
UNARY = {
    "scalar": lambda rng: ((float(rng.uniform(0.1, 0.9)),), {}),
    "matrix": _u((3, 4), 0.1, 0.9),
    "batched": _u((2, 3, 4), 0.1, 0.9),
    "out-of-domain": _u((6,), lo=-3.0, hi=3.0),
    "edges": lambda rng: ((np.array([-np.inf, -1.0, 0.0, 1.0, np.inf,
                                     np.nan]),), {}),
    "int": _ints,
}
UNARY_NAMES = [
    "abs_", "exp", "log", "log1p", "log2", "log10", "sqrt", "sgn", "sqr",
    "ceil", "floor", "round_", "tround", "erf", "erfc", "erfinv", "erfcinv",
    "sin", "cos", "tan", "sinh", "cosh", "tanh", "arcsin", "arccos",
    "arctan", "arcsinh", "arccosh", "arctanh", "sigmoid", "logit",
    "invlogit", "probit", "invprobit", "log1pexp", "log1mexp", "flatten",
]


def _binary(lo=-2.0, hi=2.0):
    return {
        "vectors": lambda rng: ((rng.uniform(lo, hi, 5),
                                 rng.uniform(lo, hi, 5)), {}),
        "broadcast": lambda rng: ((rng.uniform(lo, hi, (3, 4)),
                                   rng.uniform(lo, hi, 4)), {}),
        "scalar-first": lambda rng: ((0.5, rng.uniform(lo, hi, 5)), {}),
        "batched": lambda rng: ((rng.uniform(lo, hi, (2, 3, 4)),
                                 rng.uniform(lo, hi, (2, 3, 4))), {}),
        "int": lambda rng: ((np.arange(-2, 4), np.arange(6)[::-1]), {}),
        "mismatch": lambda rng: ((rng.randn(3), rng.randn(4)), {}),
        "mixed": _mixed(lambda rng: ((rng.uniform(lo, hi, 5),
                                      rng.uniform(lo, hi, 5)), {})),
    }


def _reduction(name):
    forms = {
        "vector": _u(),
        "batched": _u((2, 3, 4)),
        "axis": lambda rng: ((rng.randn(2, 3, 4),), dict(axis=1)),
        "axes-keepdims": lambda rng: ((rng.randn(2, 3, 4),),
                                      dict(axis=(0, 2), keepdims=True)),
        "negative-axis": lambda rng: ((rng.randn(2, 3, 4),), dict(axis=-1)),
        "keepdims": lambda rng: ((rng.randn(3, 4),), dict(keepdims=True)),
        "int": _ints,
    }
    if name == "logsumexp":
        forms["no-keepdims"] = lambda rng: ((rng.randn(3, 4),),
                                            dict(axis=1, keepdims=False))
        forms["edges"] = lambda rng: ((np.array([-np.inf, -np.inf]),), {})
    return forms


def _pair_of(shape_a, shape_b):
    return lambda rng: ((rng.randn(*shape_a), rng.randn(*shape_b)), {})


def _mixed(make):
    """``make``'s form with its first operand in float32 and the others in
    float64: at float64 the JAX package keeps float32 data as it is, and
    its operations promote the pair to float64."""
    def mixed(rng):
        args, kwargs = make(rng)
        first = args[0]
        if isinstance(first, list):
            first = [first[0].astype(np.float32)] + first[1:]
        else:
            first = first.astype(np.float32)
        return (first,) + tuple(args[1:]), kwargs
    return mixed


FORMS = {name: UNARY for name in UNARY_NAMES}
FORMS.update({
    "round_": dict(UNARY, decimals=lambda rng: (
        (rng.uniform(-20, 20, 6),), dict(decimals=2))),
    "invlogit": dict(UNARY, eps=lambda rng: ((rng.randn(5) * 30,),
                                             dict(eps=1e-3))),
})
FORMS["tround"] = FORMS["round_"]
for _name in ("arctan2", "maximum", "minimum", "logaddexp", "logdiffexp"):
    FORMS[_name] = _binary()
for _name in ("sum", "prod", "mean", "logsumexp"):
    FORMS[_name] = _reduction(_name)
FORMS.update({
    "softmax": {"vector": _u(),
                "axis": lambda rng: ((rng.randn(3, 4),), dict(axis=0)),
                "batched": _u((2, 3, 4)),
                "edges": lambda rng: ((np.array([-np.inf, 0.0, 1.0]),), {})},
    "dot": {"vectors": _pair_of((4,), (4,)),
            "matrix-vector": _pair_of((3, 4), (4,)),
            "matrices": _pair_of((3, 4), (4, 2)),
            "batched-matrix": _pair_of((2, 3, 4), (4, 2)),
            "int": lambda rng: ((np.arange(4), np.arange(4)), {}),
            "mixed": _mixed(_pair_of((3, 4), (4,))),
            "int-float": lambda rng: ((np.arange(12).reshape(3, 4),
                                       rng.randn(4)), {}),
            "mismatch": _pair_of((3,), (4,))},
    "matmul": {"vectors": _pair_of((4,), (4,)),
               "matrix-vector": _pair_of((3, 4), (4,)),
               "matrices": _pair_of((3, 4), (4, 2)),
               "batched": _pair_of((2, 3, 4), (2, 4, 2)),
               "broadcast": _pair_of((2, 3, 4), (4, 2)),
               "mismatch": _pair_of((3, 4), (3, 4)),
               "mixed": _mixed(_pair_of((2, 3, 4), (4, 2))),
               "preferred": lambda rng: (
                   (rng.randn(3, 4), rng.randn(4)),
                   dict(preferred_element_type=np.float32))},
    "outer": {"scalars": lambda rng: ((2.0, 3.0), {}),
              "vectors": _pair_of((3,), (4,)),
              "matrix": _pair_of((2, 2), (3,)),
              "matrices": _pair_of((2, 3), (2, 2)),
              "mixed": _mixed(_pair_of((3,), (4,))),
              "int": lambda rng: ((np.arange(3), np.arange(2)), {})},
    "where": {"vectors": lambda rng: ((rng.randn(5) > 0, rng.randn(5),
                                       rng.randn(5)), {}),
              "mixed": lambda rng: ((rng.randn(5) > 0, rng.randn(5).astype(
                  np.float32), rng.randn(5)), {}),
              "broadcast": lambda rng: ((rng.randn(3, 1) > 0, rng.randn(4),
                                         0.0), {}),
              "int": lambda rng: ((np.array([1, 0, 2]), np.arange(3),
                                   -np.arange(3)), {})},
    "clip": {"vector": lambda rng: ((rng.randn(6), -0.5, 0.5), {}),
             "array-bounds": lambda rng: ((rng.randn(3, 4), rng.randn(4) - 1,
                                           rng.randn(4) + 1), {}),
             "int": lambda rng: ((np.arange(-3, 4), -1, 2), {}),
             "lower-only": lambda rng: ((rng.randn(6), 0.0, None), {})},
    "stack": {"two": _pair_of((3,), (3,)),
              "list-axis": lambda rng: (([rng.randn(3), rng.randn(3)],),
                                        dict(axis=1)),
              "scalars": lambda rng: ((1.0, 2.5), {}),
              "mixed": lambda rng: ((1.0, np.float64(rng.randn())), {}),
              "mixed-arrays": _mixed(_pair_of((3,), (3,))),
              "mismatch": _pair_of((3,), (4,))},
    "concatenate": {"vectors": lambda rng: (([rng.randn(3), rng.randn(2)],),
                                            {}),
                    "axis": lambda rng: (([rng.randn(2, 3), rng.randn(2, 1)],),
                                         dict(axis=1)),
                    "int": lambda rng: (([np.arange(2), np.arange(3)],), {}),
                    "mixed": _mixed(lambda rng: (([rng.randn(3),
                                                   rng.randn(2)],), {})),
                    "mismatch": lambda rng: (([rng.randn(2, 3),
                                               rng.randn(3, 2)],), {})},
    "cumsum": {"vector": _u(), "matrix": _u((3, 4)),
               "axis": lambda rng: ((rng.randn(3, 4),), dict(axis=1)),
               "dtype": lambda rng: ((np.arange(5),), dict(dtype=np.float32)),
               "int": _ints},
    "ones_like": {"matrix": _u((3, 4)), "int": _ints,
                  "scalar": lambda rng: ((2.5,), {}),
                  "dtype": lambda rng: ((rng.randn(3),),
                                        dict(dtype=np.int32)),
                  "shape": lambda rng: ((rng.randn(3),), dict(shape=(2, 2)))},
    "full_like": {"scalar-fill": lambda rng: ((rng.randn(3, 4), 2.5), {}),
                  "array-fill": lambda rng: ((rng.randn(3, 4),
                                              rng.randn(4)), {}),
                  "matrix-fill": lambda rng: ((rng.randn(3, 4),
                                               rng.randn(3, 4)), {}),
                  "int-array": lambda rng: ((np.arange(6), 1.7), {}),
                  "int-fill": lambda rng: ((rng.randn(3), np.arange(3)), {}),
                  "dtype": lambda rng: ((rng.randn(3), 2),
                                        dict(dtype=np.int32)),
                  "shape": lambda rng: ((rng.randn(3), rng.randn(2)),
                                        dict(shape=(4, 2))),
                  "mismatch": lambda rng: ((rng.randn(3, 4), rng.randn(3)),
                                           {})},
    "eye": {"square": lambda rng: ((3,), {}),
            "rectangle": lambda rng: ((3, 4), {}),
            "shifted": lambda rng: ((4, 3), dict(k=1)),
            "below": lambda rng: ((3,), dict(k=-2))},
    "diag": {"vector": _u((4,)), "matrix": _u((3, 4)),
             "offset": lambda rng: ((rng.randn(3),), dict(k=1)),
             "matrix-offset": lambda rng: ((rng.randn(4, 4), -1), {}),
             "int": _ints},
    "extract_diag": {"matrix": _u((3, 4)), "batched": _u((2, 3, 3)),
                     "int": lambda rng: ((np.arange(9).reshape(3, 3),), {})},
    "tril": {"matrix": _u((3, 4)), "batched": _u((2, 3, 3)),
             "offset": lambda rng: ((rng.randn(4, 4),), dict(k=-1)),
             "positional": lambda rng: ((rng.randn(4, 4), 1), {}),
             "int": lambda rng: ((np.arange(9).reshape(3, 3),), {})},
    "constant": {"vector": _u(), "int": _ints,
                 "scalar": lambda rng: ((1.5,), {}),
                 "named": lambda rng: ((rng.randn(2, 2),), dict(name="c"))},
    "expand_packed_triangular": {
        "lower": lambda rng: ((3, rng.randn(6)), {}),
        "upper": lambda rng: ((3, rng.randn(6)), dict(lower=False)),
        "batched": lambda rng: ((3, rng.randn(2, 6)), {}),
        "diagonal": lambda rng: ((4, rng.randn(10)),
                                 dict(diagonal_only=True)),
        "upper-diagonal": lambda rng: ((4, rng.randn(10)),
                                       dict(lower=False,
                                            diagonal_only=True))},
    "log1mexp_numpy": {"vector": _u(lo=0.01, hi=3.0),
                       "out-of-domain": _u(lo=-1.0, hi=1.0),
                       "int": lambda rng: ((np.arange(1, 5),), {}),
                       "scalar": lambda rng: ((0.3,), {})},
    "flat_outer": {"vectors": _pair_of((3,), (4,)),
                   "scalars": lambda rng: ((2.0, 3.0), {}),
                   "matrix": _pair_of((2, 2), (3,)),
                   "int": lambda rng: ((np.arange(3), np.arange(2)), {})},
    "kronecker": {"two": _pair_of((2, 3), (3, 2)),
                  "mixed": _mixed(_pair_of((2, 3), (3, 2))),
                  "three": lambda rng: ((rng.randn(2, 2), rng.randn(1, 3),
                                         rng.randn(2, 1)), {}),
                  "one": _u((2, 2))},
    "cartesian": {"two": lambda rng: ((np.arange(3), rng.randn(2)), {}),
                  "three": lambda rng: ((np.arange(2), np.arange(3),
                                         [0.5]), {}),
                  "scalar": lambda rng: ((1.0, np.arange(2)), {})},
    "kron_matrix_op": {
        "product": lambda rng: (([rng.randn(2, 2), rng.randn(3, 3)],
                                 rng.randn(6, 2), lambda K, x: K @ x), {}),
        "vector": lambda rng: (([rng.randn(2, 2), rng.randn(3, 3)],
                                rng.randn(6), lambda K, x: K @ x), {})},
    "kron_dot": {
        "matrix": lambda rng: (([rng.randn(2, 2), rng.randn(3, 3)],
                                rng.randn(6, 2)), {}),
        "vector": lambda rng: (([rng.randn(2, 2), rng.randn(3, 3)],
                                rng.randn(6)), {}),
        "rectangular": lambda rng: (([rng.randn(3, 2), rng.randn(1, 3)],
                                     rng.randn(6, 2)), {}),
        "mixed": _mixed(lambda rng: (([rng.randn(2, 2), rng.randn(3, 3)],
                                      rng.randn(6, 2)), {}))},
    "kron_solve_lower": {
        "matrix": lambda rng: (([_tri(rng, 2), _tri(rng, 3)],
                                rng.randn(6, 2)), {}),
        "vector": lambda rng: (([_tri(rng, 2), _tri(rng, 3)],
                                rng.randn(6)), {}),
        "mixed": _mixed(lambda rng: (([_tri(rng, 2), _tri(rng, 3)],
                                      rng.randn(6, 2)), {}))},
    "kron_solve_upper": {
        "matrix": lambda rng: (([_tri(rng, 2, False), _tri(rng, 3, False)],
                                rng.randn(6, 2)), {}),
        "vector": lambda rng: (([_tri(rng, 2, False), _tri(rng, 3, False)],
                                rng.randn(6)), {}),
        "mixed": _mixed(lambda rng: (([_tri(rng, 2, False),
                                       _tri(rng, 3, False)],
                                      rng.randn(6)), {}))},
    "kron_diag": {"two": _pair_of((2,), (3,)),
                  "three": lambda rng: ((rng.randn(2), rng.randn(3),
                                         rng.randn(2)), {}),
                  "one": _u((3,))},
    "flatten_list": {"mixed": lambda rng: (([rng.randn(2, 2), rng.randn(3),
                                             np.float64(rng.randn())],), {}),
                     "int": lambda rng: (([np.arange(2), np.arange(3)],),
                                         {})},
    "logdet": {"spd": lambda rng: ((_spd(rng),), {}),
               "batched": lambda rng: ((_spd(rng, batch=(2,)),), {}),
               "negative-det": lambda rng: ((np.diag([2.0, -3.0, 1.0]),), {}),
               "singular": lambda rng: ((np.ones((3, 3)),), {})},
    "batched_diag": {"vectors": _u((2, 3)), "matrices": _u((2, 3, 3)),
                     "vector": _u((3,))},
    "block_diagonal": {
        "list": lambda rng: (([rng.randn(2, 2), rng.randn(1, 3)],), {}),
        "mixed": _mixed(lambda rng: (([rng.randn(2, 2), rng.randn(1, 3)],),
                                     {})),
        "stack": lambda rng: ((rng.randn(3, 2, 2),), {}),
        "sparse": lambda rng: (([rng.randn(2, 2), rng.randn(2, 2)],),
                               dict(sparse=True))},
    "cholesky": {"spd": lambda rng: ((_spd(rng),), {}),
                 "upper": lambda rng: ((_spd(rng),), dict(lower=False)),
                 "batched": lambda rng: ((_spd(rng, batch=(2,)),), {}),
                 "not-pd": lambda rng: ((np.array([[1.0, 2.0],
                                                   [2.0, 1.0]]),), {}),
                 "not-pd-upper": lambda rng: ((np.array([[1.0, 2.0],
                                                         [2.0, 1.0]]),),
                                              dict(lower=False)),
                 "batched-not-pd": lambda rng: ((np.stack([
                     _spd(rng), -np.eye(3), _spd(rng)]),), {}),
                 "asymmetric": lambda rng: ((_spd(rng) + np.triu(
                     np.ones((3, 3)), 1),), dict(lower=False)),
                 "int": lambda rng: ((np.array([[4, 2], [2, 3]]),), {})},
    "solve": {"vector": lambda rng: ((_spd(rng), rng.randn(3)), {}),
              "matrix": lambda rng: ((_spd(rng), rng.randn(3, 2)), {}),
              "batched": lambda rng: ((_spd(rng, batch=(2,)),
                                       rng.randn(2, 3, 2)), {}),
              "mismatch": lambda rng: ((_spd(rng), rng.randn(4)), {}),
              "mixed": _mixed(lambda rng: ((_spd(rng), rng.randn(3)), {})),
              "singular": lambda rng: ((np.ones((3, 3)), rng.randn(3)), {}),
              "batched-singular": lambda rng: ((np.stack(
                  [_spd(rng), np.zeros((3, 3))]), rng.randn(2, 3, 1)), {})},
    "solve_lower": {"vector": lambda rng: ((_tri(rng), rng.randn(3)), {}),
                    "mixed": _mixed(lambda rng: ((_tri(rng),
                                                  rng.randn(3, 2)), {})),
                    "matrix": lambda rng: ((_tri(rng), rng.randn(3, 2)), {}),
                    "full": lambda rng: ((_spd(rng), rng.randn(3)), {}),
                    "singular": lambda rng: ((np.tril(np.ones((3, 3)), -1),
                                              rng.randn(3)), {})},
    "solve_upper": {"vector": lambda rng: ((_tri(rng, 3, False),
                                            rng.randn(3)), {}),
                    "matrix": lambda rng: ((_tri(rng, 3, False),
                                            rng.randn(3, 2)), {}),
                    "full": lambda rng: ((_spd(rng), rng.randn(3)), {}),
                    "mixed": _mixed(lambda rng: ((_tri(rng, 3, False),
                                                  rng.randn(3)), {}))},
    "matrix_inverse": {"spd": lambda rng: ((_spd(rng),), {}),
                       "batched": lambda rng: ((_spd(rng, batch=(2,)),), {}),
                       "general": _u((3, 3)),
                       "singular": lambda rng: ((np.array(
                           [[1.0, 2.0, 3.0], [2.0, 4.0, 6.0],
                            [1.0, 0.0, 1.0]]),), {})},
    "floatX_array": {"vector": _u(), "int": _ints,
                     "list": lambda rng: (([1, 2.5],), {}),
                     "float32": lambda rng: ((rng.randn(3).astype(
                         np.float32),), {})},
    "largest_common_dtype": {
        "floats": lambda rng: (([rng.randn(2), rng.randn(2).astype(
            np.float32)],), {}),
        "int-float32": lambda rng: (([np.arange(2, dtype=np.int32),
                                      np.ones(2, np.float32)],), {}),
        "ints": lambda rng: (([np.arange(2, dtype=np.int8),
                               np.arange(2, dtype=np.int16)],), {})},
})
FORMS["log_softmax"] = FORMS["softmax"]
FORMS["cumprod"] = FORMS["cumsum"]
FORMS["zeros_like"] = FORMS["ones_like"]
FORMS["triu"] = FORMS["tril"]
FORMS["switch"] = FORMS["where"]

#: Argument forms the JAX package takes that the table leaves out, and why.
EXCLUDED = {
    # ``jnp``'s ``out=``/``where=`` must be None in both packages; the
    # port raises the same ``NotImplementedError`` as ``jnp`` for any
    # other value (tests/test_torch_call_parity.py)
    "maximum(out=, where=)": "jnp rejects any value but None",
    # XLA sharding of the result: the port runs on one device and its
    # ``out_sharding`` must be None (tests/test_torch_signature_surface.py)
    "matmul(out_sharding=)": "a JAX sharding object",
    "ones_like(out_sharding=)": "a JAX sharding object",
    # a device of the result: a ``jax.Device`` against a ``torch.device``
    "ones_like(device=)": "a jax.Device object",
    "full_like(device=)": "a jax.Device object",
    # ``block_diagonal``'s ``format`` is accepted and ignored by both
    # (a scipy sparse format name; neither builds a sparse matrix)
    "block_diagonal(format=)": "ignored by both packages",
}

#: Forms at which the JAX package raises and the port answers as numpy or
#: scipy do, with the reason and that function of the same inputs. They
#: are faults of the reference, kept (ROADMAP, queue 3): the port is held
#: to the numpy answer, in ``floatX``, and the JAX package to raising.
REFERENCE_FAULTS = {
    ("clip", "lower-only"): (
        "the JAX package makes the None bound an object array",
        np.clip),
    ("tril", "positional"): (
        "the JAX package makes k an array, which jnp.tril's static "
        "argument cannot hash", np.tril),
    ("triu", "positional"): (
        "the JAX package makes k an array, which jnp.triu's static "
        "argument cannot hash", np.triu),
    ("probit", "int"): (
        "jax.scipy.special.ndtri takes no integers; scipy's takes them",
        scipy.special.ndtri),
    ("invprobit", "int"): (
        "jax.scipy.special.ndtr takes no integers; scipy's takes them",
        scipy.special.ndtr),
}

#: Forms whose JAX result is float64 at float32 when the operands are
#: arrays: the function's body is numpy indexing or products only, so the
#: JAX package's ``apply`` returns numpy's float64 result without the cast
#: to ``floatX`` that ``as_node`` gives every other constant. With node
#: operands it is float32. The port gives ``floatX`` in both modes; the
#: values are compared as usual.
FLOAT64_AT_FLOAT32 = {
    ("expand_packed_triangular", "diagonal"),
    ("expand_packed_triangular", "upper-diagonal"),
    ("kron_diag", "one"), ("kron_diag", "two"), ("kron_diag", "three"),
    ("kronecker", "one"),
}

#: Host functions: they take arrays and numbers, never nodes, so they have
#: no node form.
HOST = {"eye", "cartesian", "log1mexp_numpy", "floatX_array",
        "largest_common_dtype", "constant"}



def _inputs(name, form):
    args, kwargs = FORMS[name][form](
        np.random.RandomState(zlib.crc32(f"{name}-{form}".encode())))
    return args, kwargs


def _flat(args):
    """``args`` with the items of each list among them in its place."""
    return [a for arg in args for a in (arg if isinstance(arg, list)
                                        else [arg])]


def _arrays_of(args):
    return [a for a in _flat(args) if isinstance(a, np.ndarray)]


def _modes(name, form):
    """How a form's operands are passed: as arrays; as data nodes of a
    model; and, where the form has an array, as data nodes whose graph the
    port evaluates under ``torch.func.vmap``, as a batched logp does."""
    if name in HOST:
        return ("arrays",)
    if not _arrays_of(_inputs(name, form)[0]):
        return ("arrays", "nodes")
    return ("arrays", "nodes", "batched")


CASES = [(name, form, operands) for name in sorted(FORMS)
         for form in FORMS[name] for operands in _modes(name, form)]


def test_every_public_callable_has_forms():
    """The table covers every public callable of ``pymc3_tpu.math``, and
    its entries name forms of the table."""
    public = _public_names(pj.math)
    assert sorted(FORMS) == public
    for name, form in list(REFERENCE_FAULTS) + list(FLOAT64_AT_FLOAT32):
        assert form in FORMS[name], (name, form)


@pytest.fixture(scope="module", params=["float32", "float64"])
def floatx(request):
    prev = jax.config.jax_enable_x64, pj.get_config().floatX
    pj.set_config(floatX=request.param)
    jax.config.update("jax_enable_x64", request.param == "float64")
    pt.set_config(floatX=request.param)
    yield request.param
    pt.set_config(floatX="float32")
    pj.set_config(floatX=prev[1])
    jax.config.update("jax_enable_x64", prev[0])


def _numpy(out):
    """A result of either package as numpy (a node by its value)."""
    if isinstance(out, (jnode.Node, tnode.Node)):
        out = out.test_value
    if isinstance(out, torch.Tensor):
        out = out.detach().cpu().numpy()
    if isinstance(out, np.dtype):
        return out
    return np.asarray(out)


def _as_nodes(pm, args):
    """Each array among ``args`` (and in a list among them) as a named data
    node of the current model: the function builds a graph, and the result
    is its value."""
    count = [0]

    def node(a):
        if isinstance(a, list):
            return [node(x) for x in a]
        if not isinstance(a, np.ndarray):
            return a
        count[0] += 1
        return pm.Data(f"operand{count[0]}", a)
    return [node(a) for a in args]


def _batched(out, nodes):
    """The port's ``out`` evaluated under ``torch.func.vmap`` over two
    copies of each data node among ``nodes``: a leading axis of 2."""
    data = {n.name: n.get_value() for n in _flat(nodes)
            if isinstance(n, tnode.Node)}
    names = list(data)
    rows = torch.func.vmap(lambda *vs: tnode.evaluate(out, dict(zip(
        names, vs))))(*[torch.as_tensor(np.stack([v, v])) for v in
                        data.values()])
    return _numpy(rows)


def _call(pm, name, args, kwargs, operands):
    """The result of ``pm.math.<name>`` as numpy, or the error it raised.
    In the "batched" mode the JAX package gives its "nodes" result (once),
    and the port its two rows."""
    try:
        if operands == "arrays":
            return _numpy(getattr(pm.math, name)(*args, **kwargs))
        with pm.Model():
            nodes = _as_nodes(pm, args)
            out = getattr(pm.math, name)(*nodes, **kwargs)
            if operands == "nodes" or pm is pj:
                return _numpy(out)
            return _batched(out, nodes)
    except Exception as exc:  # noqa: BLE001 (compared below)
        return exc


def _kind(exc):
    if isinstance(exc, (TypeError, ValueError, RuntimeError, IndexError)):
        return "the operands do not fit"
    return type(exc).__name__


def _same_dtype(got, want, floatx):
    if floatx == "float32" and want.kind in "iu" and got.kind in "iu":
        return True
    return got == want


def _close(got, want, floatx):
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, equal_nan=True, **TOL[floatx])


@pytest.mark.parametrize("name,form,operands", CASES,
                         ids=["-".join(c) for c in CASES])
def test_value(floatx, name, form, operands):
    args, kwargs = _inputs(name, form)
    want = _call(pj, name, args, kwargs, operands)
    got = _call(pt, name, args, kwargs, operands)
    if (name, form) in REFERENCE_FAULTS:
        assert isinstance(want, Exception), want
        want = _numpy(REFERENCE_FAULTS[name, form][1](*args, **kwargs))
    elif isinstance(want, Exception) or isinstance(got, Exception):
        assert isinstance(want, Exception) and isinstance(got, Exception), \
            f"JAX: {want!r}; port: {got!r}"
        assert _kind(got) == _kind(want), (want, got)
        return
    if isinstance(want, np.dtype):
        assert got == want
        return
    if operands == "batched":
        assert got.shape[0] == 2, got.shape
    for row in (got if operands == "batched" else [got]):
        if (name, form) in REFERENCE_FAULTS:
            assert row.dtype == np.dtype(floatx), row.dtype
        elif ((name, form) in FLOAT64_AT_FLOAT32 and floatx == "float32"
              and operands == "arrays"):
            assert (want.dtype, row.dtype) == (np.float64, np.float32)
        else:
            assert _same_dtype(row.dtype, want.dtype, floatx), \
                (row.dtype, want.dtype)
        assert row.shape == want.shape
        _close(row, want, floatx)
