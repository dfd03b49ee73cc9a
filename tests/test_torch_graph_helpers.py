"""The port's graph and helper names against the JAX package's on the CPU,
mirroring ``tests/test_jaxf.py``, ``tests/test_util_helpers.py`` and
``tests/test_math_matrix.py``: ``util`` (``biwrap``,
``get_untransformed_name``), ``memoize``, ``math`` (``flat_outer``,
``log1mexp_numpy``, ``largest_common_dtype``, ``floatX_array``), ``node``
(``evaluate_many``, ``constant_fold``), ``blocking`` (the list orderings,
``DictToVarBijection``, ``Compose``), ``torchf`` (the counterpart of
``jaxf``), ``TensorType`` and ``dist_math.MvNormal_logp``.

Tolerances: rtol 1e-5 and atol 1e-5 on float32 values; ``MvNormal_logp``
against scipy at ``test_math_matrix.py``'s 1e-5 x 1e4 (float32 Cholesky of
a 3 x 3 covariance).
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import blocking as jb, math as jmath, node as jnode, \
    util as ju
from pymc3_tpu.distributions import dist_math as jdm
from pymc3_tpu.memoize import hashable as jhashable
from pymc3_tpu_torch import blocking as tb, math as tmath, node as tnode, \
    util as tu
from pymc3_tpu_torch.memoize import hashable, memoize
from pymc3_tpu_torch.distributions import dist_math as tdm

from . import torch_models  # noqa: F401  (the port on the CPU)

TOL = dict(rtol=1e-5, atol=1e-5)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(getattr(x, "test_value", x))


# -- util.py ------------------------------------------------------------------
@pytest.mark.parametrize("name", ["sigma_log__", "x_interval__",
                                  "a_b_stickbreaking__", "p_logodds__"])
def test_get_untransformed_name(name):
    assert tu.get_untransformed_name(name) == ju.get_untransformed_name(name)


@pytest.mark.parametrize("name", ["x", "x_log", "log__"])
def test_get_untransformed_name_rejects_a_plain_name(name):
    for mod in (ju, tu):
        with pytest.raises(ValueError):
            mod.get_untransformed_name(name)


def test_biwrap_with_and_without_arguments():
    def results(mod):
        @mod.biwrap
        def scale(fn, factor=2):
            return lambda x: factor * fn(x)

        @scale
        def f(x):
            return x + 1

        @scale(factor=5)
        def g(x):
            return x + 1
        return f(1), g(1)
    assert results(tu) == results(ju) == (4, 10)


# -- memoize.py ---------------------------------------------------------------
def test_memoize_and_clear_cache():
    calls = []

    @memoize
    def f(a, b=None):
        calls.append((a, b))
        return len(calls)

    assert f(1, b=[1, 2]) == f(1, b=[1, 2]) == 1
    assert f(np.arange(3)) == 2 and f(np.arange(3)) == 2
    pt.clear_cache()
    assert f(1, b=[1, 2]) == 3


@pytest.mark.parametrize("value", [
    {"a": [1, 2], "b": (3, {"c": 4})}, [1, [2, 3]], "s", 3.5,
    np.arange(4.0)], ids=["dict", "list", "str", "float", "array"])
def test_hashable_is_the_jax_packages(value):
    assert hashable(value) == jhashable(value)
    hash(hashable(value))


# -- math.py ------------------------------------------------------------------
def test_flat_outer():
    a, b = np.array([1.0, 2.0]), np.array([3.0, 4.0, 5.0])
    np.testing.assert_allclose(_np(tmath.flat_outer(a, b)),
                               _np(jmath.flat_outer(a, b)), **TOL)
    with pt.Model():
        x = pt.Normal("x", 0.0, 1.0, shape=2)
        node = tmath.flat_outer(x, b)
    np.testing.assert_allclose(node.eval({"x": torch.tensor([1.0, -2.0])}),
                               np.outer([1.0, -2.0], b).ravel(), **TOL)


def test_log1mexp_numpy():
    x = np.array([1e-4, 0.1, 0.6, 1.0, 5.0, 40.0])
    np.testing.assert_allclose(tmath.log1mexp_numpy(x),
                               jmath.log1mexp_numpy(x), rtol=1e-12)


@pytest.mark.parametrize("dtypes", [("float32", "int64"), ("int8", "int32"),
                                    ("float32", "float64"), ("bool",)])
def test_largest_common_dtype(dtypes):
    arrays = [np.zeros(2, d) for d in dtypes]
    assert tmath.largest_common_dtype(arrays) == \
        jmath.largest_common_dtype(arrays)


def test_floatX_array():
    x = [1, 2.5]
    assert tmath.floatX_array(x).dtype == jmath.floatX_array(x).dtype
    np.testing.assert_array_equal(tmath.floatX_array(x),
                                  jmath.floatX_array(x))


# -- node.py ------------------------------------------------------------------
def _xy(pm):
    with pm.Model() as model:
        x = pm.Normal("x", 0.0, 1.0, shape=3)
        y = pm.HalfNormal("y", 1.0)
    return model, x, y


def test_evaluate_many_shares_one_memo():
    out = []
    for pm, node in ((pj, jnode), (pt, tnode)):
        model, x, y = _xy(pm)
        s = x * 2
        env = {"x": np.array([1.0, 2.0, 3.0], "f"), "y": np.float32(0.5)}
        if pm is pt:
            env = {k: torch.as_tensor(v) for k, v in env.items()}
        out.append([_np(v) for v in node.evaluate_many(
            [s, s + y, (s * y).sum()], env)])
    for got, want in zip(*out[::-1]):
        np.testing.assert_allclose(got, want, **TOL)


def test_constant_fold():
    for pm, node in ((pj, jnode), (pt, tnode)):
        model, x, y = _xy(pm)
        np.testing.assert_allclose(node.constant_fold(x + 1),
                                   x.test_value + 1, **TOL)
        np.testing.assert_allclose(
            node.constant_fold(node.as_node(np.arange(3.0)) * 2),
            np.arange(3.0) * 2, **TOL)
        free = node.NamedNode.__new__(node.NamedNode)
        free.name = "unbound"
        free._test_value = np.float32(0.0)
        assert node.constant_fold(free + 1) is None


# -- blocking.py --------------------------------------------------------------
ARRAYS = [np.arange(3.0), np.ones((2, 2), "f"), np.array(7, "int64")]


def test_list_array_ordering_and_bijection():
    jo, to = jb.ListArrayOrdering(ARRAYS), tb.ListArrayOrdering(ARRAYS)
    assert to.size == jo.size
    assert [tuple(v) for v in to.vmap] == [tuple(v) for v in jo.vmap]
    jbij = jb.ListToArrayBijection(jo, ARRAYS)
    tbij = tb.ListToArrayBijection(to, ARRAYS)
    flat = tbij.fmap(ARRAYS)
    np.testing.assert_array_equal(flat, jbij.fmap(ARRAYS))
    for got, want in zip(tbij.rmap(flat), jbij.rmap(flat)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tbij.mapf(lambda xs: len(xs))(flat) == 3


def test_dict_to_var_bijection():
    point = {"a": np.arange(6.0).reshape(2, 3), "b": np.ones(2)}
    for idx in [(1, 2), (0, slice(None))]:
        jbij = jb.DictToVarBijection("a", idx, point)
        tbij = tb.DictToVarBijection("a", idx, point)
        np.testing.assert_array_equal(tbij.map(point), jbij.map(point))
        got, want = tbij.rmap(-1.0), jbij.rmap(-1.0)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
        assert tbij.mapf(lambda p: p["a"].sum())(0.0) == \
            jbij.mapf(lambda p: p["a"].sum())(0.0)


def test_compose():
    assert tb.Compose(str, abs)(-3) == jb.Compose(str, abs)(-3) == "3"


def test_dict_to_array_bijection_mapf():
    model, x, y = _xy(pt)
    bij = model.bijection
    q = bij.map({"x": np.array([1.0, 2.0, 3.0]), "y_log__": np.float32(0.1)})
    assert bij.mapf(lambda p: float(p["x"].sum()))(q) == 6.0


# -- torchf.py (jaxf.py's surface) --------------------------------------------
def _simple(pm):
    with pm.Model() as m:
        pm.Normal("x", 0, 1, shape=3)
        pm.HalfNormal("s", 1.0)
        pm.Normal("y", 0.0, 1.0, observed=np.ones(4, "f"))
    return m


def test_smartfloatX():
    for x in (np.zeros(2, np.float64), np.zeros(2, np.int64), [1.5]):
        assert pt.smartfloatX(x).dtype == pj.smartfloatX(x).dtype


def test_join_nonshared_inputs():
    jm, tm = _simple(pj), _simple(pt)
    jxs, jjoined = pj.join_nonshared_inputs([jm.logpt], jm.free_RVs, {})
    txs, tjoined = pt.join_nonshared_inputs([tm.logpt], tm.free_RVs, {})
    np.testing.assert_allclose(tjoined.test_value, jjoined.test_value, **TOL)
    q = np.array([0.2, -0.1, 0.4, 0.3], "f")
    np.testing.assert_allclose(
        float(txs[0].eval({"__joined__": torch.as_tensor(q)})),
        float(jxs[0].eval({"__joined__": q})), **TOL)


def test_join_with_shared_replacements():
    jm, tm = _simple(pj), _simple(pt)
    out = []
    for pm, m in ((pj, jm), (pt, tm)):
        x = [v for v in m.free_RVs if v.name == "x"][0]
        shared = pm.make_shared_replacements([x], m)
        assert {getattr(k, "name", k) for k in shared} == {"s_log__"}
        xs, _ = pm.join_nonshared_inputs([m.logpt], [x], shared)
        q = np.array([0.5, 0.0, -1.0], "f")
        out.append(float(xs[0].eval({"__joined__": torch.as_tensor(q)
                                     if pm is pt else q})))
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_callable_tensor():
    out = []
    for pm in (pj, pt):
        with pm.Model():
            x = pm.Normal("x", 0.0, 1.0, shape=2)
        f = pm.CallableTensor((x ** 2).sum())
        out.append(_np(f(np.array([3.0, 4.0], "f"))))
    np.testing.assert_allclose(out[1], out[0], **TOL)


def test_generator_node():
    for pm in (pj, pt):
        def gen():
            while True:
                yield np.ones(3, "f") * 2
        node = pm.generator(gen())
        np.testing.assert_array_equal(node.test_value, np.ones(3) * 2)


def test_tt_rng_seed_reproducible():
    pt.set_tt_rng(11)
    a = pt.tt_rng().normal(size=5)
    pt.set_tt_rng(11)
    b = pt.tt_rng().normal(size=5)
    assert isinstance(a, torch.Tensor) and a.dtype == torch.float32
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = pt.tt_rng(random_seed=11).uniform(size=(2, 2))
    assert c.shape == (2, 2) and bool(((c >= 0) & (c < 1)).all())
    assert isinstance(pt.tt_rng().generator, torch.Generator)


@pytest.mark.parametrize("axis", [0, 1])
def test_take_along_axis(axis):
    a = np.arange(12.0).reshape(3, 4)
    idx = np.array([[0], [3], [1]]) if axis == 1 else np.array([[2, 0, 1, 0]])
    want = np.asarray(pj.take_along_axis(a, idx, axis=axis))
    np.testing.assert_array_equal(_np(pt.take_along_axis(a, idx, axis=axis)),
                                  want)
    with pt.Model():
        x = pt.Normal("x", 0.0, 1.0, shape=(3, 4))
        node = pt.take_along_axis(x, idx, axis=axis)
    np.testing.assert_array_equal(node.eval({"x": torch.as_tensor(a)}),
                                  want)


# -- distributions ------------------------------------------------------------
def test_tensor_type_and_vectorized_ppc():
    from pymc3_tpu.distributions import distribution as jd
    from pymc3_tpu_torch.distributions import distribution as td
    assert pt.TensorType("float32", (2, 3)) == pj.TensorType("float32",
                                                              (2, 3))
    assert type(td.vectorized_ppc) is type(jd.vectorized_ppc)
    assert td.vectorized_ppc.get() is None


def test_mvnormal_logp_batched_and_rejecting():
    """``tests/test_math_matrix.py::test_mvnormal_logp_kernel``'s cases,
    against the JAX package and scipy."""
    rng = np.random.default_rng(9)
    A = rng.normal(size=(3, 3))
    cov = A @ A.T + 3 * np.eye(3)
    delta = rng.normal(size=(4, 3))
    want = st.multivariate_normal.logpdf(delta, np.zeros(3), cov)
    tol = dict(rtol=1e-1, atol=1e-1)
    for d, shape in ((delta, (4,)), (delta[0], ()),
                     (delta.reshape(2, 2, 3), (2, 2))):
        got = _np(tdm.MvNormal_logp(cov, d))
        assert got.shape == shape
        np.testing.assert_allclose(got.ravel(), np.ravel(want[:got.size]),
                                   **tol)
        np.testing.assert_allclose(got, np.asarray(jdm.MvNormal_logp(cov, d)),
                                   rtol=1e-5, atol=1e-4)
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    assert _np(tdm.MvNormal_logp(bad, np.array([0.1, 0.2]))) == -np.inf
    assert np.asarray(jdm.MvNormal_logp(bad, np.array([0.1, 0.2]))) == -np.inf


def test_mvnormal_logp_gradient():
    cov = torch.tensor([[2.0, 0.3], [0.3, 1.0]], requires_grad=True)
    delta = torch.tensor([[0.5, -0.2], [1.0, 0.4]])
    tdm.MvNormal_logp(cov, delta).sum().backward()
    prec = torch.linalg.inv(cov.detach())
    want = sum(-0.5 * (prec - prec @ d[:, None] @ d[None] @ prec)
               for d in delta)
    np.testing.assert_allclose(cov.grad.numpy(), want.numpy(), **TOL)
