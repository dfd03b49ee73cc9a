"""The port's shape algebra (``pymc3_tpu_torch/distributions/
shape_utils.py``) against the JAX package's, cell by cell over the grids
of ``tests/test_shape_utils.py``: the same sizes, shapes and target
shapes, the same result or the same ``ValueError`` from both packages.
The last cells draw from the prior of a hierarchical model in both
packages and compare the shapes of the draws."""
import numpy as np
import pytest
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.distributions import shape_utils as js
from pymc3_tpu_torch.distributions import shape_utils as ts

from .test_shape_utils import TEST_SHAPES, TEST_SIZES, TEST_TO_SHAPES
from . import torch_models  # noqa: F401  (the port on the CPU)


def _both(fn_name, *args, **kwargs):
    """``fn_name`` of both packages on the same arguments: ``("ok",
    result)`` or ``("raises", None)`` for a ``ValueError``."""
    out = []
    for mod in (js, ts):
        try:
            out.append(("ok", getattr(mod, fn_name)(*args, **kwargs)))
        except ValueError:
            out.append(("raises", None))
    return out


def _shapes(result):
    """The shapes of a list of samples (numpy arrays or tensors)."""
    return [tuple(np.shape(o)) for o in result]


@pytest.mark.parametrize("shape", [
    None, (), 3, (3,), [2, 4], np.array(5), np.array([2, 3])], ids=str)
def test_to_tuple(shape):
    assert ts.to_tuple(shape) == js.to_tuple(shape)


@pytest.mark.parametrize("shapes", TEST_SHAPES, ids=str)
@pytest.mark.parametrize("raise_exception", [False, True], ids=str)
def test_shapes_broadcasting(shapes, raise_exception):
    (jk, jv), (tk, tv) = _both("shapes_broadcasting", *shapes,
                               raise_exception=raise_exception)
    assert (tk, tv) == (jk, jv)


@pytest.mark.parametrize("size", TEST_SIZES, ids=str)
@pytest.mark.parametrize("shapes", TEST_SHAPES, ids=str)
def test_broadcast_dist_samples_shape(size, shapes):
    (jk, jv), (tk, tv) = _both("broadcast_dist_samples_shape", shapes,
                               size=size)
    assert (tk, tv) == (jk, jv)


@pytest.mark.parametrize("size", TEST_SIZES, ids=str)
@pytest.mark.parametrize("shapes", TEST_SHAPES, ids=str)
def test_broadcast_distribution_samples(size, shapes):
    samples = [np.zeros(s) for s in shapes]
    (jk, jv), (tk, tv) = _both("broadcast_distribution_samples", samples,
                               size=size)
    assert tk == jk
    if jk == "ok":
        assert _shapes(tv) == _shapes(jv)


@pytest.mark.parametrize("size", TEST_SIZES, ids=str)
@pytest.mark.parametrize("shapes", TEST_SHAPES, ids=str)
def test_get_broadcastable_dist_samples(size, shapes):
    """Tensors in, tensors out, of the JAX package's shapes."""
    (jk, jv), _ = _both("get_broadcastable_dist_samples",
                        [np.zeros(s) for s in shapes], size=size,
                        return_out_shape=True)
    try:
        tv = ts.get_broadcastable_dist_samples(
            [torch.zeros(s) for s in shapes], size=size,
            return_out_shape=True)
        tk = "ok"
    except ValueError:
        tk = "raises"
    assert tk == jk
    if jk == "ok":
        assert tv[1] == jv[1]
        assert _shapes(tv[0]) == _shapes(jv[0])
        assert all(isinstance(o, torch.Tensor) for o in tv[0])


@pytest.mark.parametrize("to_shape", TEST_TO_SHAPES, ids=str)
@pytest.mark.parametrize("size", TEST_SIZES, ids=str)
@pytest.mark.parametrize("shapes", TEST_SHAPES[:4], ids=str)
def test_broadcast_dist_samples_to(to_shape, size, shapes):
    samples = [np.zeros(s) for s in shapes]
    (jk, jv), (tk, tv) = _both("broadcast_dist_samples_to", to_shape,
                               samples, size=size)
    assert tk == jk
    if jk == "ok":
        assert _shapes(tv) == _shapes(jv)


def _hierarchical(pm, n=5, dim=4):
    with pm.Model() as model:
        cov = pm.InverseGamma("cov", alpha=1.0, beta=1.0)
        pm.Normal("x", mu=np.ones(dim), sigma=pm.math.sqrt(cov),
                  shape=(n, dim))
        pm.HalfNormal("eps", sigma=np.ones((n, 1)), shape=(n, dim))
        pm.Normal("y", mu=1.0, sigma=1.0, shape=(n,))
    return model


@pytest.mark.parametrize("samples", [None, (), 1, (1,), 10, (5,), (5, 4)],
                         ids=str)
def test_prior_predictive_shapes(samples):
    """Prior draws of the port have the JAX package's shapes, and are
    finite (``tests/test_shape_utils.py::
    test_prior_predictive_shape_contract``)."""
    with _hierarchical(pj):
        want = pj.sample_prior_predictive(samples=samples, random_seed=3)
    with _hierarchical(pt):
        got = pt.sample_prior_predictive(samples=samples, random_seed=3)
    for name in ("cov", "x", "eps", "y"):
        assert np.shape(got[name]) == np.shape(want[name]), name
        assert np.all(np.isfinite(got[name])), name
