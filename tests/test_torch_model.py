"""The port's model layer against the JAX package's: flat ordering and the
batched logp + gradient of the GP-regression and radon models.

Tolerance of the logp/gradient comparison: rtol 1e-4 in float32. Both
packages evaluate the same formulas; they differ only in summation order
(919-row likelihood sums, a 30x30 cholesky in LAPACK against XLA), which
moves float32 results by a few 1e-6 relative.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.examples.radon import build_model, load_radon

from .torch_models import gp_model

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import bench  # noqa: E402

torch.set_num_threads(2)
RTOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _pair(name):
    if name == "gp":
        return gp_model(pj), gp_model(pt)
    return bench.build_model(pj), build_model(pt)


@pytest.mark.parametrize("name", ["gp", "radon"])
def test_flat_ordering_matches(name):
    mj, mt = _pair(name)
    assert [(v.var, v.slc, v.shp) for v in mj.ordering.vmap] == \
        [(v.var, v.slc, v.shp) for v in mt.ordering.vmap]
    point = {k: np.asarray(v) for k, v in mj.test_point.items()}
    np.testing.assert_array_equal(convert.point_to_q(mt, point).numpy(),
                                  mj.dict_to_array(point))
    for k, v in mt.test_point.items():
        np.testing.assert_allclose(v, mj.test_point[k], rtol=1e-6)


@pytest.mark.parametrize("name", ["gp", "radon"])
def test_batched_logp_dlogp_matches_jax(name):
    mj, mt = _pair(name)
    rng = np.random.RandomState(7)
    q0 = mj.dict_to_array(mj.test_point)
    q = (q0[None] + rng.uniform(-0.5, 0.5, (3, q0.size))).astype(np.float32)
    lj, gj = jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn))(jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert lt.shape == (3,) and gt.shape == (3, q0.size)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL)
    scale = np.abs(np.asarray(gj)).max()
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=RTOL * scale)
    assert mt.logp(mt.test_point) == pytest.approx(mj.logp(mj.test_point),
                                                   rel=RTOL)


def test_radon_data_matches_pandas_reader():
    floor, county_idx, n_counties, log_radon = load_radon()
    import pandas as pd
    data = pd.read_csv(bench.__file__.replace("bench.py", os.path.join(
        "pymc3_tpu", "examples", "data", "radon.csv")))
    np.testing.assert_array_equal(floor, data.floor.values)
    np.testing.assert_array_equal(county_idx, data.county_code.values)
    assert n_counties == len(data.county.unique()) == 85
    np.testing.assert_array_equal(log_radon,
                                  data.log_radon.astype(np.float32).values)


def test_gather_index_is_int64_device_constant():
    with pt.Model():
        a = pt.Normal("a", 0.0, 1.0, shape=4)
        g = a[np.array([3, 0, 0, 2], dtype=np.int32)]
    idx = g.args[1]
    assert isinstance(idx, pt.node.ConstantNode)
    assert idx.value.dtype == torch.int64
    np.testing.assert_array_equal(
        g.eval({"a": torch.arange(4.0)}).numpy(), [3.0, 0.0, 0.0, 2.0])


def test_non_pd_covariance_gives_minus_inf_not_an_error():
    """jsl.cholesky returns NaN on a non-PD matrix and the JAX MvNormal
    turns that into logp = -inf; the port gets there through
    cholesky_ex's info flag, without raising or syncing."""
    with pt.Model() as m:
        s = pt.HalfNormal("s", sigma=1.0)
        cov = pt.node.apply(lambda v: torch.tensor(
            [[1.0, 2.0], [2.0, 1.0]]) * v, s)
        pt.MvNormal("y", mu=np.zeros(2), cov=cov,
                    observed=np.array([0.1, -0.2]))
    q = torch.zeros(2, 1)
    logp, grad = m.logp_dlogp_function()(q)
    assert torch.isneginf(logp).all()
