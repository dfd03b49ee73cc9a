"""The port's transforms against the JAX package's, and the model repairs
they need.

- forward / backward / jacobian_det of every transform on the same float32
  inputs: rtol 1e-5, atol 1e-6 (the same formulas; XLA and torch round
  ``expit``/``softplus`` differently in the last bit);
- round trips and ``forward_shape``;
- model cells (``MODEL_CELLS``, ``ORDERED_CELLS`` of
  ``tests/test_transforms_matrix.py``): test point, ``ndim``, logp and
  gradient at a seeded point, rtol 1e-4;
- the repairs: a ``Uniform`` whose bounds are random variables (the
  transform reads its bounds from the evaluation environment) and a
  ``Dirichlet`` whose unconstrained space is one shorter than its own.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.distributions import transforms as jtr
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu_torch.distributions import transforms as ttr
from . import torch_models  # noqa: F401  (asks the port for the CPU)

from .test_transforms_matrix import ELEMENTWISE, MODEL_CELLS, ORDERED_CELLS

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
MODEL_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def port_transform(t):
    """The port's transform equal to the JAX package's ``t``."""
    name = type(t).__name__
    if name == "Interval":
        return ttr.Interval(t.a.test_value, t.b.test_value)
    if name == "LowerBound":
        return ttr.LowerBound(t.a.test_value)
    if name == "UpperBound":
        return ttr.UpperBound(t.b.test_value)
    if name == "Chain":
        return ttr.Chain([port_transform(s) for s in t.transform_list])
    if name == "CholeskyCovPacked":
        return ttr.CholeskyCovPacked(t.n)
    return getattr(ttr, name)()


def _both(fn_name, jt, tt, x):
    want = np.asarray(getattr(jt, fn_name)(jnp.asarray(x)))
    got = getattr(tt, fn_name)(torch.from_numpy(x)).numpy()
    return got, want


# (transform, a point in its unconstrained space)
VECTOR_CELLS = [
    ("ordered", jtr.ordered, np.array([0.3, -1.0, 0.5, -0.2])),
    ("sumto1", jtr.sum_to_1, np.array([0.2, 0.3, 0.1])),
    ("stickbreaking", jtr.stick_breaking, np.array([0.4, -0.7, 1.1])),
    ("stickbreaking-batch", jtr.stick_breaking,
     np.array([[0.4, -0.7, 1.1], [-2.0, 0.0, 3.0]])),
    ("circular", jtr.circular, np.array([-3.0, 0.0, 2.0, 5.0])),
    ("cholesky-packed", jtr.CholeskyCovPacked(3),
     np.array([0.1, -0.4, 0.3, 0.9, 0.2, -0.6])),
    ("chain-log-ordered", jtr.Chain([jtr.log, jtr.ordered]),
     np.array([0.2, -0.8, 0.4])),
]
ALL_CELLS = [(n, t, z) for n, t, z in ELEMENTWISE] + VECTOR_CELLS


@pytest.mark.parametrize("name,jt,zs", ALL_CELLS,
                         ids=[c[0] for c in ALL_CELLS])
def test_transform_matches_jax(name, jt, zs):
    tt = port_transform(jt)
    z = zs.astype(np.float32)
    x_got, x_want = _both("backward", jt, tt, z)
    np.testing.assert_allclose(x_got, x_want, **TOL)
    j_got, j_want = _both("jacobian_det", jt, tt, z)
    np.testing.assert_allclose(np.broadcast_to(j_got, np.shape(j_want)),
                               j_want, **TOL)
    if name == "circular":  # backward wraps: forward is the identity only
        z = np.arctan2(np.sin(z), np.cos(z)).astype(np.float32)
    x = x_want.astype(np.float32)
    z_got, z_want = _both("forward", jt, tt, x)
    np.testing.assert_allclose(z_got, z_want, **TOL)
    # round trip
    np.testing.assert_allclose(
        tt.forward(tt.backward(torch.from_numpy(z))).numpy(), z,
        rtol=1e-4, atol=1e-5)
    assert tt.forward_shape(x.shape) == tuple(jt.forward_shape(x.shape)) \
        == z.shape
    assert tt.backward_shape(z.shape) == x.shape


def test_jacobians_match_autograd():
    """Each elementwise jacobian_det is log|d backward/dz| (torch autograd)."""
    for name, jt, zs in ELEMENTWISE:
        tt = port_transform(jt)
        z = torch.tensor(zs, dtype=torch.float32, requires_grad=True)
        g, = torch.autograd.grad(tt.backward(z).sum(), z)
        np.testing.assert_allclose(
            np.broadcast_to(tt.jacobian_det(z).detach().numpy(), zs.shape),
            np.log(np.abs(g.numpy())), rtol=1e-4, atol=1e-5, err_msg=name)


def test_stickbreaking_jacobian_matches_slogdet():
    z = torch.tensor([0.4, -0.7, 1.1], dtype=torch.float64)
    J = torch.autograd.functional.jacobian(
        lambda w: ttr.stick_breaking.backward(w)[:-1], z)
    np.testing.assert_allclose(
        float(ttr.stick_breaking.jacobian_det(z)),
        float(torch.linalg.slogdet(J)[1]), rtol=1e-10)


def test_symbolic_interval_bounds_read_the_environment():
    with pt.Model():
        a = pt.Normal("a", 0.0, 1.0)
        t = ttr.Interval(a, a + 2.0)
    z = torch.tensor([0.0, 1.0])
    env = {"a": torch.tensor(5.0)}
    np.testing.assert_allclose(t.backward(z, env).numpy(),
                               5.0 + 2.0 * torch.sigmoid(z).numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(
        t.forward(t.backward(z, env), env).numpy(), z.numpy(), atol=1e-5)
    # without the environment the bound takes its test value (0)
    np.testing.assert_allclose(t.backward(z).numpy(),
                               2.0 * torch.sigmoid(z).numpy(), rtol=1e-6)


# -- model-level cells -------------------------------------------------------
def _model_pair(build):
    return build(pj), build(pt)


def check_model_parity(mj, mt, seed=0, scale=0.8, n=4):
    assert mt.ndim == mj.ndim
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    for k, v in mj.test_point.items():
        np.testing.assert_allclose(mt.test_point[k], v, rtol=1e-6,
                                   atol=1e-7, err_msg=k)
    rng = np.random.default_rng(seed)
    q0 = mj.dict_to_array(mj.test_point)
    q = (q0[None] + rng.normal(scale=scale, size=(n, q0.size))
         ).astype(np.float32)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * scale)


def _cell_builder(cls_name, params, shape, transform=None):
    def build(pm):
        kwargs = dict(params)
        if shape is not None:
            kwargs["shape"] = shape
        if transform is not None:
            kwargs["transform"] = transform(pm)
        with pm.Model() as m:
            getattr(pm, cls_name)("x", **kwargs)
        return m
    return build


@pytest.mark.parametrize("name,cls,params,shape", MODEL_CELLS,
                         ids=[c[0] for c in MODEL_CELLS])
def test_model_cell_matches_jax(name, cls, params, shape):
    mj, mt = _model_pair(_cell_builder(cls.__name__, params, shape))
    assert mt.free_RVs[0].transform.name == mj.free_RVs[0].transform.name
    check_model_parity(mj, mt)


@pytest.mark.parametrize("name,cls,params,transform", ORDERED_CELLS,
                         ids=[c[0] for c in ORDERED_CELLS])
def test_ordered_cell_matches_jax(name, cls, params, transform):
    def tr(pm):
        return transform if pm is pj else port_transform(transform)
    mj, mt = _model_pair(_cell_builder(cls.__name__, params, (4,), tr))
    # an ordered start point: the test point is not ordered
    check_model_parity(mj, mt, scale=0.3)


def _uniform_rv_bounds(pm):
    with pm.Model() as m:
        lo = pm.Normal("lo", mu=0.0, sigma=1.0)
        width = pm.HalfNormal("width", sigma=2.0)
        x = pm.Uniform("x", lower=lo, upper=lo + width, shape=3)
        pm.Normal("y", mu=x, sigma=0.5, observed=np.array([0.1, 0.4, 0.9]))
    return m


def test_uniform_with_random_variable_bounds():
    """The interval transform reads its bounds (other random variables)
    from the evaluation environment, decoded before it."""
    mj, mt = _model_pair(_uniform_rv_bounds)
    check_model_parity(mj, mt, seed=1)
    # the decoded x lies inside the bounds drawn at the same point
    q = torch.tensor(np.random.default_rng(2).normal(size=(5, mt.ndim)),
                     dtype=torch.float32)
    for row in q:
        env = mt._env_from_q(row)
        lo, hi = env["lo"], env["lo"] + torch.exp(env["width_log__"])
        assert bool(((env["x"] > lo) & (env["x"] < hi)).all())


def _dirichlet3(pm):
    with pm.Model() as m:
        pm.Dirichlet("w", a=np.array([1.5, 2.5, 3.0]))
    return m


def test_dirichlet_in_a_model():
    """K = 3 weights sample in a 2-dimensional space (forward_shape)."""
    mj, mt = _model_pair(_dirichlet3)
    assert mt.ndim == mj.ndim == 2
    assert mt.free_RVs[0].unconstrained_shape == (2,)
    assert mt.test_point["w_stickbreaking__"].shape == (2,)
    check_model_parity(mj, mt, seed=3)
