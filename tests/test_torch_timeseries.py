"""The port's time-series family against the JAX package, on the grids of
``tests/test_timeseries_matrix.py``, and the slice's three example models
(LKJ, stochastic volatility, GARCH) as wholes.

GARCH(1,1)'s volatility is a ``lax.scan`` in the JAX package and one
Toeplitz product with powers of beta in the port; the two are held
together at beta in {0, 0.5, 0.98}, in value and in gradient (the port's
gradient at beta = 0 passes through ``pow(0, 0)``).

Tolerances (float32 in both packages):

- logp: rtol = atol = 2e-3 (the JAX grids' own), and the same support;
- gradients of a summed logp against ``jax.grad``: rtol 1e-3, atol 1e-3
  x max(1, the largest gradient of that argument);
- model logp and gradient at the test point and at random points:
  rtol 1e-4, atol 1e-4 x max(1, the largest gradient). GARCH's series of
  100 and the stochastic-volatility model's 400 steps sum in different
  orders in the two packages, so those two compare at rtol 2e-4.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from . import torch_models  # noqa: F401  (asks the port for the CPU)

from .test_timeseries_matrix import SERIES

torch.set_num_threads(2)
TOL = 2e-3
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _both(cls, **kwargs):
    return (getattr(pj, cls).dist(**kwargs), getattr(pt, cls).dist(**kwargs))


def _assert_logp(dj, dt, x, tol=TOL):
    x = np.asarray(x, dtype=np.float32)
    want = np.asarray(dj.logp(x), dtype=np.float64)
    got = dt.logp(torch.from_numpy(x)).numpy().astype(np.float64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=tol, atol=tol)


@pytest.mark.parametrize("k", [-0.9, -0.3, 0.0, 0.5, 0.95])
@pytest.mark.parametrize("tau_e", [0.25, 1.0, 4.0])
def test_ar1_logp_matches_jax(k, tau_e):
    _assert_logp(*_both("AR1", k=k, tau_e=tau_e), SERIES)


@pytest.mark.parametrize("rho,constant", [
    ([0.5], False), ([0.9], False), ([-0.6], False), ([0.5, -0.3], False),
    ([0.2, 0.1, -0.2], False), ([0.7, 0.5], True),
    ([0.1, 0.4, -0.2, 0.1], True),
])
@pytest.mark.parametrize("sigma", [0.5, 1.7])
def test_ar_logp_matches_jax(rho, constant, sigma):
    rho = np.array(rho, dtype=np.float32)
    _assert_logp(*_both("AR", rho=rho, sigma=sigma, constant=constant,
                        shape=len(SERIES)), SERIES, tol=10 * TOL)


@pytest.mark.parametrize("mu", [-0.5, 0.0, 0.3])
@pytest.mark.parametrize("sigma", [0.25, 1.0, 3.0])
def test_grw_logp_matches_jax(mu, sigma):
    dj, dt = _both("GaussianRandomWalk", mu=mu, sigma=sigma,
                   shape=len(SERIES))
    _assert_logp(dj, dt, SERIES, tol=10 * TOL)
    init = dict(mu=mu, sigma=sigma, shape=len(SERIES))
    dj = pj.GaussianRandomWalk.dist(init=pj.Normal.dist(0.0, 2.0), **init)
    dt = pt.GaussianRandomWalk.dist(init=pt.Normal.dist(0.0, 2.0), **init)
    _assert_logp(dj, dt, SERIES, tol=10 * TOL)


GARCH_CELLS = [(omega, a1, b1, iv)
               for omega, a1 in ((0.1, 0.1), (0.5, 0.4), (1.0, 0.05))
               for b1 in (0.0, 0.5, 0.98)
               for iv in (0.5, 1.0)]


@pytest.mark.parametrize("omega,a1,b1,iv", GARCH_CELLS)
def test_garch_logp_matches_jax(omega, a1, b1, iv):
    _assert_logp(*_both("GARCH11", omega=omega, alpha_1=a1, beta_1=b1,
                        initial_vol=iv, shape=len(SERIES)), SERIES)


def _garch_logp_sum(vol_fn, lib, x, omega, a1, b1, iv):
    vol = vol_fn(x, omega, a1, b1, iv)
    return lib.sum(-0.5 * (x / vol) ** 2 - lib.log(vol))


@pytest.mark.parametrize("b1", [0.0, 0.5, 0.98])
def test_garch_gradient_matches_jax_scan(b1):
    """d/d(x, omega, alpha, beta, initial_vol) of the summed logp, over a
    series of 100 (the example's length): the port's Toeplitz form against
    the JAX package's scan."""
    x = np.random.RandomState(1).normal(0, 1, 100).astype(np.float32)
    args = [np.float32(v) for v in (0.3, 0.2, b1, 1.0)]
    dj, dt = _both("GARCH11", omega=0.3, alpha_1=0.2, beta_1=b1,
                   initial_vol=1.0, shape=100)
    want = jax.jit(jax.grad(lambda *a: _garch_logp_sum(dj._vol, jnp, *a),
                            argnums=tuple(range(5))))(jnp.asarray(x), *args)
    ts = [torch.tensor(a, requires_grad=True) for a in [x] + args]
    lp = _garch_logp_sum(dt._vol, torch, *ts)
    got = torch.autograd.grad(lp, ts)
    for g, w in zip(got, want):
        w = np.asarray(w, dtype=np.float64)
        assert np.all(np.isfinite(g.numpy()))
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_RTOL,
            atol=GRAD_RTOL * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("dt_", [0.01, 0.1, 0.5])
@pytest.mark.parametrize("theta,s", [(0.5, 0.3), (2.0, 1.0)])
def test_euler_maruyama_logp_matches_jax(dt_, theta, s):
    def ou(x, theta, s):
        return -theta * x, s
    _assert_logp(*_both("EulerMaruyama", dt=dt_, sde_fn=ou,
                        sde_pars=(theta, s), shape=len(SERIES)), SERIES)


MV_COVS = [np.eye(2), np.array([[1.0, 0.3], [0.3, 2.0]]),
           np.array([[2.0, -0.9], [-0.9, 0.5]])]


@pytest.mark.parametrize("param", ["cov", "chol", "tau"])
@pytest.mark.parametrize("cov", MV_COVS, ids=["eye", "pos", "neg"])
def test_mv_random_walks_match_jax(cov, param):
    kw = {"cov": dict(cov=cov), "chol": dict(chol=np.linalg.cholesky(cov)),
          "tau": dict(tau=np.linalg.inv(cov))}[param]
    x = np.random.default_rng(7).normal(size=(6, 2)).astype(np.float32)
    _assert_logp(*_both("MvGaussianRandomWalk", mu=np.zeros(2), shape=(6, 2),
                        **kw), x, tol=3e-3)
    for nu in (3.0, 10.0):
        _assert_logp(*_both("MvStudentTRandomWalk", nu=nu, mu=np.zeros(2),
                            shape=(6, 2), **kw), x, tol=3e-3)


def test_draws_of_ar1_and_grw():
    n = 20000
    gen = torch.Generator().manual_seed(3)
    y = pt.GaussianRandomWalk.dist(mu=0.5, sigma=2.0, shape=50).random(
        size=400, gen=gen).astype(np.float64)
    inc = np.diff(y, axis=-1).ravel()
    assert abs(inc.mean() - 0.5) < 4 * 2.0 / np.sqrt(inc.size)
    assert abs(inc.std() / 2.0 - 1) < 4 / np.sqrt(2 * inc.size)
    k, tau_e = 0.7, 2.0
    y = pt.AR1.dist(k=k, tau_e=tau_e, shape=5).random(
        size=n, gen=gen).astype(np.float64)
    var = 1.0 / (tau_e * (1 - k ** 2))
    # stationary from the start: every column has the same variance
    assert np.all(np.abs(y.var(0) / var - 1) < 4 * np.sqrt(2.0 / n))
    r1 = np.mean(y[:, 1:] * y[:, :-1]) / var
    assert abs(r1 - k) < 4 * np.sqrt((1 + k ** 2) / (4 * n))


# -- models -------------------------------------------------------------------
def _ts_model(pm):
    x2 = np.random.default_rng(9).normal(size=(8, 2)).astype(np.float32)
    with pm.Model() as model:
        k = pm.Uniform("k", -1.0, 1.0)
        tau_e = pm.HalfNormal("tau_e", sigma=2.0)
        pm.AR1("a", k=k, tau_e=tau_e, observed=SERIES)
        rho = pm.Normal("rho", 0.0, 0.5, shape=2)
        sigma = pm.HalfNormal("sigma", sigma=1.0)
        pm.AR("b", rho=rho, sigma=sigma, shape=len(SERIES), observed=SERIES)
        mu = pm.Normal("mu", 0.0, 1.0)
        pm.GaussianRandomWalk("c", mu=mu, sigma=sigma, shape=len(SERIES),
                              observed=SERIES)
        theta = pm.HalfNormal("theta", sigma=1.0)
        pm.EulerMaruyama("d", dt=0.1, sde_fn=lambda x, th: (-th * x, 0.5),
                         sde_pars=(theta,), shape=len(SERIES),
                         observed=SERIES)
        m2 = pm.Normal("m2", 0.0, 1.0, shape=2)
        pm.MvGaussianRandomWalk("e", mu=m2, cov=MV_COVS[1], shape=(8, 2),
                                observed=x2)
        pm.MvStudentTRandomWalk("f", nu=tau_e + 2.0, mu=m2, chol=np.eye(2),
                                shape=(8, 2), observed=x2)
    return model


def _example(name):
    def build(pm):
        if pm is pj:
            from pymc3_tpu import examples
        else:
            from pymc3_tpu_torch import examples
        import importlib
        mod = importlib.import_module(f"{examples.__name__}.{name}")
        return mod.build_model()
    return build


MODELS = {"timeseries": (_ts_model, 1e-4),
          "lkj": (_example("LKJ_correlation"), 1e-4),
          "garch": (_example("garch_example"), 2e-4),
          "stochastic_volatility": (_example("stochastic_volatility"), 2e-4)}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logp_and_gradient_match_jax(name):
    build, rtol = MODELS[name]
    mj, mt = build(pj), build(pt)
    assert [(v.var, v.slc, v.shp) for v in mj.ordering.vmap] == \
        [(v.var, v.slc, v.shp) for v in mt.ordering.vmap]
    q0 = mj.dict_to_array(mj.test_point).astype(np.float32)
    rng = np.random.RandomState(12)
    q = np.concatenate([q0[None], q0[None] + rng.uniform(
        -0.5, 0.5, (4, q0.size))]).astype(np.float32)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=rtol,
                               atol=rtol)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=rtol,
                               atol=rtol * scale)
