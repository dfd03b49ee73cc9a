"""The port's ``find_MAP``, ``find_hessian`` and scaling guesses against
the JAX package and against finite differences (mirrors
``tests/test_tuning.py``)."""
import numpy as np
import pytest
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.tuning import scaling as jscaling
from pymc3_tpu_torch.tuning import scaling

from . import torch_models  # noqa: F401

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _skewed(pm):
    """Transformed, correlated and non-Gaussian: a Hessian with off-diagonal
    entries and a MAP away from the test point."""
    y = np.array([0.3, 1.9, 2.4, 0.8, 1.1, 3.0], np.float32)
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 3.0)
        sd = pm.HalfNormal("sd", 2.0)
        nu = pm.Gamma("nu", 2.0, 0.5)
        pm.StudentT("obs", nu=nu, mu=mu, sigma=sd, observed=y)
    return m


def _neg_logp_nojac(model, q):
    return -model.logp_nojac(model.array_to_dict(q))


def test_find_hessian_matches_finite_differences_and_jax():
    tm, jm = _skewed(pt), _skewed(pj)
    point = {"mu": np.float32(1.2), "sd_log__": np.float32(0.1),
             "nu_log__": np.float32(1.0)}
    H = scaling.find_hessian(point, model=tm)
    np.testing.assert_allclose(H, jscaling.find_hessian(point, model=jm),
                               rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(scaling.find_hessian_diag(point, model=tm),
                               np.diag(H), rtol=1e-5, atol=1e-5)
    # central differences in float64 of the float32 logp: h = 1e-2
    q = tm.dict_to_array(point).astype(np.float64)
    h, n = 1e-2, q.size
    fd = np.zeros((n, n))
    for i in range(n):
        for j in range(n):
            e_i, e_j = np.eye(n)[i] * h, np.eye(n)[j] * h
            fd[i, j] = (_neg_logp_nojac(tm, q + e_i + e_j)
                        - _neg_logp_nojac(tm, q + e_i - e_j)
                        - _neg_logp_nojac(tm, q - e_i + e_j)
                        + _neg_logp_nojac(tm, q - e_i - e_j)) / (4 * h * h)
    np.testing.assert_allclose(H, fd, rtol=2e-2, atol=2e-2)


def test_find_MAP_matches_jax():
    tm, jm = _skewed(pt), _skewed(pj)
    with tm:
        got = pt.find_MAP(progressbar=False)
    with jm:
        want = pj.find_MAP(progressbar=False)
    for k in ("mu", "sd", "nu", "sd_log__", "nu_log__"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3,
                                   err_msg=k)
    with tm:
        raw, res = pt.find_MAP(progressbar=False, return_raw=True,
                               include_transformed=False)
    assert "sd_log__" not in raw and res.success


def test_adjust_precision():
    a = np.array([-10, -0.01, 0, 10, 1e300, -np.inf, np.inf])
    a1 = scaling.adjust_precision(a)
    assert np.all((a1 > 0) & (a1 < 1e200))
    np.testing.assert_allclose(a1, jscaling.adjust_precision(a))
    s = np.array([[2.0, 0.5], [0.5, 1e-20]])
    np.testing.assert_allclose(scaling.adjust_scaling(s, 1e-8),
                               jscaling.adjust_scaling(s, 1e-8))


def test_guess_scaling_and_fixed_hessian():
    tm, jm = _skewed(pt), _skewed(pj)
    got = scaling.guess_scaling(tm.test_point, model=tm)
    np.testing.assert_allclose(
        got, jscaling.guess_scaling(jm.test_point, model=jm), rtol=1e-4)
    assert np.all((got > 0) & (got < np.finfo(got.dtype).max))
    np.testing.assert_allclose(scaling.fixed_hessian({}, model=tm),
                               np.full(3, 0.1))


def test_accuracy_normal():
    with pt.Model():
        pt.Normal("x", 2.5, 1.3, shape=2)
        est = pt.find_MAP(pt.Point(x=[-10.5, 100.5]), progressbar=False)
    np.testing.assert_allclose(est["x"], [2.5, 2.5], atol=1e-3)


def test_find_MAP_powell_and_bfgs():
    rng = np.random.RandomState(5)
    data = rng.randn(100)
    data = (data - np.mean(data)) / np.std(data)
    with pt.Model():
        mu = pt.Uniform("mu", -1, 1)
        sigma = pt.Uniform("sigma", 0.5, 1.5)
        pt.Normal("y", mu=mu, tau=sigma ** -2, observed=data)
        est1 = pt.find_MAP(progressbar=False)
        est2 = pt.find_MAP(progressbar=False, method="Powell")
        est3 = pt.find_MAP(progressbar=False, method="BFGS")
    for est in (est1, est2, est3):
        np.testing.assert_allclose(est["mu"], 0, atol=1e-3)
        np.testing.assert_allclose(est["sigma"], 1, atol=1e-3)


def test_find_MAP_discrete_goes_gradient_free():
    with pt.Model():
        p = pt.Beta("p", 4, 4)
        pt.Binomial("ss", n=20, p=p)
        pt.Binomial("s", n=20, p=p, observed=15)
        est = pt.find_MAP(progressbar=False)
    assert 0.4 < float(est["p"]) < 0.8


def test_trace_cov():
    with pt.Model() as m:
        pt.Normal("a", 0.0, 1.0, shape=2)
        tr = pt.sample(draws=300, tune=100, chains=2, random_seed=1,
                       progressbar=False, compute_convergence_checks=False)
    np.testing.assert_allclose(scaling.trace_cov(tr, model=m),
                               np.cov(tr["a"].T))


def test_graph_derivative_helpers_match_jax():
    """``gradient``, ``hessian``, ``hessian_diag`` and ``jacobian`` of the
    model's logp node (cf. ``tests/test_jaxf.py``)."""
    tm, jm = _skewed(pt), _skewed(pj)
    env = {"mu": np.float32(0.7), "sd_log__": np.float32(-0.2),
           "nu_log__": np.float32(1.3)}
    tenv = {k: torch.as_tensor(v) for k, v in env.items()}
    for fn in ("gradient", "hessian", "hessian_diag"):
        want = np.asarray(getattr(pj, fn)(jm.logpt).eval(env))
        got = getattr(pt, fn)(tm.logpt).eval(tenv).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4,
                                   err_msg=fn)
    x = tm["mu"]
    jac = pt.jacobian(pt.math.stack([x * 2.0, x ** 2]), [x]).eval(tenv)
    np.testing.assert_allclose(jac.numpy(), [[2.0], [1.4]], rtol=1e-6)
    assert [v.name for v in pt.inputvars(tm.logpt)] == [
        v.name for v in pj.inputvars(jm.logpt)]
