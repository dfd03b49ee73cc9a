"""GP prediction of the port against the JAX package's: ``Marginal.predict``,
``predictt`` and ``conditional`` on the same numpy inputs.

n = 30 observations, m = 17 new inputs, d = 2 features, ExpQuad and
Matern52. One point of the JAX model (its test point moved by seeded numpy
noise) is handed to both ``predict`` calls unchanged.

Tolerance rtol 1e-4, atol 1e-5: both packages run a float32 Cholesky of the
30x30 matrix K + noise and two triangular solves, in another order of
operations; the noise-free predictive covariance K** - A^T A cancels to
small numbers near the data, which the atol covers. The ``logp`` of a value
under the conditional is compared with predictive noise, where the
covariance is well conditioned (without it the stabilised conditional has
eigenvalues at the jitter, and the quadratic form amplifies float32 rounding
by 1 / jitter in both packages).
"""
import numpy as np
import pytest
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)

TOL = dict(rtol=1e-4, atol=1e-5)
N, M, D = 30, 17, 2
KERNELS = ["ExpQuad", "Matern52"]


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _data(seed=11):
    rng = np.random.RandomState(seed)
    X = rng.uniform(0.0, 3.0, (N, D)).astype(np.float32)
    y = (np.sin(2.0 * X[:, 0]) + 0.5 * X[:, 1]
         + 0.2 * rng.randn(N)).astype(np.float32)
    Xnew = rng.uniform(-0.5, 3.5, (M, D)).astype(np.float32)
    return X, y, Xnew


def _build(pm, kernel, X, y):
    """Returns the model and its Marginal GP."""
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=2, shape=D)
        eta = pm.HalfNormal("eta", sigma=2)
        cov = (eta ** 2) * getattr(pm.gp.cov, kernel)(D, ls)
        gp = pm.gp.Marginal(cov_func=cov)
        sigma = pm.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    return model, gp


def _point(model, seed=3):
    """The JAX model's test point, moved by seeded noise."""
    rng = np.random.RandomState(seed)
    return {k: (np.asarray(v) + 0.3 * rng.randn(*np.shape(v))).astype(
        np.float32) for k, v in sorted(model.test_point.items())}


def _both(kernel):
    X, y, Xnew = _data()
    mj, gj = _build(pj, kernel, X, y)
    mt, gt = _build(pt, kernel, X, y)
    return (mj, gj), (mt, gt), _point(mj), (X, y, Xnew)


@pytest.mark.parametrize("pred_noise", [False, True],
                         ids=["latent", "pred_noise"])
@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_matches_jax(kernel, diag, pred_noise):
    (mj, gj), (mt, gt), point, (_, _, Xnew) = _both(kernel)
    with mj:
        mu_j, cov_j = gj.predict(Xnew, point=point, diag=diag,
                                 pred_noise=pred_noise)
    with mt:
        mu_t, cov_t = gt.predict(Xnew, point=point, diag=diag,
                                 pred_noise=pred_noise)
    assert isinstance(mu_t, np.ndarray) and isinstance(cov_t, np.ndarray)
    assert mu_t.shape == (M,)
    assert cov_t.shape == ((M,) if diag else (M, M))
    np.testing.assert_allclose(mu_t, mu_j, **TOL)
    np.testing.assert_allclose(cov_t, cov_j, **TOL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_at_the_test_point_matches_jax(kernel):
    """No point given: both packages predict at the model's test point."""
    (mj, gj), (mt, gt), _, (_, _, Xnew) = _both(kernel)
    with mj:
        mu_j, var_j = gj.predict(Xnew, diag=True)
    with mt:
        mu_t, var_t = gt.predict(Xnew, diag=True)
    np.testing.assert_allclose(mu_t, mu_j, **TOL)
    np.testing.assert_allclose(var_t, var_j, **TOL)


@pytest.mark.parametrize("kernel", KERNELS)
def test_predict_given_other_data_and_a_sum_gp_matches_jax(kernel):
    """``given=``: condition on other X, y and noise than the GP's own,
    under the total covariance of a sum this GP is one term of."""
    (mj, gj), (mt, gt), point, (X, y, Xnew) = _both(kernel)
    rng = np.random.RandomState(5)
    X2 = rng.uniform(0.0, 3.0, (12, D)).astype(np.float32)
    y2 = rng.randn(12).astype(np.float32)
    out = []
    for pm, model, gp in ((pj, mj, gj), (pt, mt, gt)):
        other = pm.gp.Marginal(cov_func=pm.gp.cov.Matern32(D, 0.7))
        total = pm.gp.Marginal(cov_func=gp.cov_func + other.cov_func)
        given = {"gp": total, "X": X2, "y": y2, "noise": 0.4}
        with model:
            out.append(gp.predict(Xnew, point=point, given=given))
    (mu_j, cov_j), (mu_t, cov_t) = out
    np.testing.assert_allclose(mu_t, mu_j, **TOL)
    np.testing.assert_allclose(cov_t, cov_j, **TOL)


def test_predict_without_a_model_on_the_stack_raises():
    (_, _), (_, gt), point, (_, _, Xnew) = _both("ExpQuad")
    with pytest.raises(TypeError, match="No model"):
        gt.predict(Xnew, point=point)


def test_predict_before_marginal_likelihood_raises():
    with pt.Model():
        gp = pt.gp.Marginal(cov_func=pt.gp.cov.ExpQuad(D, 1.0))
        with pytest.raises(AttributeError, match="not set"):
            gp.predict(_data()[2])


@pytest.mark.parametrize("pred_noise", [False, True],
                         ids=["latent", "pred_noise"])
@pytest.mark.parametrize("kernel", KERNELS)
def test_conditional_nodes_match_jax(kernel, pred_noise):
    """The ``mu`` and ``cov`` nodes of the conditional MvNormal."""
    (mj, gj), (mt, gt), point, (_, _, Xnew) = _both(kernel)
    out = []
    for model, gp in ((mj, gj), (mt, gt)):
        with model:
            f = gp.conditional("f", Xnew, pred_noise=pred_noise)
            assert f.distribution.shape == (M,)
            out.append(model.makefn([f.distribution.mu,
                                     f.distribution.cov])(point))
    (mu_j, cov_j), (mu_t, cov_t) = out
    np.testing.assert_allclose(mu_t, np.asarray(mu_j), **TOL)
    np.testing.assert_allclose(cov_t, np.asarray(cov_j), **TOL)
    if not pred_noise:
        # the noise-free covariance is stabilised, as in the JAX package
        assert np.all(np.linalg.eigvalsh(cov_t.astype(np.float64)) > 0.0)


@pytest.mark.parametrize("kernel", KERNELS)
def test_conditional_logp_of_a_value_matches_jax(kernel):
    (mj, gj), (mt, gt), point, (_, _, Xnew) = _both(kernel)
    value = np.random.RandomState(9).randn(M).astype(np.float32)
    got = []
    for model, gp in ((mj, gj), (mt, gt)):
        with model:
            gp.conditional("f", Xnew, pred_noise=True)
        got.append(float(model.logp(dict(point, f=value))))
    assert got[1] == pytest.approx(got[0], rel=1e-4, abs=1e-5)
    # the conditional's own term, not only the sum with the marginal
    base = [float(m.logp(point))
            for m in (_build(pj, kernel, *_data()[:2])[0],
                      _build(pt, kernel, *_data()[:2])[0])]
    assert got[1] - base[1] == pytest.approx(got[0] - base[0], rel=1e-4,
                                             abs=1e-4)


def test_predictt_returns_nodes_that_follow_the_point():
    """``predictt`` is symbolic: one pair of nodes, evaluated at two points,
    gives two predictions."""
    (_, _), (mt, gt), point, (_, _, Xnew) = _both("ExpQuad")
    with mt:
        mu, var = gt.predictt(Xnew, diag=True, pred_noise=True)
    assert isinstance(mu, pt.node.Node) and isinstance(var, pt.node.Node)
    fn = mt.makefn([mu, var])
    m1, v1 = fn(point)
    m2, v2 = fn(dict(point, sigma_log__=point["sigma_log__"] + 1.0))
    assert np.all(v2 > v1)          # more noise, more predictive variance
    assert not np.allclose(m1, m2)
    assert np.all(v1 > 0.0)
