"""The port's multivariate family and the Kronecker helpers of its math
module against the JAX package, on the grids of
``tests/test_multivariate_matrix.py``.

Tolerances (float32 in both packages):

- logp: rtol = atol = 2e-3 x the JAX grid's own scale for that cell (5x
  where a ``tau`` is factorised twice, 10x for an ill-conditioned
  covariance, 20x for the Wishart), and the same support (finite in one
  package exactly where it is finite in the other);
- model logp and gradient through ``LKJCholeskyCov`` with its transform,
  ``WishartBartlett`` and an ``MvNormal`` whose covariance depends on a free
  variable, at the test point and at random points: rtol 1e-4, atol 1e-4 x
  the largest gradient;
- the math helpers: rtol = atol = 1e-5;
- draws (20,000 from a seeded generator): each moment within 4 of its
  standard errors.
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

from .test_multivariate_matrix import (
    KRON_CELLS, MATNORM_CELLS, MULTINOMIAL_CELLS, MVN_CELLS, MVT_CELLS,
    WISHART_CELLS, _param_variants, _spd,
)

torch.set_num_threads(2)
N = 20000
Z = 4.0
MODEL_RTOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def TOL(scale=1.0):
    return 2e-3 * scale


def _both(cls, *args, **kwargs):
    return (getattr(pj, cls).dist(*args, **kwargs),
            getattr(pt, cls).dist(*args, **kwargs))


def _assert_logp(dj, dt, vals, scale, msg=""):
    v = np.asarray(vals, dtype=np.float32)
    want = np.asarray(dj.logp(v), dtype=np.float64)
    got = dt.logp(torch.from_numpy(v)).numpy().astype(np.float64)
    assert got.shape == want.shape, msg
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                  err_msg=msg)
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL(scale),
                               atol=TOL(scale), err_msg=msg)


@pytest.mark.parametrize("k,kind,param", MVN_CELLS,
                         ids=[f"{k}d-{kind}-{p}" for k, kind, p in MVN_CELLS])
def test_mvnormal_logp_matches_jax(k, kind, param):
    cov = _spd(k, kind)
    rng = np.random.default_rng(1)
    mu = rng.normal(scale=0.5, size=k)
    vals = rng.multivariate_normal(mu, cov, size=6)
    dj, dt = _both("MvNormal", mu=mu, **_param_variants(cov)[param])
    scale = {"cov": 1.0, "chol": 1.0, "tau": 5.0}[param]
    if kind == "illcond":
        scale *= 10.0
    _assert_logp(dj, dt, vals, scale)
    _assert_logp(dj, dt, vals[0], scale)


def test_mvnormal_upper_chol_and_non_pd():
    cov = _spd(3, "corr", seed=2)
    U = np.linalg.cholesky(cov).T
    vals = np.random.default_rng(3).normal(size=(4, 3))
    dj, dt = _both("MvNormal", mu=np.zeros(3), chol=U, lower=False)
    _assert_logp(dj, dt, vals, 1.0)
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    for param in ({"cov": bad}, {"tau": bad}):
        dt = pt.MvNormal.dist(mu=np.zeros(2), **param)
        assert torch.isneginf(dt.logp(torch.tensor([0.1, -0.2]))).all()


@pytest.mark.parametrize("k,nu,param", MVT_CELLS,
                         ids=[f"{k}d-nu{nu}-{p}" for k, nu, p in MVT_CELLS])
def test_mvstudentt_logp_matches_jax(k, nu, param):
    cov = _spd(k, "corr", seed=3)
    rng = np.random.default_rng(2)
    mu = rng.normal(scale=0.5, size=k)
    vals = rng.multivariate_normal(mu, cov, size=6)
    dj, dt = _both("MvStudentT", nu=nu, mu=mu, **_param_variants(cov)[param])
    _assert_logp(dj, dt, vals, 5.0 if param == "tau" else 1.0)


@pytest.mark.parametrize("n,p", MULTINOMIAL_CELLS,
                         ids=[f"n{n}-k{len(p)}" for n, p in MULTINOMIAL_CELLS])
def test_multinomial_logp_matches_jax(n, p):
    rng = np.random.default_rng(5)
    vals = rng.multinomial(n, p, size=6)
    vals[0] = 0
    vals[0, -1] = n
    vals[1, :2] = [-1, vals[1, 0] + vals[1, 1] + 1]  # out of support
    vals[2, 0] += 1                                   # sums to n + 1
    dj, dt = _both("Multinomial", n=n, p=p)
    want = np.asarray(dj.logp(vals), dtype=np.float64)
    got = dt.logp(torch.from_numpy(vals)).numpy().astype(np.float64)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], rtol=TOL(5.0),
                               atol=TOL(5.0 * n / 5))


@pytest.mark.parametrize("p,dnu,kind", WISHART_CELLS,
                         ids=[f"p{p}-nu+{dnu}-{kind}"
                              for p, dnu, kind in WISHART_CELLS])
def test_wishart_logp_matches_jax(p, dnu, kind):
    import scipy.stats as st
    nu = p + dnu
    V = _spd(p, kind, seed=6)
    Xs = st.wishart.rvs(int(np.ceil(nu)), V, size=4,
                        random_state=np.random.default_rng(7))
    with pytest.warns(UserWarning, match="Wishart"):
        dj, dt = _both("Wishart", nu=nu, V=V)
    for X in Xs:
        _assert_logp(dj, dt, X, 20.0)


@pytest.mark.parametrize("eta", [0.7, 1.0, 2.0, 5.0])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_lkjcorr_logp_matches_jax(eta, n):
    m = n * (n - 1) // 2
    rng = np.random.default_rng(int(10 * eta) + n)
    vals = rng.uniform(-0.6, 0.6, size=(5, m)) / n
    dj, dt = _both("LKJCorr", eta=eta, n=n)
    for v in vals:
        _assert_logp(dj, dt, v, 10.0)
    if n == 3:
        _assert_logp(dj, dt, np.array([0.99, 0.99, -0.99]), 10.0)


@pytest.mark.parametrize("eta", [1.0, 2.0, 5.0])
@pytest.mark.parametrize("n", [2, 3, 4])
def test_lkjcholeskycov_logp_matches_jax(eta, n):
    m = n * (n + 1) // 2
    rng = np.random.default_rng(int(eta) + 7 * n)
    vals = rng.normal(scale=0.7, size=(4, m))
    diag = np.arange(1, n + 1).cumsum() - 1
    vals[:, diag] = np.abs(vals[:, diag]) + 0.2
    dj = pj.LKJCholeskyCov.dist(eta=eta, n=n,
                                sd_dist=pj.HalfCauchy.dist(2.5))
    dt = pt.LKJCholeskyCov.dist(eta=eta, n=n,
                                sd_dist=pt.HalfCauchy.dist(2.5))
    for v in vals:
        _assert_logp(dj, dt, v, 5.0)


@pytest.mark.parametrize("rowp,colp", MATNORM_CELLS,
                         ids=[f"row-{r}_col-{c}" for r, c in MATNORM_CELLS])
def test_matrixnormal_logp_matches_jax(rowp, colp):
    m, n = 3, 4
    rowcov = _spd(m, "corr", seed=8)
    colcov = _spd(n, "diag", seed=9)
    rng = np.random.default_rng(10)
    M = rng.normal(size=(m, n))
    X = rng.normal(size=(m, n)) + M
    kw = {}
    for cov, which, p in ((rowcov, "row", rowp), (colcov, "col", colp)):
        kw[f"{which}{p}"] = {"cov": cov, "chol": np.linalg.cholesky(cov),
                             "tau": np.linalg.inv(cov)}[p]
    dj, dt = _both("MatrixNormal", mu=M, shape=(m, n), **kw)
    _assert_logp(dj, dt, X, 10.0 if "tau" in (rowp, colp) else 2.0)


@pytest.mark.parametrize("dims,sigma", KRON_CELLS,
                         ids=[f"{a}x{b}-sigma{s}" for (a, b), s in KRON_CELLS])
def test_kroneckernormal_logp_matches_jax(dims, sigma):
    covs = [_spd(k, "corr", seed=11 + i) for i, k in enumerate(dims)]
    N_ = int(np.prod(dims))
    K = np.kron(covs[0], covs[1])
    if sigma is not None:
        K = K + sigma ** 2 * np.eye(N_)
    rng = np.random.default_rng(12)
    mu = rng.normal(scale=0.3, size=N_)
    vals = rng.multivariate_normal(mu, K, size=5)
    dj, dt = _both("KroneckerNormal", mu=mu, covs=covs, sigma=sigma)
    _assert_logp(dj, dt, vals, 10.0)
    _assert_logp(dj, dt, vals[0], 10.0)
    chols = [np.linalg.cholesky(c) for c in covs]
    dj, dt = _both("KroneckerNormal", mu=mu, chols=chols, sigma=sigma)
    _assert_logp(dj, dt, vals, 10.0)


# -- model logp and gradient -------------------------------------------------
def _lkj_model(pm):
    data = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 10.0, shape=3)
        packed = pm.LKJCholeskyCov("packed_L", n=3, eta=2.0,
                                   sd_dist=pm.HalfCauchy.dist(2.5))
        L = pm.expand_packed_triangular(3, packed)
        pm.MvNormal("obs", mu=mu, chol=L, observed=data)
    return model


def _lkj_prior_model(pm):
    with pm.Model() as model:
        pm.LKJCholeskyCov("packed_L", n=4, eta=1.5,
                          sd_dist=pm.Exponential.dist(1.0))
        pm.LKJCorr("corr", eta=3.0, n=3)
    return model


def _wishart_bartlett_model(pm):
    S = _spd(3, "corr", seed=40)
    data = np.random.default_rng(1).normal(size=(10, 3)).astype(np.float32)
    with pm.Model() as model:
        prec = pm.WishartBartlett("prec", S, 6)
        pm.MvNormal("obs", mu=np.zeros(3), tau=prec, observed=data)
    return model


def _free_cov_model(pm):
    """An MvNormal and an MvStudentT whose covariances depend on free
    variables: under vmap their cholesky must batch."""
    base = _spd(4, "corr", seed=41)
    data = np.random.default_rng(2).normal(size=(8, 4)).astype(np.float32)
    with pm.Model() as model:
        s = pm.HalfNormal("s", sigma=2.0)
        nu = pm.Gamma("nu", alpha=3.0, beta=0.5)
        cov = s ** 2 * base.astype(np.float32)
        pm.MvNormal("x", mu=np.zeros(4), cov=cov, observed=data)
        pm.MvStudentT("t", nu=nu, mu=np.zeros(4), cov=cov, observed=data)
    return model


def _matrix_kron_model(pm):
    rowcov = _spd(2, "corr", seed=42)
    colcov = _spd(3, "diag", seed=43)
    data = np.random.default_rng(3).normal(size=(2, 3)).astype(np.float32)
    with pm.Model() as model:
        a = pm.HalfNormal("a", sigma=1.0)
        M = pm.Normal("M", 0.0, 1.0, shape=(2, 3))
        pm.MatrixNormal("X", mu=M, rowcov=a * rowcov.astype(np.float32),
                        colcov=colcov, observed=data)
        pm.KroneckerNormal("k", mu=np.zeros(6), covs=[rowcov, colcov],
                           sigma=a, observed=data.reshape(-1))
    return model


MODELS = {"lkj": _lkj_model, "lkj_prior": _lkj_prior_model,
          "wishart_bartlett": _wishart_bartlett_model,
          "free_cov": _free_cov_model, "matrix_kron": _matrix_kron_model}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logp_and_gradient_match_jax(name):
    mj, mt = MODELS[name](pj), MODELS[name](pt)
    assert [(v.var, v.slc, v.shp) for v in mj.ordering.vmap] == \
        [(v.var, v.slc, v.shp) for v in mt.ordering.vmap]
    q0 = mj.dict_to_array(mj.test_point).astype(np.float32)
    rng = np.random.RandomState(11)
    q = np.concatenate([q0[None], q0[None] + rng.uniform(
        -0.5, 0.5, (4, q0.size))]).astype(np.float32)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=MODEL_RTOL,
                               atol=MODEL_RTOL * scale)


# -- draws --------------------------------------------------------------------
def _draws(dist, seed, size=N):
    out = dist.random(size=size, gen=torch.Generator().manual_seed(seed))
    assert isinstance(out, np.ndarray)
    return out.astype(np.float64)


def _within(est, want, se):
    z = np.abs(np.asarray(est) - want) / se
    assert np.all(z < Z), z


def test_mvnormal_draws_every_parametrisation():
    cov = _spd(3, "corr", seed=20)
    mu = np.array([1.0, -0.5, 0.2])
    se_cov = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    for i, (param, kw) in enumerate(_param_variants(cov).items()):
        x = _draws(pt.MvNormal.dist(mu=mu, **kw), seed=i)
        assert x.shape == (N, 3), param
        _within(x.mean(0), mu, np.sqrt(np.diag(cov) / N))
        _within(np.cov(x.T), cov, se_cov)


def test_mvstudentt_draws_scale_the_covariance():
    cov = _spd(2, "diag", seed=22)
    nu = 9.0
    x = _draws(pt.MvStudentT.dist(nu=nu, mu=np.zeros(2), cov=cov), seed=4)
    var = np.diag(cov) * nu / (nu - 2.0)
    _within(x.mean(0), 0.0, np.sqrt(var / N))
    # the variance of a t with nu = 9 has kurtosis 6 / (nu - 4) + 3 = 4.2
    _within(x.var(0), var, var * np.sqrt((4.2 - 1.0) / N))


def test_wishart_draws_mean():
    V = _spd(2, "corr", seed=24)
    nu = 9
    with pytest.warns(UserWarning, match="Wishart"):
        d = pt.Wishart.dist(nu=nu, V=V)
    x = _draws(d, seed=5)
    assert x.shape == (N, 2, 2)
    np.testing.assert_allclose(x, np.swapaxes(x, -1, -2), atol=1e-4)
    # Var(X_ij) = nu (V_ij² + V_ii V_jj)
    se = np.sqrt(nu * (V ** 2 + np.outer(np.diag(V), np.diag(V))) / N)
    _within(x.mean(0), nu * V, se)


@pytest.mark.parametrize("n", [3, 4])
def test_lkjcorr_draws_r12_beta_identity(n):
    """(1 + r_ij)/2 ~ Beta(b, b) for every pair, b = eta - 1 + n/2."""
    eta = 2.0
    x = _draws(pt.LKJCorr.dist(eta=eta, n=n), seed=6)
    assert x.shape == (N, n * (n - 1) // 2)
    b = eta - 1.0 + n / 2.0
    var = 1.0 / (2.0 * b + 1.0)
    _within(x.mean(0), 0.0, np.sqrt(var / N))
    # Var of the sample variance of a symmetric Beta-scaled variable:
    # (m4 - var²) / N with m4 = 3 var² (2b + 1) / (2b + 3)
    m4 = 3.0 * var ** 2 * (2 * b + 1) / (2 * b + 3)
    _within(x.var(0), var, np.sqrt((m4 - var ** 2) / N))


def test_lkjcholeskycov_draws_are_valid_factors():
    n = 3
    d = pt.LKJCholeskyCov.dist(eta=2.0, n=n, sd_dist=pt.Exponential.dist(1.0))
    x = _draws(d, seed=7, size=4000)
    assert x.shape == (4000, 6)
    L = np.zeros((4000, n, n))
    L[:, np.tril_indices(n)[0], np.tril_indices(n)[1]] = x
    sd = np.sqrt(np.einsum("bij,bij->bi", L, L))
    # the sds are Exponential(1): mean 1, sd 1
    _within(sd.mean(0), 1.0, np.sqrt(1.0 / 4000))
    corr = np.einsum("bij,bkj->bik", L, L) / sd[:, :, None] / sd[:, None, :]
    b = 2.0 - 1.0 + n / 2.0
    _within(corr[:, 1, 0].mean(), 0.0, np.sqrt(1.0 / (2 * b + 1) / 4000))


def test_multinomial_draws_mean_and_covariance():
    n, p = 40, np.array([0.2, 0.3, 0.5])
    x = _draws(pt.Multinomial.dist(n=n, p=p), seed=8)
    assert x.shape == (N, 3)
    np.testing.assert_array_equal(x.sum(-1), n)
    cov = n * (np.diag(p) - np.outer(p, p))
    _within(x.mean(0), n * p, np.sqrt(np.diag(cov) / N))
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    _within(np.cov(x.T), cov, se)


def test_matrixnormal_and_kroneckernormal_draws():
    rowcov = _spd(2, "corr", seed=29)
    colcov = _spd(3, "diag", seed=30)
    d = pt.MatrixNormal.dist(mu=np.zeros((2, 3)), rowcov=rowcov,
                             colcov=colcov, shape=(2, 3))
    x = _draws(d, seed=9).reshape(N, 6)
    cov = np.kron(rowcov, colcov)
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    _within(np.cov(x.T), cov, se)
    covs = [_spd(2, "diag", seed=32), _spd(2, "corr", seed=33)]
    d = pt.KroneckerNormal.dist(mu=np.zeros(4), covs=covs, sigma=0.5)
    x = _draws(d, seed=10)
    cov = np.kron(covs[0], covs[1]) + 0.25 * np.eye(4)
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    _within(np.cov(x.T), cov, se)


def test_draw_shapes_match_jax():
    cov = _spd(3, "corr", seed=44)
    cells = [("MvNormal", dict(mu=np.zeros(3), chol=np.linalg.cholesky(cov))),
             ("MvStudentT", dict(nu=5.0, mu=np.zeros(3), tau=cov)),
             ("Multinomial", dict(n=10, p=np.array([0.2, 0.8]))),
             ("LKJCorr", dict(eta=2.0, n=3)),
             ("MatrixNormal", dict(mu=np.zeros((2, 3)), rowcov=np.eye(2),
                                   colcov=np.eye(3), shape=(2, 3)))]
    for cls, kwargs in cells:
        dj, dt = _both(cls, **kwargs)
        for size in (None, 5, (4, 5)):
            np.random.seed(0)
            assert tuple(dt.random(size=size).shape) == \
                np.shape(dj.random(size=size)), (cls, size)


def test_posterior_predictive_of_a_chol_mvnormal_at_batched_points():
    """The LKJ model's ``obs`` drawn at a batch of posterior points: each
    sample is one row (the distribution's shape, as in the JAX package),
    drawn with its own point's mean and factor."""
    model = _lkj_model(pt)
    pts = {"mu": np.array([[0.0, 0.0, 0.0], [5.0, -5.0, 1.0]], np.float32),
           "packed_L": np.array([[1.0, 0.0, 1.0, 0.0, 0.0, 1.0],
                                 [0.1, 0.0, 0.1, 0.0, 0.0, 0.1]],
                                np.float32)}
    trace = {k: np.repeat(v, 2000, axis=0) for k, v in pts.items()}
    ppc = pt.sample_posterior_predictive([
        {k: v[i] for k, v in trace.items()} for i in range(4000)],
        model=model, var_names=["obs"], random_seed=1)["obs"]
    assert ppc.shape == (4000, 3)
    a, b = ppc[:2000], ppc[2000:]
    _within(a.mean(0), 0.0, np.sqrt(1.0 / a.shape[0]))
    _within(b.mean(0), [5.0, -5.0, 1.0], np.sqrt(0.01 / b.shape[0]))
    np.testing.assert_allclose(b.std(0), 0.1, rtol=0.05)


# -- math ---------------------------------------------------------------------
def _node_value(pkg, node):
    v = pkg.node.evaluate(node, {})
    return np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)


def test_math_helpers_match_jax():
    rng = np.random.default_rng(45)
    A = rng.normal(size=(2, 2)).astype(np.float32)
    B = rng.normal(size=(3, 3)).astype(np.float32)
    La = np.tril(A) + 3 * np.eye(2, dtype=np.float32)
    Lb = np.tril(B) + 3 * np.eye(3, dtype=np.float32)
    m = rng.normal(size=(6, 2)).astype(np.float32)
    v = rng.normal(size=6).astype(np.float32)
    stack = rng.normal(size=(3, 2, 2)).astype(np.float32)
    cases = [
        ("batched_diag", (stack[:, 0],)), ("batched_diag", (stack,)),
        ("block_diagonal", ([A, B],)), ("block_diagonal", (stack,)),
        ("kronecker", (A, B)), ("kron_dot", ([A, B], m)),
        ("kron_dot", ([A, B], v)), ("kron_solve_lower", ([La, Lb], m)),
        ("kron_solve_upper", ([La.T, Lb.T], m)),
        ("kron_diag", (np.diag(A), np.diag(B))),
        ("expand_packed_triangular", (3, np.arange(6, dtype=np.float32))),
    ]
    for fn, args in cases:
        want = _node_value(pj, getattr(pj.math, fn)(*args))
        got = _node_value(pt, getattr(pt.math, fn)(*args))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=fn)
    np.testing.assert_array_equal(pt.math.cartesian([1, 2], [3, 4, 5]),
                                  pj.math.cartesian([1, 2], [3, 4, 5]))
    assert pt.expand_packed_triangular is pt.math.expand_packed_triangular
