"""The rest of the port's GP against the JAX package's: every covariance and
mean function, ``Latent``, ``TP``, ``MarginalSparse`` (FITC, VFE, DTC),
``LatentKron`` and ``MarginalKron``, and the helpers of ``gp/util.py``, on
the same numpy inputs.

Tolerances:
- covariances and means: rtol 1e-5, atol 1e-6 (the same float32 formulas;
  the five fused kinds run the port's plain path here, which sums the same
  squared differences);
- model logp and gradient: rtol 1e-4, atol 1e-4 x max(1, the largest
  gradient), as the port's other model tests (float32 Cholesky factors of
  matrices up to 40 x 40, in another order of operations);
- conditional means and covariances: rtol 1e-4, atol 1e-4 (a noise-free
  conditional covariance cancels to small numbers near the data).

``MarginalSparse`` departs from the JAX package on purpose: the JAX logp and
conditional evaluate ``Kuu``, ``Kuf`` and ``Kffd`` with an empty
environment, at the hyperparameters' test values, so a random lengthscale
or amplitude never reaches them. The port's are checked against JAX only
with constant hyperparameters, where JAX is right, and with random
hyperparameters against a float64 numpy evaluation of the same formulas.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu.node import evaluate as jeval
from pymc3_tpu_torch.gp import util as tutil
from pymc3_tpu_torch.node import evaluate as teval
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)

COV = dict(rtol=1e-5, atol=1e-6)
LOGP_RTOL = LOGP_ATOL = 1e-4
COND = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _xp(pm):
    return torch if pm is pt else jnp


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# covariance and mean functions
# ---------------------------------------------------------------------------

def _inputs(n=12, m=7, d=2, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.uniform(0, 3, (n, d)).astype(np.float32),
            rng.uniform(-0.5, 3.5, (m, d)).astype(np.float32))


def _covs(pm, ls):
    """Every kernel, keyed by name, with lengthscale ``ls`` (a number or a
    random variable)."""
    xp, c = _xp(pm), pm.gp.cov
    return {
        "ExpQuad": c.ExpQuad(2, ls),
        "Matern52": c.Matern52(2, ls),
        "Matern32": c.Matern32(2, ls, active_dims=[1]),
        "Matern12": c.Matern12(2, ls),
        "Exponential": c.Exponential(2, ls),
        "RatQuad": c.RatQuad(2, 1.7, ls),
        "Cosine": c.Cosine(2, ls, active_dims=[0]),
        "Periodic": c.Periodic(2, 1.3, ls),
        "Linear": c.Linear(2, 0.4),
        "Polynomial": c.Polynomial(2, 0.4, 2, 0.5),
        "WarpedInput": c.WarpedInput(
            2, c.ExpQuad(2, ls), lambda x, a: xp.sin(x) * a, args=(1.5,)),
        "Gibbs": c.Gibbs(1, lambda x: 0.5 + 0.3 * xp.cos(x),
                         active_dims=[0]),
        "ScaledCov": c.ScaledCov(2, c.Matern52(2, ls),
                                 lambda x: xp.exp(-0.3 * x[:, 0])),
        "Coregion": c.Coregion(1, B=np.array([[2.0, 0.5, 0.1],
                                               [0.5, 1.5, 0.2],
                                               [0.1, 0.2, 1.0]], np.float32)),
        "Add": c.ExpQuad(2, ls) + c.Linear(2, 0.2) + 0.3,
        "Prod": 1.7 * c.Matern32(2, ls) * c.Cosine(2, 2.5),
        "Pow": c.Matern52(2, ls) ** 2,
        "WhiteNoise": c.WhiteNoise(0.4) + c.Constant(0.2),
        "ARD": c.ExpQuad(2, ls=[0.7, 1.9]),
        "Kron": c.Kron([c.ExpQuad(1, ls), c.Matern32(1, 0.8)]),
    }


def _coregion_inputs(X, Xs):
    """Task indices 0-2 for the coregion kernel."""
    return (np.floor(X[:, :1]) % 3).astype(np.float32), \
        (np.floor(np.abs(Xs[:, :1])) % 3).astype(np.float32)


def _eval(pm, node, env):
    if pm is pt:
        env = {k: torch.tensor(v) for k, v in env.items()}
        val = teval(node, env) if isinstance(node, pt.node.Node) else node
    else:
        val = jeval(node, env) if isinstance(node, pj.node.Node) else node
    return _np(val)


NAMES = list(_covs(pt, 1.0))


@pytest.mark.parametrize("symbolic", [False, True], ids=["const", "rv"])
@pytest.mark.parametrize("name", NAMES)
def test_covariance_full_diag_cross_match_jax(name, symbolic):
    X, Xs = _inputs()
    if name == "Coregion":
        X, Xs = _coregion_inputs(X, Xs)
    if name in ("Gibbs", "Coregion"):
        X, Xs = X[:, :1], Xs[:, :1]
    out = {}
    for pm in (pj, pt):
        with pm.Model():
            ls = pm.Normal("ls", 1.0, 1.0) if symbolic else 1.1
            k = _covs(pm, ls)[name]
            out[pm] = [_eval(pm, node, {"ls": np.float32(0.83)})
                       for node in (k(X), k(X, Xs), k(X, diag=True))]
    for got, want in zip(out[pt], out[pj]):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, **COV)


def test_symbolic_lengthscale_moves_the_covariance():
    """The RV's value, not its test value, reaches K."""
    X, _ = _inputs()
    with pt.Model():
        ls = pt.Normal("ls", 1.0, 1.0)
        K = pt.gp.cov.Matern52(2, ls)(X)
    a, b = (_eval(pt, K, {"ls": np.float32(v)}) for v in (0.5, 2.0))
    assert np.abs(a - b).max() > 0.1


def test_square_and_euclidean_dist_match_jax():
    """Exact differences at d = 3 (rtol 1e-5); at d = 40 both packages take
    the matmul form x² + x'² - 2 x x', which cancels on the diagonal: atol
    32 float32 epsilons of the largest scaled squared norm."""
    X, Xs = _inputs(d=3)
    got, want = ([_eval(pm, node, {}) for node in (
        pm.gp.cov.ExpQuad(3, 0.9).square_dist(X, Xs),
        pm.gp.cov.ExpQuad(3, 0.9).euclidean_dist(X))] for pm in (pt, pj))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-6)
    X40 = np.random.RandomState(4).randn(9, 40).astype(np.float32)
    got, want = (_eval(pm, pm.gp.cov.ExpQuad(40, 0.9).square_dist(
        X40, X40[:5]), {}) for pm in (pt, pj))
    scale = float(np.max(np.sum((X40 / 0.9) ** 2, 1)))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=32 * np.finfo(np.float32).eps * scale)


def test_stationary_base_has_no_full_and_only_fused_kinds_reach_the_op(
        monkeypatch):
    from pymc3_tpu_torch.ops import gp_cov
    X, _ = _inputs()
    with pytest.raises(NotImplementedError):
        pt.gp.cov.Stationary(2, 1.0).full(X)
    calls = []
    fwd = gp_cov._cov_forward
    monkeypatch.setattr(gp_cov, "_cov_forward", lambda kind, A, B: (
        calls.append(kind), fwd(kind, A, B))[1])
    for k in ("RatQuad", "Cosine", "Periodic", "ExpQuad", "Matern32"):
        _covs(pt, 1.1)[k](X)
    assert calls == ["expquad", "matern32"]


def test_batches_above_the_grid_limit_are_cut_into_chunks():
    """The kernels take at most 65,535 batch entries a launch (gridDim.z);
    the wrappers cut a larger batch into consecutive chunks."""
    from pymc3_tpu_torch.ops.gp_cov import MAX_GRID_Z, _chunks
    assert MAX_GRID_Z == 65_535
    assert _chunks(70_000) == [(0, 65_535), (65_535, 70_000)]
    assert _chunks(65_535) == [(0, 65_535)]
    assert _chunks(3 * 65_535 + 1)[-1] == (3 * 65_535, 3 * 65_535 + 1)
    assert _chunks(1) == [(0, 1)]


def _means(pm, coeff):
    m = pm.gp.mean
    return {"Zero": m.Zero(), "Constant": m.Constant(1.5),
            "Linear": m.Linear(coeffs=coeff, intercept=0.3),
            "Add": m.Constant(0.5) + m.Linear(coeffs=coeff),
            "Prod": m.Constant(2.0) * m.Linear(coeffs=coeff, intercept=1.0)}


@pytest.mark.parametrize("symbolic", [False, True], ids=["const", "rv"])
@pytest.mark.parametrize("name", ["Zero", "Constant", "Linear", "Add",
                                  "Prod"])
def test_mean_functions_match_jax(name, symbolic):
    X, _ = _inputs()
    coeff_val = np.array([0.7, -1.2], np.float32)
    out = []
    for pm in (pj, pt):
        with pm.Model():
            coeff = pm.Normal("w", 0.0, 1.0, shape=2) if symbolic \
                else coeff_val
            out.append(_eval(pm, _means(pm, coeff)[name](X),
                             {"w": coeff_val * 0.5}))
    np.testing.assert_allclose(out[1], out[0], **COV)


def test_util_helpers_match_jax():
    rng = np.random.RandomState(2)
    A = rng.randn(6, 6).astype(np.float32)
    L = np.linalg.cholesky(A @ A.T + 6 * np.eye(6)).astype(np.float32)
    b = rng.randn(6, 3).astype(np.float32)
    for fn in ("solve_lower", "solve_upper"):
        got = _np(getattr(tutil, fn)(L, b).value)
        want = np.asarray(getattr(pj.gp.util, fn)(L, b).value)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    X = rng.uniform(0, 10, (300, 2))
    np.random.seed(5)
    want = pj.gp.util.kmeans_inducing_points(8, X)
    np.random.seed(5)
    got = tutil.kmeans_inducing_points(8, X)
    np.testing.assert_allclose(got, want)
    from pymc3_tpu.gp.gp import _cartesian as jcart
    from pymc3_tpu_torch.gp.gp import _cartesian as tcart
    grids = [np.arange(3.0)[:, None], np.arange(4.0)[:, None] * 2,
             np.arange(2.0)[:, None] - 1]
    np.testing.assert_array_equal(tcart(grids), jcart(grids))


# ---------------------------------------------------------------------------
# model logp and gradient against the JAX package
# ---------------------------------------------------------------------------

def _points(mj, n=5, seed=11, scale=0.3):
    rng = np.random.RandomState(seed)
    q0 = mj.dict_to_array(mj.test_point)
    return (q0[None] + scale * rng.randn(n, q0.size)).astype(np.float32)


def _logp_grad_match(mj, mt, q, jit=True):
    """logp and gradient of the two models at the rows of ``q``. The JAX
    package's ``MarginalSparse`` cannot be traced (its covariances are
    evaluated to numpy inside the logp), so ``jit=False`` takes its value
    and gradient point by point, eagerly."""
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    vag = jax.value_and_grad(JaxVGF(mj).jax_fn)
    if jit:
        lj, gj = jax.jit(jax.vmap(vag))(jnp.asarray(q))
    else:
        lj, gj = (np.stack(a) for a in zip(*[
            [np.asarray(v) for v in vag(jnp.asarray(r))] for r in q]))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert np.all(np.isfinite(np.asarray(lj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=LOGP_RTOL,
                               atol=LOGP_ATOL)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=LOGP_RTOL,
                               atol=LOGP_ATOL * scale)


def _gp_data(n=20, seed=21):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(0, 4, n))[:, None].astype(np.float32)
    y = (np.sin(2 * X[:, 0]) + 0.3 * rng.randn(n)).astype(np.float32)
    Xnew = np.linspace(-0.3, 4.3, 9)[:, None].astype(np.float32)
    return X, y, Xnew


def _latent(pm, kind):
    X, y, _ = _gp_data()
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=2)
        eta = pm.HalfNormal("eta", sigma=2)
        cov = eta ** 2 * pm.gp.cov.Matern52(1, ls)
        mean = pm.gp.mean.Linear(coeffs=np.array([0.2], np.float32),
                                 intercept=0.1)
        gp = (pm.gp.Latent(mean_func=mean, cov_func=cov) if kind == "latent"
              else pm.gp.TP(mean_func=mean, cov_func=cov, nu=4.0))
        f = gp.prior("f", X=X)
        pm.Normal("y", mu=f, sigma=0.3, observed=y)
    return model, gp, f


@pytest.mark.parametrize("kind", ["latent", "tp"])
def test_latent_and_tp_prior_logp_and_f_match_jax(kind):
    (mj, _, fj), (mt, _, ft) = _latent(pj, kind), _latent(pt, kind)
    q = _points(mj)
    _logp_grad_match(mj, mt, q)
    for row in q[:2]:
        pj_point = mj.array_to_dict(row)
        want = mj.makefn(fj)(pj_point)
        got = mt.makefn(ft)(pj_point)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind", ["latent", "tp"])
def test_latent_and_tp_conditional_match_jax(kind):
    _, _, Xnew = _gp_data()
    out = []
    for pm in (pj, pt):
        model, gp, f = _latent(pm, kind)
        with model:
            if kind == "latent":
                nodes = gp._build_conditional(
                    pm.node.as_node(Xnew), *gp._get_given_vals(None))
            else:
                nodes = gp._build_conditional(pm.node.as_node(Xnew), gp.X,
                                              gp.f)
            out.append((model, nodes))
    point = out[0][0].array_to_dict(_points(out[0][0], n=1)[0])
    want = out[0][0].makefn(list(out[0][1]))(point)
    got = out[1][0].makefn(list(out[1][1]))(point)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **COND)
    # the conditional as a random variable of the port's model
    model, gp, _ = _latent(pt, kind)
    with model:
        gp.conditional("fnew", Xnew)
    assert np.isfinite(model.logp())


def test_latent_prior_draws_have_covariance_K():
    """20,000 prior draws of f at 8 inputs (``sample_prior_predictive``)
    against K + jitter: each covariance entry within five Monte-Carlo
    standard errors, sqrt((K_ii K_jj + K_ij^2) / N)."""
    X = np.linspace(0, 2, 8)[:, None].astype(np.float32)
    with pt.Model() as model:
        gp = pt.gp.Latent(cov_func=1.5 ** 2 * pt.gp.cov.ExpQuad(1, 0.7))
        gp.prior("f", X=X)
    n = 20_000
    draws = pt.sample_prior_predictive(samples=n, model=model,
                                       var_names=["f"],
                                       random_seed=3)["f"].astype(np.float64)
    K = _np(teval(tutil.stabilize(gp.cov_func(X)), {})).astype(np.float64)
    S = np.cov(draws.T)
    se = np.sqrt((np.outer(np.diag(K), np.diag(K)) + K ** 2) / n)
    assert np.all(np.abs(S - K) < 5 * se), np.max(np.abs(S - K) / se)
    assert np.all(np.abs(draws.mean(0)) < 5 * np.sqrt(np.diag(K) / n))


# ---------------------------------------------------------------------------
# MarginalSparse
# ---------------------------------------------------------------------------

def _sparse_data(n=30, m=8, seed=5):
    rng = np.random.RandomState(seed)
    X = np.sort(rng.uniform(0, 5, n))[:, None].astype(np.float32)
    y = (np.sin(1.5 * X[:, 0]) + 0.2 * rng.randn(n)).astype(np.float32)
    Xu = np.linspace(0.2, 4.8, m)[:, None].astype(np.float32)
    Xnew = np.linspace(-0.5, 5.5, 11)[:, None].astype(np.float32)
    return X, y, Xu, Xnew


def _sparse(pm, approx, random_hyper, Xu=None):
    X, y, Xu0, _ = _sparse_data()
    Xu = Xu0 if Xu is None else Xu
    with pm.Model() as model:
        if random_hyper:
            ls = pm.Gamma("ls", alpha=2, beta=2)
            eta = pm.HalfNormal("eta", sigma=2)
        else:
            ls, eta = 0.9, 1.3
        cov = eta ** 2 * pm.gp.cov.ExpQuad(1, ls)
        gp = pm.gp.MarginalSparse(
            mean_func=pm.gp.mean.Constant(0.1), cov_func=cov, approx=approx)
        sigma = pm.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, Xu=Xu, y=y, noise=sigma)
    return model, gp


APPROX = ["FITC", "VFE", "DTC"]


@pytest.mark.parametrize("approx", APPROX)
def test_sparse_logp_matches_jax_with_constant_hyperparameters(approx):
    """(a) Where the JAX package is right: constant ``ls`` and ``eta``
    (``sigma``, a node argument there too, is random)."""
    (mj, _), (mt, _) = _sparse(pj, approx, False), _sparse(pt, approx, False)
    _logp_grad_match(mj, mt, _points(mj), jit=False)


@pytest.mark.parametrize("diag", [False, True], ids=["full", "diag"])
@pytest.mark.parametrize("approx", APPROX)
def test_sparse_conditional_matches_jax_with_constant_hyperparameters(
        approx, diag):
    _, _, _, Xnew = _sparse_data()
    res = []
    for pm in (pj, pt):
        model, gp = _sparse(pm, approx, False)
        with model:
            nodes = gp._build_conditional(
                pm.node.as_node(Xnew), True, diag, *gp._get_given_vals(None))
        res.append((model, nodes))
    point = res[0][0].array_to_dict(_points(res[0][0], n=1)[0])
    want = res[0][0].makefn(list(res[0][1]))(point)
    got = res[1][0].makefn(list(res[1][1]))(point)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **COND)


def _sparse_numpy_logp(approx, ls, eta, sigma, mean=0.1, jitter=5e-4):
    """The JAX package's formulas (``gp.py:317-360``) in float64 numpy, with
    the covariances at these hyperparameters and the port's jitter."""
    X, y, Xu, _ = _sparse_data()
    x, u = X[:, 0].astype(np.float64), Xu[:, 0].astype(np.float64)

    def k(a, b):
        return eta ** 2 * np.exp(-0.5 * (a[:, None] - b[None, :]) ** 2
                                 / ls ** 2)
    Kuu, Kuf = k(u, u), k(u, x)
    Kffd = np.full(len(x), eta ** 2)
    # the port's jitter: 5e-4, or m eps32 max(diag Kuu) where larger
    jitter = max(jitter, len(u) * np.finfo(np.float32).eps * Kuu.max())
    Luu = np.linalg.cholesky(Kuu + jitter * np.eye(len(u)))
    A = np.linalg.solve(Luu, Kuf)
    Qffd = np.sum(A * A, 0)
    s2 = sigma ** 2
    if approx == "FITC":
        Lamd = np.clip(Kffd - Qffd, 0, None) + s2
        trace = 0.0
    elif approx == "VFE":
        Lamd = np.full(len(x), s2)
        trace = -0.5 / s2 * (Kffd.sum() - Qffd.sum())
    else:
        Lamd = np.full(len(x), s2)
        trace = 0.0
    L_B = np.linalg.cholesky(np.eye(len(u)) + (A / Lamd) @ A.T)
    r = y.astype(np.float64) - mean
    r_l = r / Lamd
    c = np.linalg.solve(L_B, A @ r_l)
    logdet = 0.5 * np.sum(np.log(Lamd)) + np.sum(np.log(np.diag(L_B)))
    quad = 0.5 * (r @ r_l - c @ c)
    return -(0.5 * len(x) * np.log(2 * np.pi) + logdet + quad) + trace


def _unconstrained(q):
    """(ls, eta, sigma) from the unconstrained (ls_log__, eta_log__,
    sigma_log__)."""
    return tuple(np.exp(np.asarray(q, np.float64)))


@pytest.mark.parametrize("approx", APPROX)
def test_sparse_logp_follows_random_hyperparameters(approx):
    """(b) With ``ls`` and ``eta`` random: the port's sparse potential and
    its autograd gradient against the float64 numpy formulas at five
    points (the gradient by central differences, step 1e-4 in the
    unconstrained space). Tolerance rtol 2e-4 on the value and 2e-3 on the
    gradient plus 1e-3 x its largest entry: float32 factors of the 8 x 8
    inducing block carry the jitter 5e-4 against float64. A port that
    evaluated the covariances at the test values fails at once (a scratch
    copy that did so failed all three). The JAX package's own value is
    asserted NOT to move with ``ls``: at the first point, ``ls_log__`` + 0.5
    moves the port's potential by -0.93 and the JAX package's by 0.0 (its
    move in ``sigma_log__``, -13.0, against the port's -11.7, shows the rest
    of its formula at work). The fault is the reference's, recorded
    here."""
    mt, _ = _sparse(pt, approx, True)
    mj, _ = _sparse(pj, approx, True)
    assert [vm.var for vm in mt.ordering.vmap] == \
        ["ls_log__", "eta_log__", "sigma_log__"]
    rng = np.random.RandomState(7)
    q = (mt.dict_to_array(mt.test_point)[None]
         + 0.5 * rng.randn(5, 3)).astype(np.float32)
    fn = mt.datalogpt_point
    qt = torch.from_numpy(q).requires_grad_()
    vals = torch.func.vmap(fn)(qt)
    grad, = torch.autograd.grad(vals.sum(), qt)
    for i in range(5):
        want = _sparse_numpy_logp(approx, *_unconstrained(q[i]))
        np.testing.assert_allclose(float(vals[i].detach()), want, rtol=2e-4)
        h = 1e-4
        num = np.array([(_sparse_numpy_logp(approx, *_unconstrained(
            q[i].astype(np.float64) + h * e)) - _sparse_numpy_logp(
            approx, *_unconstrained(q[i].astype(np.float64) - h * e)))
            / (2 * h) for e in np.eye(3)])
        np.testing.assert_allclose(grad[i].numpy(), num, rtol=2e-3,
                                   atol=1e-3 * np.abs(num).max())
    # the JAX package's potential does not see ls
    jfn = mj.datalogpt_fn()
    q_ls = np.array([q[0], q[0] + np.array([0.5, 0, 0], np.float32)])
    jv = [float(jfn(jnp.asarray(r))) for r in q_ls]
    tv = [float(v) for v in mt.datalogpt_fn()(torch.from_numpy(q_ls))]
    assert abs(jv[1] - jv[0]) < 1e-3
    assert abs(tv[1] - tv[0]) > 0.1


def test_sparse_jitter_grows_with_the_inducing_covariance():
    """``Kuu``'s jitter is the JAX package's 5e-4, or m eps max(diag Kuu)
    where that is larger (below it the factor is rounding noise: on the
    card, a particle of the sparse notebook's model at ls = 7.6, eta = 206
    got a float32 logp 17 nats above the float64 value under 5e-4, and an
    SMC run kept it). Checked on the factor itself: Luu Luuᵀ - Kuu is the
    jitter times I (the factorisation runs in float64). Then, on that
    model, the tail point's logp stays more than 10 nats below the
    posterior mean's (19.5 in float64)."""
    gp = pt.gp.MarginalSparse(approx="FITC")
    rng = np.random.RandomState(3)
    x = np.sort(rng.uniform(0, 10, 20))
    for eta2 in (1.69, 42_600.0):
        Kuu = torch.tensor(eta2 * np.exp(-0.5 * (x[:, None] - x[None, :])
                                         ** 2), dtype=torch.float64)
        Luu = gp._factors(Kuu, torch.zeros(20, 5, dtype=torch.float64),
                          torch.ones(5, dtype=torch.float64), 1.0,
                          np.finfo(np.float32).eps)[0]
        jitter = max(5e-4, 20 * np.finfo(np.float32).eps * eta2)
        np.testing.assert_allclose(np.diag((Luu @ Luu.T - Kuu).numpy()),
                                   jitter, rtol=1e-6, atol=1e-9 * eta2)
    from pymc3_tpu_torch.examples.suite import sparse_fitc_model
    model = sparse_fitc_model(pt)[0]
    q = torch.tensor(np.log([[7.6, 206.0, 0.99], [1.12, 3.9, 1.004]]),
                     dtype=torch.float32)
    tail, bulk = model.datalogpt_fn()(q).tolist()
    assert tail < bulk - 10.0, (tail, bulk)


def test_vfe_with_every_input_inducing_is_the_marginal_likelihood():
    """(c) VFE with ``Xu = X`` against ``Marginal``'s logp, ``ls``, ``eta``
    and ``sigma`` random, at five points. They differ only by the jitter j
    that VFE adds to ``Kuu``: Kff - Qff then has eigenvalues in [0, j], so
    the trace term moves by at most n j / (2 sigma^2), the log determinant
    by as much and the quadratic form by |r|^2 j / (2 sigma^4); the bound
    is their sum plus float32 rounding (1e-4 relative)."""
    X, y, _, _ = _sparse_data()
    mt, _ = _sparse(pt, "VFE", True, Xu=X)
    with pt.Model() as md:
        ls = pt.Gamma("ls", alpha=2, beta=2)
        eta = pt.HalfNormal("eta", sigma=2)
        gp = pt.gp.Marginal(mean_func=pt.gp.mean.Constant(0.1),
                            cov_func=eta ** 2 * pt.gp.cov.ExpQuad(1, ls))
        sigma = pt.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    rng = np.random.RandomState(8)
    q = (mt.dict_to_array(mt.test_point)[None]
         + 0.3 * rng.randn(5, 3)).astype(np.float32)
    sparse = mt.datalogpt_fn()(torch.from_numpy(q)).numpy()
    dense = md.datalogpt_fn()(torch.from_numpy(q)).numpy()
    j = tutil._default_jitter()
    r2 = float(np.sum((y - 0.1) ** 2))
    for i in range(5):
        s2 = float(np.exp(2 * q[i, 2]))
        bound = len(y) * j / s2 + r2 * j / (2 * s2 ** 2) \
            + 1e-4 * abs(dense[i])
        assert abs(sparse[i] - dense[i]) < bound, (sparse[i], dense[i], bound)


def test_sparse_rejects_unknown_approximation_and_mixed_sums():
    with pytest.raises(NotImplementedError):
        pt.gp.MarginalSparse(approx="SVGP")
    a = pt.gp.MarginalSparse(approx="FITC")
    b = pt.gp.MarginalSparse(approx="VFE")
    with pytest.raises(TypeError):
        a + b
    assert (a + pt.gp.MarginalSparse(approx="FITC")).approx == "FITC"


# ---------------------------------------------------------------------------
# Kronecker GPs
# ---------------------------------------------------------------------------

def _grid():
    x1 = np.linspace(0, 3, 6)[:, None].astype(np.float32)
    x2 = np.linspace(0, 2, 4)[:, None].astype(np.float32)
    rng = np.random.RandomState(9)
    y = (np.sin(x1) * np.cos(x2.T)).reshape(-1) + 0.2 * rng.randn(24)
    Xnew = np.stack([np.linspace(0.1, 2.9, 5), np.linspace(1.9, 0.1, 5)],
                    1).astype(np.float32)
    return x1, x2, y.astype(np.float32), Xnew


def _kron(pm, kind, constant=False):
    x1, x2, y, _ = _grid()
    with pm.Model() as model:
        if constant:
            ls1, ls2 = 0.9, 0.7
        else:
            ls1 = pm.Gamma("ls1", alpha=2, beta=2)
            ls2 = pm.Gamma("ls2", alpha=2, beta=2)
        covs = [pm.gp.cov.ExpQuad(1, ls1), pm.gp.cov.Matern52(1, ls2)]
        if kind == "latent":
            gp = pm.gp.LatentKron(cov_funcs=covs)
            f = gp.prior("f", Xs=[x1, x2])
            pm.Normal("y", mu=f, sigma=0.3, observed=y)
        else:
            gp = pm.gp.MarginalKron(cov_funcs=covs)
            sigma = pm.HalfNormal("sigma", sigma=1)
            gp.marginal_likelihood("y", Xs=[x1, x2], y=y, sigma=sigma)
    return model, gp


@pytest.mark.parametrize("kind", ["latent", "marginal"])
def test_kron_logp_matches_jax(kind):
    (mj, _), (mt, _) = _kron(pj, kind), _kron(pt, kind)
    _logp_grad_match(mj, mt, _points(mj))


def test_latent_kron_f_is_the_dense_cholesky_times_the_rotated_vector():
    """f = chol(K1 + jI) ⊗ chol(K2 + jI) v, which is the Cholesky factor
    of (K1 + jI) ⊗ (K2 + jI): against that factor in float64."""
    mt, gp = _kron(pt, "latent")
    x1, x2, _, _ = _grid()
    q = _points(mt, n=1)[0]
    point = mt.array_to_dict(q)
    f = mt.makefn(mt["f"])(point)
    env = {"ls1": torch.tensor(np.exp(point["ls1_log__"])),
           "ls2": torch.tensor(np.exp(point["ls2_log__"]))}
    Ks = [_np(teval(tutil.stabilize(c(x)), env)).astype(np.float64)
          for c, x in zip(gp.cov_funcs, (x1, x2))]
    L = np.linalg.cholesky(np.kron(*Ks))
    np.testing.assert_allclose(f, L @ point["f_rotated_"], rtol=1e-4,
                               atol=1e-5)


def test_marginal_kron_is_the_dense_marginal_on_the_grid(monkeypatch):
    """With no jitter the Kronecker likelihood is the dense ``Marginal``'s
    on the cartesian grid (the product kernel over its two columns): logp
    and gradient at five points, rtol 1e-4 (float32 eigendecompositions of
    the factors against a Cholesky of the 24 x 24 product)."""
    monkeypatch.setattr(tutil, "_default_jitter", lambda: 0.0)
    x1, x2, y, _ = _grid()
    mk, _ = _kron(pt, "marginal")
    with pt.Model() as md:
        ls1 = pt.Gamma("ls1", alpha=2, beta=2)
        ls2 = pt.Gamma("ls2", alpha=2, beta=2)
        sigma = pt.HalfNormal("sigma", sigma=1)
        cov = pt.gp.cov.ExpQuad(2, ls1, active_dims=[0]) * \
            pt.gp.cov.Matern52(2, ls2, active_dims=[1])
        pt.gp.Marginal(cov_func=cov).marginal_likelihood(
            "y", X=pt.math.cartesian(x1[:, 0], x2[:, 0]).astype(np.float32),
            y=y, noise=sigma)
    q = torch.from_numpy(_points(mk))
    (lk, gk), (ld, gd) = (m.logp_dlogp_function()(q) for m in (mk, md))
    np.testing.assert_allclose(lk.numpy(), ld.numpy(), rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), gd.numpy(), rtol=1e-3,
                               atol=1e-3 * float(gd.abs().max()))


def test_marginal_kron_gradient_is_finite_on_a_degenerate_spectrum(
        monkeypatch):
    """On the 50 x 30 grid of ``examples/suite.py::kron_model`` most of each
    factor's eigenvalues sit at the jitter, equal to rounding, and autograd
    through ``eigh`` divides by their differences: at these two points near
    the test point it gave NaN gradients (so would the JAX package's, which
    differentiates ``eigh`` too). The port's backward never differentiates
    the eigenvectors: finite, and with no jitter equal to the dense
    ``Marginal``'s gradient on the 1,500-point grid (rtol 1e-3 and atol
    1e-3 x the largest entry: float32 eigendecompositions against one
    float32 Cholesky of the 1,500 x 1,500 matrix)."""
    from pymc3_tpu_torch.examples.suite import kron_model
    q = torch.tensor([[1.0407461, 0.3161065, -0.1517235],
                      [0.7296543, 0.4390215, 0.1472679]])
    lk, gk = kron_model(pt).logp_dlogp_function()(q)
    assert torch.isfinite(lk).all() and torch.isfinite(gk).all()
    monkeypatch.setattr(tutil, "_default_jitter", lambda: 0.0)
    (lk, gk), (ld, gd) = (kron_model(pt, dense).logp_dlogp_function()(q)
                          for dense in (False, True))
    np.testing.assert_allclose(lk.numpy(), ld.numpy(), rtol=1e-4)
    np.testing.assert_allclose(gk.numpy(), gd.numpy(), rtol=1e-3,
                               atol=1e-3 * float(gd.abs().max()))


@pytest.mark.parametrize("kind", ["latent", "marginal"])
def test_kron_conditional_matches_jax_and_moves_with_lengthscales(kind):
    """Against JAX with constant lengthscales, where the JAX conditional
    (which evaluates K(X, Xnew) and K(Xnew) at the test values) is right;
    with random lengthscales the port's conditional covariance must move
    with them."""
    _, _, _, Xnew = _grid()
    res = []
    for pm in (pj, pt):
        model, gp = _kron(pm, kind, constant=True)
        with model:
            nodes = (gp._build_conditional(Xnew) if kind == "latent"
                     else gp._build_conditional(Xnew, True, False))
        res.append((model, nodes))
    point = res[0][0].array_to_dict(_points(res[0][0], n=1)[0])
    want = res[0][0].makefn(list(res[0][1]))(point)
    got = res[1][0].makefn(list(res[1][1]))(point)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **COND)

    model, gp = _kron(pt, kind)
    with model:
        nodes = (gp._build_conditional(Xnew) if kind == "latent"
                 else gp._build_conditional(Xnew, True, False))
    a, b = (model.makefn(list(nodes))(model.array_to_dict(r))
            for r in _points(model, n=2))
    assert np.abs(a[1] - b[1]).max() > 1e-3


def test_marginal_kron_conditional_is_the_dense_conditional(monkeypatch):
    """With no jitter, ``MarginalKron``'s conditional with predictive noise
    is the dense ``Marginal``'s on the cartesian grid (COND tolerance)."""
    monkeypatch.setattr(tutil, "_default_jitter", lambda: 0.0)
    x1, x2, y, Xnew = _grid()
    mk, gk = _kron(pt, "marginal", constant=True)
    with pt.Model() as md:
        sigma = pt.HalfNormal("sigma", sigma=1)
        cov = pt.gp.cov.ExpQuad(2, 0.9, active_dims=[0]) * \
            pt.gp.cov.Matern52(2, 0.7, active_dims=[1])
        gd = pt.gp.Marginal(cov_func=cov)
        gd.marginal_likelihood(
            "y", X=pt.math.cartesian(x1[:, 0], x2[:, 0]).astype(np.float32),
            y=y, noise=sigma)
    point = {"sigma_log__": np.float32(-0.4)}
    with mk:
        want = mk.makefn(list(gk._build_conditional(Xnew, True, False)))(
            point)
    with md:
        got = md.makefn(list(gd.predictt(Xnew, pred_noise=True)))(point)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **COND)
