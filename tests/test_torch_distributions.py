"""The port's continuous distributions, Bound and mixtures against the JAX
package, on the parameter grids of ``tests/test_distributions_matrix.py``
and ``tests/test_mixture_matrix.py``.

Tolerances (float32 in both packages):

- logp and logcdf: rtol = atol = 1.5e-3 x the row's ``tol_scale`` (the
  grids' own tolerance), and the same support mask (finite in one package
  exactly where it is finite in the other);
- the gradient of the summed logp in the value and in every parameter
  against ``jax.grad``: rtol 1e-3, atol 1e-3 x max(1, the largest
  gradient of that argument), on the grid points inside the support, at
  the middle parameter set of each row. A
  point where the value equals a parameter is left out: it is a kink of
  Laplace and Triangular, where the packages pick different subgradients.
"""
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu_torch.distributions.dist_math import (
    betainc, gammainc, gammaincc)
from . import torch_models  # noqa: F401  (asks the port for the CPU)

from .test_distributions_matrix import (
    CONTINUOUS_LOGP, CONTINUOUS_LOGCDF, TAIL_CASES, combos,
)
from .test_mixture_matrix import ND_CELLS

torch.set_num_threads(2)
BASE_TOL = 1.5e-3
GRAD_RTOL = 1e-3


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def port_cls(jax_cls):
    return getattr(pt, jax_cls.__name__)


def _values(dist_j, dist_t, method, grid):
    v = np.asarray(grid, dtype=np.float32)
    want = np.asarray(getattr(dist_j, method)(v), dtype=np.float64)
    got = getattr(dist_t, method)(v).numpy().astype(np.float64)
    return got, want


@pytest.mark.parametrize("name,dist,domains,grid,logpdf,tol_scale",
                         CONTINUOUS_LOGP, ids=[e[0] for e in CONTINUOUS_LOGP])
def test_logp_matches_jax(name, dist, domains, grid, logpdf, tol_scale):
    tol = BASE_TOL * tol_scale
    for params in combos(domains):
        got, want = _values(dist.dist(**params), port_cls(dist).dist(**params),
                            "logp", grid)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                      err_msg=f"{name} support at {params}")
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=tol,
                                   atol=tol, err_msg=f"{name} at {params}")


@pytest.mark.parametrize("name,dist,domains,grid,logcdf,tol_scale",
                         CONTINUOUS_LOGCDF,
                         ids=[e[0] for e in CONTINUOUS_LOGCDF])
def test_logcdf_matches_jax(name, dist, domains, grid, logcdf, tol_scale):
    tol = BASE_TOL * tol_scale
    for params in combos(domains):
        got, want = _values(dist.dist(**params), port_cls(dist).dist(**params),
                            "logcdf", grid)
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want),
                                      err_msg=f"{name} support at {params}")
        finite = np.isfinite(want)
        np.testing.assert_allclose(got[finite], want[finite], rtol=tol,
                                   atol=tol, err_msg=f"{name} at {params}")
        # and against scipy's float64 oracle, as the JAX grid does
        with np.errstate(all="ignore"):
            oracle = np.array([logcdf(x, **params) for x in grid])
        ok = np.isfinite(oracle)
        np.testing.assert_allclose(got[ok], oracle[ok], rtol=tol, atol=tol)


@pytest.mark.parametrize("name,dist,params,lo,hi,deep", TAIL_CASES,
                         ids=[e[0] for e in TAIL_CASES])
def test_logcdf_tails(name, dist, params, lo, hi, deep):
    """No NaN, monotone, saturating at 0 on the right, the same values as
    the JAX package where it is finite (cf. ``check_logcdf_tails``)."""
    d = port_cls(dist).dist(**params)
    grid = np.asarray(sorted(lo + hi), dtype=np.float32)
    got = d.logcdf(grid).numpy()
    assert not np.any(np.isnan(got))
    finite = got[np.isfinite(got)]
    assert np.all(finite <= 1e-6)
    assert np.all(np.diff(finite) >= -1e-5)
    assert abs(float(got[-1])) < 5e-2
    assert float(got[0]) < -5.0
    deep_got = d.logcdf(np.asarray(deep, dtype=np.float32)).numpy()
    assert not np.any(np.isnan(deep_got))
    want = np.asarray(dist.dist(**params).logcdf(grid))
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=1e-3, atol=1e-3)


# -- gradients ----------------------------------------------------------------
def _grads_jax(dist, params, v):
    names = list(params)
    with pj.Model():
        nodes = {k: pj.Flat(k, testval=np.float32(params[k])) for k in names}
        d = dist.dist(**nodes)

    def f(value, *ps):
        return jnp.sum(d.logp(value, dict(zip(names, ps)), {}))
    args = [jnp.asarray(v)] + [jnp.float32(params[k]) for k in names]
    return [np.asarray(g) for g in
            jax.grad(f, argnums=tuple(range(len(args))))(*args)]


def _grads_port(dist, params, v):
    names = list(params)
    with pt.Model():
        nodes = {k: pt.Flat(k, testval=np.float32(params[k])) for k in names}
        d = port_cls(dist).dist(**nodes)
    args = [torch.tensor(v, requires_grad=True)] + [
        torch.tensor(np.float32(params[k]), requires_grad=True)
        for k in names]
    lp = torch.sum(d.logp(args[0], dict(zip(names, args[1:])), {}))
    # a density flat in the value (Uniform) has a zero gradient, as in JAX
    return [g.numpy() for g in torch.autograd.grad(
        lp, args, allow_unused=True, materialize_grads=True)]


@pytest.mark.parametrize("name,dist,domains,grid,logpdf,tol_scale",
                         CONTINUOUS_LOGP, ids=[e[0] for e in CONTINUOUS_LOGP])
def test_logp_gradient_matches_jax(name, dist, domains, grid, logpdf,
                                   tol_scale):
    sets = combos(domains)
    for params in (sets[len(sets) // 2],):
        v = np.asarray(grid, dtype=np.float32)
        # the support masks agree (test_logp_matches_jax)
        inside = np.isfinite(port_cls(dist).dist(**params).logp(v).numpy())
        inside &= ~np.isin(v, np.float32(list(params.values())))
        if not inside.any():
            continue
        v = v[inside]
        want = _grads_jax(dist, params, v)
        got = _grads_port(dist, params, v)
        for arg, g, w in zip(["value"] + list(params), got, want):
            scale = max(1.0, float(np.max(np.abs(w))))
            np.testing.assert_allclose(
                g, w, rtol=GRAD_RTOL, atol=GRAD_RTOL * scale,
                err_msg=f"{name} d/d{arg} at {params}")


@pytest.mark.parametrize("cls,params,grid", [
    ("Beta", dict(alpha=2.0, beta=3.0), [0.05, 0.3, 0.6, 0.95]),
    ("StudentT", dict(nu=3.0, mu=0.5, sigma=2.0), [-9.0, -1.0, 0.7, 4.0]),
    ("Gamma", dict(alpha=2.5, beta=1.5), [0.1, 1.0, 3.0]),
    ("InverseGamma", dict(alpha=3.0, beta=2.0), [0.2, 1.0, 4.0]),
], ids=["beta", "studentt", "gamma", "inversegamma"])
def test_logcdf_gradient_in_value(cls, params, grid):
    """betainc's gradient in x is the Beta density, gammainc's the Gamma
    density."""
    v = np.asarray(grid, dtype=np.float32)
    dj = getattr(pj, cls).dist(**params)
    want = np.asarray(jax.grad(lambda x: jnp.sum(dj.logcdf(x)))(
        jnp.asarray(v)))
    x = torch.tensor(v, requires_grad=True)
    got, = torch.autograd.grad(getattr(pt, cls).dist(**params)
                               .logcdf(x).sum(), x)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=1e-5)


def test_shape_parameter_gradients_of_the_incomplete_functions_raise():
    """No silent zero: the derivative of the incomplete beta in its shape
    parameters is not implemented and raises. The incomplete gamma is the
    port's own and has its shape derivative, where torch's raises."""
    a = torch.tensor(2.0, requires_grad=True)
    with pytest.raises(NotImplementedError):
        betainc(a, torch.tensor(3.0), torch.tensor(0.4)).backward()
    with pytest.raises(RuntimeError, match="igamma"):
        torch.special.gammainc(a, torch.tensor(1.0)).backward()
    gammainc(a, torch.tensor(1.0)).backward()
    assert torch.isfinite(a.grad) and float(a.grad) < 0.0


# -- the incomplete gamma and its shape derivative ----------------------------
GAMMA_SHAPES = [0.3, 1.0, 2.5, 20.0, 150.0]
# beta * x (Gamma) or beta / x (InverseGamma) relative to alpha: both the
# series (x < a + 1) and the continued fraction run
BOTH_SIDES = np.array([0.5, 0.9, 1.2, 1.8])


@pytest.mark.parametrize("upper", [False, True], ids=["lower", "upper"])
def test_gammainc_matches_scipy(upper):
    import scipy.special as sp
    rng = np.random.default_rng(1)
    a = rng.uniform(0.05, 500.0, 2000)
    x = a * rng.uniform(0.01, 3.0, 2000)
    fn, oracle = ((gammaincc, sp.gammaincc) if upper
                  else (gammainc, sp.gammainc))
    got = fn(torch.tensor(a), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, oracle(a, x), rtol=1e-10, atol=1e-13)


def _logcdf_inputs(cls, alpha, dtype):
    beta = dtype(1.5)
    t = dtype(alpha) * BOTH_SIDES.astype(dtype)
    return beta, (t / beta if cls == "Gamma" else beta / t).astype(dtype)


def _port_alpha_grad(cls, alpha, beta, x, dtype):
    with pt.Model():
        node = pt.Flat("a", testval=np.float32(alpha))
        d = getattr(pt, cls).dist(alpha=node, beta=beta)
    a = torch.tensor(alpha, dtype=dtype, requires_grad=True)
    lp = d.logcdf(torch.as_tensor(x, dtype=dtype), {"a": a}, {}).sum()
    return float(torch.autograd.grad(lp, a)[0])


@pytest.mark.parametrize("alpha", GAMMA_SHAPES)
@pytest.mark.parametrize("cls", ["Gamma", "InverseGamma"])
def test_logcdf_gradient_in_alpha_matches_jax(cls, alpha):
    """rtol 1e-5: the inputs are float32 in both packages; the port sums
    its series in float64 and rounds once, ``jax.grad`` carries
    ``igamma_grad_a`` in float32 (its own error is a few 1e-6)."""
    beta, x = _logcdf_inputs(cls, alpha, np.float32)
    with pj.Model():
        node = pj.Flat("a", testval=np.float32(alpha))
        dj = getattr(pj, cls).dist(alpha=node, beta=beta)
    want = float(jax.grad(lambda a: jnp.sum(
        dj.logcdf(jnp.asarray(x), {"a": a}, {})))(jnp.float32(alpha)))
    got = _port_alpha_grad(cls, alpha, beta, x, torch.float32)
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("alpha", GAMMA_SHAPES)
@pytest.mark.parametrize("cls", ["Gamma", "InverseGamma"])
def test_logcdf_gradient_in_alpha_matches_scipy_difference(cls, alpha):
    """Against a central difference of scipy's float64 incomplete gamma
    (step 1e-5 max(alpha, 1); truncation and rounding leave about 1e-7)."""
    import scipy.special as sp
    beta, x = _logcdf_inputs(cls, alpha, np.float64)

    def logcdf(a):
        if cls == "Gamma":
            return np.log(sp.gammainc(a, beta * x)).sum()
        return np.log(sp.gammaincc(a, beta / x)).sum()
    h = 1e-5 * max(alpha, 1.0)
    want = (logcdf(alpha + h) - logcdf(alpha - h)) / (2.0 * h)
    got = _port_alpha_grad(cls, alpha, beta, x, torch.float64)
    assert got == pytest.approx(want, rel=1e-6)


def test_gammainc_batches_under_vmap_of_grad():
    """No host loop, no data-dependent branch: the value and both
    gradients batch under ``torch.func.vmap``."""
    a = torch.tensor([0.3, 2.5, 20.0], dtype=torch.float64)
    x = torch.tensor([0.5, 2.0, 30.0], dtype=torch.float64)
    ga, gx = torch.func.vmap(torch.func.grad(
        lambda a_, x_: torch.log(gammainc(a_, x_)), argnums=(0, 1)))(a, x)
    for i in range(3):
        ai = a[i].clone().requires_grad_()
        xi = x[i].clone().requires_grad_()
        wa, wx = torch.autograd.grad(torch.log(gammainc(ai, xi)), (ai, xi))
        assert float(ga[i]) == pytest.approx(float(wa), rel=1e-12)
        assert float(gx[i]) == pytest.approx(float(wx), rel=1e-12)


def test_betainc_matches_scipy():
    import scipy.special as sp
    rng = np.random.default_rng(0)
    a = rng.uniform(0.05, 200.0, 500)
    b = rng.uniform(0.05, 200.0, 500)
    x = rng.uniform(0.0, 1.0, 500)
    got = betainc(torch.tensor(a), torch.tensor(b), torch.tensor(x)).numpy()
    np.testing.assert_allclose(got, sp.betainc(a, b, x), rtol=1e-10,
                               atol=1e-13)


# -- Bound and mixtures ---------------------------------------------------------
def test_bound_matches_jax():
    v = np.linspace(-2.0, 3.0, 11).astype(np.float32)
    for lower, upper in [(0.0, None), (None, 1.0), (-1.0, 2.0)]:
        dj = pj.Bound(pj.Normal, lower=lower, upper=upper).dist(mu=0.5,
                                                                sigma=1.5)
        dt = pt.Bound(pt.Normal, lower=lower, upper=upper).dist(mu=0.5,
                                                                sigma=1.5)
        want = np.asarray(dj.logp(v))
        got = dt.logp(v).numpy()
        np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], rtol=1e-6)
        assert dt.transform.name == dj.transform.name
        np.testing.assert_allclose(dt.default(), dj.default())


def _bounded_model(pm):
    with pm.Model() as m:
        PosNormal = pm.Bound(pm.Normal, lower=0.0)
        s = PosNormal("s", mu=1.0, sigma=2.0)
        pm.Normal("y", mu=0.0, sigma=s, observed=np.array([0.3, -1.2, 2.0]))
    return m


def test_bounded_model_matches_jax():
    from .test_torch_transforms import check_model_parity
    check_model_parity(_bounded_model(pj), _bounded_model(pt))


@pytest.mark.parametrize("nd,ncomp", ND_CELLS,
                         ids=[f"nd{n}-K{k}" for n, k in ND_CELLS])
def test_normal_mixture_nd_matches_jax(nd, ncomp):
    rng = np.random.default_rng(nd * 10 + ncomp)
    w = rng.dirichlet(np.full(ncomp, 2.0))
    mu = rng.normal(scale=2.0, size=(nd, ncomp))
    sigma = rng.uniform(0.5, 1.5, size=(nd, ncomp))
    kw = dict(w=w, mu=mu, sigma=sigma, comp_shape=(nd, ncomp), shape=(nd,))
    vals = rng.normal(scale=2.0, size=(6, nd)).astype(np.float32)
    want = np.asarray(pj.NormalMixture.dist(**kw).logp(vals))
    got = pt.NormalMixture.dist(**kw).logp(vals).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_mixture_of_list_and_weight_check_match_jax():
    w = np.array([0.2, 0.5, 0.3])
    vals = np.linspace(-4.0, 5.0, 12).astype(np.float32)
    for pm in (pj, pt):
        pm._mix = pm.Mixture.dist(
            w=w, comp_dists=[pm.Normal.dist(mu=m, sigma=s) for m, s in
                             zip([-2.0, 0.5, 3.0], [0.5, 1.0, 2.0])])
    np.testing.assert_allclose(pt._mix.logp(vals).numpy(),
                               np.asarray(pj._mix.logp(vals)), rtol=2e-5,
                               atol=2e-5)
    np.testing.assert_allclose(pt._mix.default(), pj._mix.default(),
                               rtol=1e-6)
    for bad_w in ([0.5, 0.2], [-0.2, 1.2]):
        d = pt.NormalMixture.dist(w=np.array(bad_w), mu=np.array([0.0, 1.0]),
                                  sigma=1.0)
        assert torch.isneginf(d.logp(np.float32(0.5)))


def test_symbolic_logp_and_logcdf_nodes():
    """dist.logp(node) is a node evaluated against the environment."""
    with pt.Model():
        x = pt.Normal("x", 0.0, 1.0)
        node = pt.Normal.dist(mu=1.0, sigma=2.0).logcdf(x)
    assert isinstance(node, pt.node.Node)
    got = float(node.eval({"x": torch.tensor(0.3)}))
    want = float(np.asarray(pj.Normal.dist(mu=1.0, sigma=2.0).logcdf(0.3)))
    assert got == pytest.approx(want, rel=1e-5)


def test_import_leaves_no_jax_module():
    code = ("import sys, pymc3_tpu_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('pymc3_tpu.') "
            "or m == 'pymc3_tpu']; print(bad); assert not bad")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
