"""The port at ``floatX = "float64"`` against the JAX package at x64, on
the CPU, from the same seeded numpy inputs.

Both packages go to float64 through one fixture (``_float64``, as
``tests/test_torch_ode.py``'s ``f64``) and back afterwards. Tolerances: rtol
1e-10 for the deterministic pieces (atol 1e-10 x the largest magnitude
where a sum cancels), 1e-8 for the accumulated optimizer steps, and, for
the float32 half of the GARCH test, rtol 1e-4 with atol 1e-4 x the largest
gradient (float32 sums of 2,000 terms in another order). Each docstring
says which.

- (a) logp of every continuous, discrete and multivariate family at one
  seeded parameter set, over the tables of the port's float32 tests;
- (b) radon's logp and gradient at 8 chains;
- (c) one NUTS transition on the JAX transition's replayed noise, after
  converting the JAX x64 kernel state with ``convert``;
- (d) ``find_reasonable_eps`` on the JAX probe's momenta;
- (e) a GP ``Marginal``'s logp and gradient, and ``predict``;
- (f) 20 Adam and 20 Adamax steps on the same gradients;
- (g) one SMC beta stage and systematic resampling;
- (h) the blocked GARCH11 volatility against the JAX package's scan at
  n = 2000 (float32 and float64), and the memory it holds.

Then the environment switches (``PYMC3_TPU_FLOATX``,
``PYMC3_TPU_NO_EPS_PROBE``) in fresh processes, and the covariance
kernels' dtype checks.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu.smc import smc as jsmc
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu.step_methods.hmc import nuts as jnuts
from pymc3_tpu.variational import updates as ju
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.distributions import timeseries as tts
from pymc3_tpu_torch.examples.radon import build_model as radon_model
from pymc3_tpu_torch.ops import gp_cov
from pymc3_tpu_torch.smc import smc as tsmc
from pymc3_tpu_torch.step_methods.arraystep import TuneContext
from pymc3_tpu_torch.step_methods.hmc import nuts as tnuts
from pymc3_tpu_torch.variational import updates as tu

from .test_distributions_matrix import CONTINUOUS_LOGP, combos
from .test_multivariate_matrix import (
    DIRICHLET_AS, KRON_CELLS, MATNORM_CELLS, MULTINOMIAL_CELLS, MVN_CELLS,
    MVT_CELLS, WISHART_CELLS, _param_variants, _spd,
)
from .test_torch_discrete import CELLS as DISCRETE_CELLS, GRID
from .test_torch_hmc import ReplayNoise
from .test_torch_gp_predict import _both as gp_predict_models
from .torch_models import gp_model

torch.set_num_threads(2)
RTOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _float64():
    prev = jax.config.jax_enable_x64, pj.get_config().floatX
    pj.set_config(floatX="float64")
    pt.set_config(floatX="float64")
    yield
    pt.set_config(floatX="float32")
    pj.set_config(floatX=prev[1])
    jax.config.update("jax_enable_x64", prev[0])


def _close(got, want, rtol=RTOL, scale=None):
    """rtol, and atol rtol x ``scale`` (the largest |want| by default)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == np.float64, got.dtype
    scale = float(np.max(np.abs(want))) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol * scale)


def _logp_grad(mj, mt, q, rtol=RTOL):
    """logp and gradient of both models at the rows of ``q``."""
    vag = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))
    lj, gj = vag(jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.as_tensor(q))
    _close(lt.numpy(), lj, rtol)
    _close(gt.numpy(), gj, rtol)


# -- (a) every family's logp -------------------------------------------------
def _middle(domains):
    params = combos(domains)
    return params[len(params) // 2]


@pytest.mark.parametrize("name,dist,domains,grid,logpdf,tol_scale",
                         CONTINUOUS_LOGP, ids=[e[0] for e in CONTINUOUS_LOGP])
def test_continuous_logp(name, dist, domains, grid, logpdf, tol_scale):
    """The middle parameter set of each row, over its grid: rtol 1e-10,
    the same support."""
    params = _middle(domains)
    v = np.asarray(grid, np.float64)
    want = np.asarray(dist.dist(**params).logp(v))
    got = getattr(pt, dist.__name__).dist(**params).logp(v).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], scale=0.0)


@pytest.mark.parametrize("name", list(DISCRETE_CELLS))
def test_discrete_logp(name):
    """Each cell of the discrete test over its value grid: rtol 1e-10, -inf
    in the same places, and a float64 logp (``DiscreteUniform``'s took
    torch's default float32 from its integer bounds)."""
    cls = name.split("_")[0]
    params = DISCRETE_CELLS[name][0]
    v = GRID.astype(np.float64)
    want = np.asarray(getattr(pj, cls).dist(**params).logp(v))
    got = getattr(pt, cls).dist(**params).logp(v).numpy()
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    _close(got[fin], want[fin], scale=0.0)


def _mv_cases():
    """One seeded cell of each multivariate family's table:
    ``(class name, parameters, values)``."""
    rng = np.random.default_rng(1)
    k, kind, param = MVN_CELLS[13]
    cov = _spd(k, kind)
    mu = rng.normal(scale=0.5, size=k)
    yield ("MvNormal", dict(mu=mu, **_param_variants(cov)[param]),
           rng.multivariate_normal(mu, cov, size=4))
    k, nu, param = MVT_CELLS[7]
    cov = _spd(k, "corr", seed=3)
    mu = rng.normal(scale=0.5, size=k)
    yield ("MvStudentT", dict(nu=nu, mu=mu, **_param_variants(cov)[param]),
           rng.multivariate_normal(mu, cov, size=4))
    a = DIRICHLET_AS[3]
    yield "Dirichlet", dict(a=a), rng.dirichlet(a, size=4)
    n, p = MULTINOMIAL_CELLS[2]
    yield "Multinomial", dict(n=n, p=p), rng.multinomial(n, p, size=4)
    p, dnu, kind = WISHART_CELLS[4]
    V = _spd(p, kind, seed=6)
    yield ("Wishart", dict(nu=p + dnu, V=V),
           np.cov(rng.normal(size=(p, 12))) * (p + dnu))
    yield "LKJCorr", dict(eta=2.0, n=3), rng.uniform(-0.2, 0.2, (4, 3))
    rowp, colp = MATNORM_CELLS[1]
    rowcov, colcov = _spd(3, "corr", seed=8), _spd(4, "diag", seed=9)
    M = rng.normal(size=(3, 4))
    yield ("MatrixNormal", dict(
        mu=M, shape=(3, 4),
        **{f"row{rowp}": _param_variants(rowcov)[rowp][rowp],
           f"col{colp}": _param_variants(colcov)[colp][colp]}),
           rng.normal(size=(3, 4)) + M)
    dims, sigma = KRON_CELLS[1]
    covs = [_spd(k, "corr", seed=11 + i) for i, k in enumerate(dims)]
    size = int(np.prod(dims))
    yield ("KroneckerNormal", dict(mu=np.zeros(size), covs=covs,
                                   sigma=sigma), rng.normal(size=(4, size)))


MV_CASES = list(_mv_cases())


@pytest.mark.parametrize("name,params,values", MV_CASES,
                         ids=[c[0] for c in MV_CASES])
def test_multivariate_logp(name, params, values):
    """One seeded cell of each multivariate table: rtol 1e-10."""
    if name == "Wishart":
        with pytest.warns(UserWarning):
            dj = pj.Wishart.dist(**params)
        with pytest.warns(UserWarning):
            dt = pt.Wishart.dist(**params)
    else:
        dj = getattr(pj, name).dist(**params)
        dt = getattr(pt, name).dist(**params)
    v = np.asarray(values, np.float64)
    _close(dt.logp(torch.as_tensor(v)).numpy(), np.asarray(dj.logp(v)))


def test_lkjcholeskycov_logp():
    """``LKJCholeskyCov`` with a ``HalfCauchy`` sd: rtol 1e-10."""
    v = np.array([1.0, 0.3, 0.8, -0.2, 0.1, 1.2])
    dj = pj.LKJCholeskyCov.dist(eta=2.0, n=3, sd_dist=pj.HalfCauchy.dist(2.5))
    dt = pt.LKJCholeskyCov.dist(eta=2.0, n=3, sd_dist=pt.HalfCauchy.dist(2.5))
    _close(dt.logp(torch.as_tensor(v)).numpy(), np.asarray(dj.logp(v)))


# -- (b) radon ---------------------------------------------------------------
def test_radon_logp_grad_at_8_chains():
    """``bench.py``'s radon model at 8 jittered points: logp and gradient,
    rtol 1e-10 (atol 1e-10 x the largest)."""
    mj, mt = radon_model(pj), radon_model(pt)
    rng = np.random.RandomState(4)
    q0 = mt.dict_to_array(mt.test_point)
    assert q0.dtype == np.float64
    _logp_grad(mj, mt, q0[None] + rng.uniform(-0.3, 0.3, (8, q0.size)))


# -- (c) one NUTS transition -------------------------------------------------
def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("pooled", [False, True])
def test_one_nuts_transition(pooled):
    """The GP model (n = 20) at 4 chains: the JAX x64 kernel state converts
    with every float leaf float64 and equal to the JAX leaf; then one
    transition on the JAX keys' replayed float64 noise gives the same
    depth and tree size, and the next q, log step and mass diagonal within
    rtol 1e-10 (atol 1e-10 x the largest)."""
    mj, mt = gp_model(pj, n=20), gp_model(pt, n=20)
    C, n, max_depth = 4, mt.ndim, 6
    axis = "chains_local" if pooled else None
    jstep = pj.NUTS(model=mj, max_treedepth=max_depth, axis_name=axis)
    tstep = pt.NUTS(model=mt, max_treedepth=max_depth, axis_name=axis)
    rng = np.random.RandomState(3)
    q0 = mt.dict_to_array(mt.test_point)[None] \
        + rng.uniform(-0.5, 0.5, (C, n))
    jinit = jax.vmap(jstep.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    tune = JaxTune(jnp.asarray(True), jnp.asarray(250, jnp.int32), 1000)
    jq, jst, jstats = jax.vmap(
        lambda k, q, s: jstep.kernel_step(k, q, s, tune),
        axis_name="chains_local")(keys, jnp.asarray(q0), jinit)

    tinit = convert.nuts_kernel_state(_np(jinit))
    leaves = jax.tree_util.tree_leaves(_np(jinit))
    tleaves = jax.tree_util.tree_leaves(tuple(tinit))
    assert len(leaves) == len(tleaves)
    for want, got in zip(leaves, tleaves):
        if np.issubdtype(want.dtype, np.floating):
            assert got.dtype == torch.float64
            np.testing.assert_array_equal(got.numpy(), want)
    tq, tst, tstats = tstep.kernel_step(
        torch.as_tensor(q0), tinit, TuneContext(True, 250, 1000),
        ReplayNoise(keys, n, max_depth, np.float64))
    np.testing.assert_array_equal(tstats["depth"].numpy(),
                                  np.asarray(jstats["depth"]))
    np.testing.assert_array_equal(tstats["tree_size"].numpy(),
                                  np.asarray(jstats["tree_size"]))
    _close(tq.numpy(), jq)
    _close(tst.da.log_step.numpy(), jst.da.log_step)
    _close(tst.pot.var.numpy(), jst.pot.var)


# -- (d) the step-size probe -------------------------------------------------
class _ProbeNoise:
    """The momenta of the JAX probe: standard normals from its key split
    over the chains (``find_reasonable_eps``, ``kernel_momentum``)."""

    def __init__(self, seed, chains, n):
        key = jax.random.PRNGKey((int(seed) ^ 0x5EED) & 0x7FFFFFFF)
        self.z = np.stack([np.asarray(jax.random.normal(k, (n,), jnp.float64))
                           for k in jax.random.split(key, chains)])

    def normal(self, dim):
        return torch.from_numpy(self.z)


def test_find_reasonable_eps():
    """The probe's step size on the GP model at 8 chains from the same
    momenta: equal to rtol 1e-10 (the port started from a float32-rounded
    step size)."""
    mj, mt = gp_model(pj, n=20), gp_model(pt, n=20)
    rng = np.random.RandomState(5)
    q0 = mt.dict_to_array(mt.test_point)[None] \
        + rng.uniform(-0.3, 0.3, (8, mt.ndim))
    jstep, tstep = pj.NUTS(model=mj), pt.NUTS(model=mt)
    assert jstep.step_size == tstep.step_size
    want = jnuts.find_reasonable_eps(jstep, q0, 7)
    got = tnuts.find_reasonable_eps(tstep, q0,
                                    noise=_ProbeNoise(7, 8, mt.ndim))
    assert want != jstep.step_size
    np.testing.assert_allclose(got, want, rtol=RTOL)


# -- (e) the GP --------------------------------------------------------------
def test_gp_marginal_logp_grad():
    """``Marginal.marginal_likelihood`` (n = 30, ExpQuad) at 6 jittered
    points: logp and gradient, rtol 1e-10."""
    mj, mt = gp_model(pj), gp_model(pt)
    rng = np.random.RandomState(6)
    q0 = mt.dict_to_array(mt.test_point)
    _logp_grad(mj, mt, q0[None] + rng.uniform(-0.4, 0.4, (6, q0.size)))


@pytest.mark.parametrize("diag", [True, False], ids=["diag", "full"])
@pytest.mark.parametrize("kernel", ["ExpQuad", "Matern52"])
def test_gp_predict(kernel, diag):
    """``Marginal.predict`` at 17 new inputs (d = 2) at one point of the JAX
    model, with predictive noise: mean and covariance float64, rtol 1e-10
    (atol 1e-10 x the largest)."""
    (mj, gj), (mt, gt), point, (_, _, Xnew) = gp_predict_models(kernel)
    with mj:
        mu_j, cov_j = gj.predict(Xnew, point=point, diag=diag,
                                 pred_noise=True)
    with mt:
        mu_t, cov_t = gt.predict(Xnew, point=point, diag=diag,
                                 pred_noise=True)
    _close(mu_t, mu_j)
    _close(cov_t, cov_j)


# -- (f) Adam and Adamax -----------------------------------------------------
def _tree(seed):
    rng = np.random.RandomState(seed)
    return {0: {"mu": rng.randn(5), "L": rng.randn(2, 3)}}


@pytest.mark.parametrize("name", ["adam", "adamax"])
def test_adam_adamax_20_steps(name):
    """20 steps from the same parameters on the same gradients: rtol 1e-8
    (atol 1e-8 x the largest; the bias corrections are the JAX package's
    in floatX, where the port took them in float32)."""
    jopt = getattr(ju, name)(learning_rate=0.2)
    topt = getattr(tu, name)(learning_rate=0.2)
    jp = jax.tree_util.tree_map(jnp.asarray, _tree(0))
    tp = tu.tree_map(torch.as_tensor, _tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(20):
        g = _tree(10 + k)
        jp, js = jopt.update(jax.tree_util.tree_map(jnp.asarray, g), js, jp)
        tp, ts = topt.update(tu.tree_map(torch.as_tensor, g), ts, tp)
    for key in ("mu", "L"):
        _close(tp[0][key].numpy(), jp[0][key], rtol=1e-8)


# -- (g) SMC -----------------------------------------------------------------
def test_smc_beta_stage_and_resampling():
    """One beta stage from beta = 0.05 on 2,000 seeded log likelihoods (a
    few not finite) at the target ESS 1,000: the same new beta, weights and
    evidence increment (rtol 1e-10); then systematic resampling from the
    JAX key's float64 uniform: the same indices."""
    rng = np.random.default_rng(8)
    ll = rng.normal(-40.0, 15.0, 2000)
    ll[[3, 70]] = -np.inf
    jbeta, jw, jinc = jsmc._beta_stage(jnp.asarray(ll), 0.05, 1000)
    tbeta, tw, tinc = tsmc._beta_stage(torch.as_tensor(ll),
                                       torch.tensor(0.05, dtype=torch.float64),
                                       1000)
    for got, want in ((tbeta, jbeta), (tw, jw), (tinc, jinc)):
        _close(got.numpy(), want)
    key = jax.random.PRNGKey(9)
    jidx = jsmc._systematic_indices(key, jw)
    u = jax.random.uniform(key, (), jnp.float64)
    tidx = tsmc._systematic_indices(torch.tensor(float(u)), tw)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


# -- (h) GARCH11 -------------------------------------------------------------
N_GARCH = 2000
GARCH_PARAMS = dict(omega=0.02, alpha_1=0.15, beta_1=0.8, initial_vol=0.3)


def _garch_model(pm, n=N_GARCH):
    """A free series of ``n`` steps under ``GARCH11`` with free omega,
    alpha_1 and beta_1."""
    with pm.Model() as model:
        omega = pm.HalfNormal("omega", sigma=0.1)
        alpha = pm.Uniform("alpha_1", 0.0, 0.5)
        beta = pm.Uniform("beta_1", 0.0, 0.95)
        pm.GARCH11("x", omega=omega, alpha_1=alpha, beta_1=beta,
                   initial_vol=0.3, shape=n)
    return model


@pytest.mark.parametrize("block", [16, 64])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_garch11_blocked_against_scan(dtype, block, monkeypatch):
    """The blocked recursion against the JAX package's ``lax.scan`` at
    n = 2000, at block length 16 (four levels) and 64 (three): the logp of
    one series, then logp and gradient of a (8, n + 3) chain batch through
    ``logp_dlogp_function``. float64: rtol 1e-10; float32 (both packages at
    float32): rtol 1e-4, atol 1e-4 x the largest."""
    jax.config.update("jax_enable_x64", dtype == "float64")
    pj.set_config(floatX=dtype)
    pt.set_config(floatX=dtype)
    monkeypatch.setattr(tts, "GARCH_BLOCK", block)
    rtol = RTOL if dtype == "float64" else 1e-4
    x = (np.random.default_rng(10).normal(size=N_GARCH) * 0.2).astype(dtype)
    want = np.asarray(pj.GARCH11.dist(**GARCH_PARAMS, shape=N_GARCH).logp(
        jnp.asarray(x)))
    got = pt.GARCH11.dist(**GARCH_PARAMS, shape=N_GARCH).logp(
        torch.as_tensor(x)).numpy()
    assert got.dtype == want.dtype == np.dtype(dtype)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))
    mj, mt = _garch_model(pj), _garch_model(pt)
    rng = np.random.RandomState(11)
    q0 = mt.dict_to_array(mt.test_point)
    q = (q0[None] + np.concatenate(
        [rng.uniform(-0.3, 0.3, (8, 3)),
         rng.normal(0.0, 0.2, (8, N_GARCH))], 1)).astype(dtype)
    vag = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))
    lj, gj = (np.asarray(a) for a in vag(jnp.asarray(q)))
    lt, gt = (a.numpy() for a in mt.logp_dlogp_function()(torch.as_tensor(q)))
    assert lt.dtype == gt.dtype == np.dtype(dtype)
    np.testing.assert_allclose(lt, lj, rtol=rtol)
    np.testing.assert_allclose(gt, gj, rtol=rtol,
                               atol=rtol * float(np.abs(gj).max()))


def test_garch11_holds_no_series_square():
    """logp and gradient of one series at n = 2000 save no tensor for the
    backward of more than n x GARCH_BLOCK elements: the whole series'
    Toeplitz product saved n^2 = 4,000,000."""
    sizes = []

    def pack(t):
        sizes.append(t.numel())
        return t

    def param(v):
        return torch.tensor(v, dtype=torch.float64, requires_grad=True)

    params = {k: param(v) for k, v in GARCH_PARAMS.items()}
    x = torch.as_tensor(np.random.default_rng(12).normal(size=N_GARCH) * 0.2,
                        dtype=torch.float64).requires_grad_()
    dist = pt.GARCH11.dist(**GARCH_PARAMS, shape=N_GARCH)
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        vol = dist._vol(x, *params.values())
    vol.sum().backward()
    assert all(torch.isfinite(p.grad) for p in params.values())
    assert torch.isfinite(x.grad).all()
    assert max(sizes) <= N_GARCH * tts.GARCH_BLOCK, max(sizes)


# -- the environment and the kernels' dtype checks ---------------------------
def _run(code, **env):
    """``code`` in a fresh interpreter at the repository root, with ``env``
    added to the environment and no ``PYMC3_TPU_*`` switch inherited."""
    base = {k: v for k, v in os.environ.items()
            if not k.startswith("PYMC3_TPU_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env=dict(base, **env), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_floatx_from_the_environment():
    """``PYMC3_TPU_FLOATX=float64`` gives float64 and int64 with no
    ``set_config``, a float64 model, and no JAX or JAX-package import."""
    code = ("import sys; import pymc3_tpu_torch as pt; "
            "c = pt.get_config(); pt.set_config(device='cpu'); "
            "m = pt.Model(); m.__enter__(); pt.Normal('a', 0.0, 1.0); "
            "print(c.floatX, c.intX, m.dict_to_array(m.test_point).dtype, "
            "any(k == 'jax' or k.startswith(('jax.', 'pymc3_tpu.')) "
            "or k == 'pymc3_tpu' for k in sys.modules))")
    assert _run(code, PYMC3_TPU_FLOATX="float64") == [
        "float64", "int64", "float64", "False"]


#: ``sample()``'s NUTS step size before and after a short run on a
#: posterior of sd 0.01, which wants a far smaller step than the initial
#: 0.25 d^-1/4; run here and in a fresh process that imports only the port
_PROBE = """
import pymc3_tpu_torch as pm
with pm.Model(device="cpu"):
    pm.Normal("a", 0.0, 0.01, shape=3)
    step = pm.NUTS()
    s0 = step.step_size
    pm.sample(draws=1, tune=1, chains=2, step=step, progressbar=False,
              random_seed=1, compute_convergence_checks=False)
print(repr(s0), repr(step.step_size))
"""


def test_no_eps_probe_from_the_environment(capsys):
    """``PYMC3_TPU_NO_EPS_PROBE=1`` leaves ``sample()``'s step size at its
    initial value (in a fresh process); without it the probe moves it."""
    s0, s1 = _run(_PROBE, PYMC3_TPU_NO_EPS_PROBE="1")
    assert s0 == s1
    exec(_PROBE, {})
    s0, s1 = capsys.readouterr().out.split()
    assert float(s1) < float(s0)


class _FakeCuda:
    """What ``_checked`` reads of a CUDA tensor, without a card."""

    def __init__(self, shape, dtype):
        self.shape, self.dtype = shape, dtype
        self.is_cuda, self.device = True, torch.device("cuda", 0)

    def is_contiguous(self):
        return True


def test_kernel_checks_take_float64(monkeypatch):
    """``ops/gp_cov._checked`` takes float32 and float64 (both inputs alike)
    and refuses float16, bfloat16 and a mix before any launch."""
    monkeypatch.setattr(gp_cov, "_libs", {torch.float32: object()})
    for dtype in (torch.float32, torch.float64):
        B, n, m, d, _, _ = gp_cov._checked(
            "matern52", _FakeCuda((2, 5, 3), dtype),
            _FakeCuda((2, 7, 3), dtype))
        assert (B, n, m, d) == (2, 5, 7, 3)
    for a, b in ((torch.float16, torch.float16),
                 (torch.bfloat16, torch.bfloat16),
                 (torch.float32, torch.float64),
                 (torch.float64, torch.float32)):
        with pytest.raises(TypeError, match="float32 or float64"):
            gp_cov._checked("expquad", _FakeCuda((1, 4, 2), a),
                            _FakeCuda((1, 4, 2), b))
