"""The JAX package's call forms, run on both packages from the same numpy
inputs, made from a seed.

Each test is one call form of the JAX package that the port did not take or
answered differently: the Model's keywords, the one-point contract of
``make_logp_fn`` and ``ValueGradFunction`` (scipy's), the adaptation
keywords, the graph and ordering keywords, the numpy generators of the
host samplers, and what forward draws return.

- Deterministic results are equal to float32 tolerance, ``TOL`` (rtol
  1e-5, atol 1e-6).
- scipy's L-BFGS-B on radon, driven through ``f(q, grad_out=g)``, reaches
  the JAX package's optimum of the same function: -logp within 1e-3 (both
  optima evaluated by the JAX package), the point within 0.02 (the flat
  ridge of ``sigma_a`` against the county offsets, as ``chip_smoke.py``'s
  phase 19 says).
- Draws are held to their types and dtypes (numpy, the same dtype) and to
  their moments: the two packages' sample means (where the variance is
  finite) and medians within ``Z`` = 5 standard errors of their difference
  (a median's from the order statistics sqrt(n)/2 ranks either side).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import blocking as jblocking, jaxf, node as jnode
from pymc3_tpu.distributions import dist_math as jdm
from pymc3_tpu.step_methods.hmc import nuts as jnuts
from pymc3_tpu.step_methods.hmc import quadpotential as jqp
from pymc3_tpu.step_methods import step_sizes as jss
from pymc3_tpu_torch import blocking as tblocking, convert, torchf
from pymc3_tpu_torch import node as tnode
from pymc3_tpu_torch.distributions import dist_math as tdm
from pymc3_tpu_torch.examples.radon import build_model as radon_model
from pymc3_tpu_torch.examples.suite import lbfgs_through_grad_out
from pymc3_tpu_torch.step_methods.hmc import nuts as tnuts
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tqp
from pymc3_tpu_torch.step_methods import step_sizes as tss

from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .test_torch_random import CELLS

TOL = dict(rtol=1e-5, atol=1e-6)
Z = 5.0
N_DRAWS = 20000
Y = np.array([0.3, -0.5, 1.1], np.float32)


def _small(pm, check_bounds=True):
    """``mu ~ Normal``, ``s ~ HalfNormal``, three observations."""
    with pm.Model(check_bounds=check_bounds) as model:
        mu = pm.Normal("mu", 0.0, 1.0)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", mu, s, observed=Y)
    return model


def _point(model, seed=0, scale=0.3):
    q = model.dict_to_array(model.test_point)
    rng = np.random.RandomState(seed)
    return (q + scale * rng.randn(q.size)).astype(np.float32)


def _se_median(x):
    """The standard error of the sample median, from the order statistics
    sqrt(n)/2 ranks either side of it."""
    x = np.sort(x)
    n = x.size
    k = int(np.ceil(np.sqrt(n) / 2))
    return (x[n // 2 + k] - x[n // 2 - k]) / 2


def _same_moments(got, want, mean=True):
    """Two samples' medians, and their means where ``mean``, within ``Z``
    standard errors of their difference, element by element."""
    got = np.asarray(got, np.float64).reshape(got.shape[0], -1)
    want = np.asarray(want, np.float64).reshape(want.shape[0], -1)
    for j in range(got.shape[1]):
        a, b = got[:, j], want[:, j]
        se = np.hypot(_se_median(a), _se_median(b))
        assert abs(np.median(a) - np.median(b)) <= Z * se + 1e-12, \
            (j, "median")
        if mean:
            se = np.sqrt(a.var() / a.size + b.var() / b.size)
            assert abs(a.mean() - b.mean()) <= Z * se + 1e-12, (j, "mean")


# -- the Model's keywords -----------------------------------------------------
@pytest.mark.parametrize("value", [True, False])
def test_model_stores_check_bounds(value):
    jm, tm = _small(pj, value), _small(pt, value)
    assert tm.check_bounds is jm.check_bounds is value


def test_check_test_point_rounds_to_round_vals():
    jm, tm = _small(pj), _small(pt)
    for round_vals in (4, 2):
        want = jm.check_test_point(round_vals=round_vals)
        got = tm.check_test_point(round_vals=round_vals)
        assert type(got) is type(want) and got.name == want.name
        assert list(got.index) == list(want.index)
        np.testing.assert_allclose(got.values, want.values, **TOL)
        np.testing.assert_array_equal(got.values,
                                      np.round(got.values, round_vals))


def test_makefn_profile_and_flatten_take_their_keywords():
    jm, tm = _small(pj), _small(pt)
    point = {"mu": np.float32(0.4), "s_log__": np.float32(-0.2)}
    want = jm.makefn([jm["mu"], jm["s"]], point_fn=True)(point)
    got = tm.makefn([tm["mu"], tm["s"]], point_fn=True)(point)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)
    assert set(tm.profile(tm["s"], n=3, profile=True)) == \
        set(jm.profile(jm["s"], n=3, profile=True))
    jflat, tflat = jm.flatten(inputvar=None), tm.flatten(inputvar=None)
    np.testing.assert_allclose(tflat.input, jflat.input, **TOL)


# -- the one-point contract ---------------------------------------------------
@pytest.mark.parametrize("jacobian", [True, False])
def test_make_logp_fn_at_one_point(jacobian):
    jm, tm = _small(pj), _small(pt)
    q = _point(jm)
    want = jm.make_logp_fn(jacobian=jacobian, with_rng=False)(jnp.asarray(q))
    got = tm.make_logp_fn(jacobian=jacobian, with_rng=False)(q)
    assert isinstance(got, torch.Tensor) and got.dim() == 0
    np.testing.assert_allclose(float(got), float(want), **TOL)
    want = jm.make_logp_fn(jacobian=jacobian, with_rng=True)(
        jnp.asarray(q), jax.random.PRNGKey(0))
    got = tm.make_logp_fn(jacobian=jacobian, with_rng=True)(q, {})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _minibatch_logistic(pm, N=300, d=4, batch=40):
    rng = np.random.RandomState(0)
    X = rng.randn(N, d).astype(np.float32)
    y = (rng.uniform(size=N) < 0.5).astype(np.float32)
    X_mb, y_mb = pm.Minibatch(X, batch), pm.Minibatch(y, batch)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 1.0, shape=d)
        p = pm.math.invlogit(pm.math.dot(X_mb, w))
        pm.Bernoulli("obs", p=p, observed=y_mb, total_size=N)
    return model, X_mb


def test_make_logp_fn_with_rng_reads_the_minibatch_draw():
    """The draw stands where the JAX package's key stands: the window
    offset the key selects (``MinibatchNode._eval_default``) is the
    port's draw."""
    from pymc3_tpu_torch.variational.opvi import minibatch_nodes
    (jm, jmb), (tm, _) = _minibatch_logistic(pj), _minibatch_logistic(pt)
    q = _point(jm, seed=1)
    node = minibatch_nodes(tm)[0]
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        r = int(jax.random.randint(jax.random.fold_in(key, jmb._fold), (),
                                   0, jmb.data.shape[0]))
        want = jm.make_logp_fn(with_rng=True)(jnp.asarray(q), key)
        got = tm.make_logp_fn(with_rng=True)(
            q, {node.noise_key: torch.tensor(r)})
        np.testing.assert_allclose(float(got), float(want), **TOL)


@pytest.mark.parametrize("dtype", [None, "float32"])
def test_value_grad_function_at_one_point(dtype):
    """``f(q)`` gives ``(float, numpy array)``; ``f(q, grad_out=g)`` fills
    ``g`` and gives the float (scipy's contract)."""
    jm, tm = _small(pj), _small(pt)
    jf = jm.logp_dlogp_function(dtype=dtype, extra_vars=[])
    tf = tm.logp_dlogp_function(dtype=dtype, extra_vars=[])
    assert tf.dtype == jf.dtype
    assert tf.dict_to_array(tm.test_point).dtype == \
        jf.dict_to_array(jm.test_point).dtype
    for seed in range(3):
        q = _point(jm, seed)
        jl, jg = jf(q)
        tl, tg = tf(q)
        assert isinstance(tl, float) and isinstance(tg, np.ndarray)
        assert tg.dtype == np.asarray(jg).dtype
        np.testing.assert_allclose(tl, jl, **TOL)
        np.testing.assert_allclose(tg, np.asarray(jg), **TOL)
        g = np.zeros(tf.size, np.float32)
        out = tf(q, grad_out=g)
        assert isinstance(out, float) and out == tl
        np.testing.assert_array_equal(g, tg)
        # a tensor point answers the same; a batch keeps its tensors
        assert tf(torch.from_numpy(q))[0] == tl
        bl, bg = tf(torch.from_numpy(q)[None])
        assert float(bl[0]) == tl and np.array_equal(bg[0].numpy(), tg)


def test_lbfgs_through_grad_out_reaches_the_jax_optimum():
    jm, tm = radon_model(pj), radon_model(pt)
    jf, tf = jm.logp_dlogp_function(), tm.logp_dlogp_function()
    q0 = tf.dict_to_array(tm.test_point)
    want = lbfgs_through_grad_out(jf, q0)
    got = lbfgs_through_grad_out(tf, q0)
    assert got.success and want.success
    at = {k: -jf(np.asarray(r.x, np.float32))[0]
          for k, r in (("got", got), ("want", want))}
    assert abs(at["got"] - at["want"]) < 1e-3, at
    assert np.abs(got.x - want.x).max() < 0.02


# -- adaptation keywords ------------------------------------------------------
def test_da_init_takes_target():
    want = jss.da_init(0.35, target=0.8)
    got = tss.da_init(0.35, target=0.8)
    for field in jss.DAState._fields:
        np.testing.assert_allclose(np.asarray(getattr(got, field)),
                                   np.asarray(getattr(want, field)), **TOL,
                                   err_msg=field)


def _gaussian(pm, sd):
    with pm.Model() as model:
        pm.Normal("x", 0.0, sd, shape=np.shape(sd) or None)
    return model


def test_find_reasonable_eps_takes_q0_batch_and_seed():
    """The probe's eps is a power of two of the initial step; its momenta
    differ (a JAX key against a torch generator), so the two packages land
    within one doubling of each other, and both track the target's
    width."""
    found = {}
    for sd in (0.01, 1.0):
        q0 = np.zeros((64, 4), np.float32)
        sds = np.full(4, sd, np.float32)
        jstep = pj.NUTS(model=_gaussian(pj, sds))
        tstep = pt.NUTS(model=_gaussian(pt, sds))
        want = jnuts.find_reasonable_eps(jstep, q0, seed=1)
        got = tnuts.find_reasonable_eps(tstep, q0_batch=q0, seed=1)
        assert isinstance(got, float)
        assert 0.5 <= got / want <= 2.0, (got, want)
        found[sd] = got
    assert 20 < found[1.0] / found[0.01] < 500
    with pytest.raises(TypeError):
        tnuts.find_reasonable_eps(tstep, q0)


def _vmapped(update, **kw):
    return jax.jit(jax.vmap(lambda s, x: update(s, x, True, **kw),
                            axis_name="chains_local"))


def test_adapt_updates_take_axis_name():
    """A name pools over the chains, as the JAX package's psum over the
    vmapped axis; both packages from the same draws."""
    rng = np.random.RandomState(1)
    C, n = 256, 3
    mean0 = rng.randn(n).astype(np.float32)
    jdiag = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape),
        jqp.diag_adapt_init(jnp.asarray(mean0), jnp.ones(n), 10.0))
    tdiag = convert.diag_adapt_state(jax.tree_util.tree_map(np.asarray,
                                                            jdiag))
    jdense = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape),
        jqp.dense_adapt_init(mean0, adaptation_window=5))
    tdense = tqp.dense_adapt_init(torch.from_numpy(mean0), torch.eye(n), 1.0,
                                  C, adaptation_window=5)
    jd = _vmapped(jqp.diag_adapt_update, adaptation_window=5,
                  axis_name="chains_local")
    jD = _vmapped(jqp.dense_adapt_update, axis_name="chains_local")
    for _ in range(12):
        x = (rng.randn(C, n) * [1.0, 2.0, 0.5]).astype(np.float32)
        jdiag, jdense = jd(jdiag, jnp.asarray(x)), jD(jdense, jnp.asarray(x))
        tdiag = tqp.diag_adapt_update(tdiag, torch.from_numpy(x), True,
                                      adaptation_window=5,
                                      axis_name="chains_local")
        tdense = tqp.dense_adapt_update(tdense, torch.from_numpy(x), True,
                                        axis_name="chains_local")
    np.testing.assert_allclose(tdiag.var.numpy(), np.asarray(jdiag.var),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tdense.cov[0].numpy(),
                               np.asarray(jdense.cov[0]), rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError):
        tqp.diag_adapt_update(tdiag, torch.from_numpy(x), True,
                              axis_name="chains_local", pooled=False)


def test_sharded_step_function_takes_axis_name():
    """One step of each package's ``sharded_step_function(mesh, ...,
    axis_name=...)`` over a mesh of one device, from the same parameters
    and the noise of the same key; another axis name raises."""
    from pymc3_tpu.parallel import make_mesh
    from pymc3_tpu_torch.parallel import ChainMesh
    from .test_torch_variational import _assert_tree_close, _jax_noise
    ja = pj.variational.MeanField(model=_small(pj))
    ta = pt.variational.MeanField(model=_small(pt))
    ta.params = {i: {k: torch.as_tensor(np.asarray(v)) for k, v in p.items()}
                 for i, p in ja.params.items()}
    jmesh, tmesh = make_mesh(jax.devices()[:1]), ChainMesh()
    jstep, jopt = pj.variational.operators.KL(ja)().sharded_step_function(
        jmesh, obj_n_mc=2, axis_name=jmesh.axis_names[0])
    tstep, topt = pt.variational.operators.KL(ta)().sharded_step_function(
        tmesh, obj_n_mc=2, axis_name=tmesh.axis_names[0])
    keys = jax.random.split(jax.random.PRNGKey(5), 1)
    jparams, _, jl = jstep(ja.params, jopt.init(ja.params), keys)
    tparams, _, tl = tstep(ta.params, topt.init(ta.params),
                           _jax_noise(ja, ta.model, keys[0], 2))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5, atol=1e-5)
    _assert_tree_close(tparams, jparams, rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        pt.variational.operators.KL(ta)().sharded_step_function(
            tmesh, axis_name="not_an_axis")


# -- graph and ordering keywords ----------------------------------------------
def test_list_array_ordering_stores_intype():
    arrays = [np.zeros((2, 3)), np.ones(4, np.int32)]
    want = jblocking.ListArrayOrdering(arrays, intype="tensor")
    got = tblocking.ListArrayOrdering(arrays, intype="tensor")
    assert got.intype == want.intype == "tensor"
    assert [(v.slc, v.shp, v.dtyp) for v in got.vmap] == \
        [(v.slc, v.shp, v.dtyp) for v in want.vmap]


def test_broadcastable_is_accepted():
    bc = (False, True)
    assert pt.distributions.TensorType("float32", (3, 1), broadcastable=bc) \
        == pj.distributions.TensorType("float32", (3, 1), broadcastable=bc)
    x = np.array([-1.0, 0.5], np.float32)
    jd = pj.Normal.dist(mu=0.5, sigma=2.0, broadcastable=bc)
    td = pt.Normal.dist(mu=0.5, sigma=2.0, broadcastable=bc)
    np.testing.assert_allclose(td.logp(torch.from_numpy(x)).numpy(),
                               np.asarray(jd.logp(jnp.asarray(x))), **TOL)


def test_opnode_uses_the_given_test_value():
    """A given test value is used, not computed: the function is never
    called on the operands' test values."""
    calls = []

    def fn(x):
        calls.append(x)
        return x * 2.0

    given = np.array([7.0, 8.0], np.float32)
    for pm, node_mod in ((pj, jnode), (pt, tnode)):
        with pm.Model():
            v = pm.Normal("v", 0.0, 1.0, shape=2)
        node = node_mod.OpNode(fn, [v], test_value=given)
        np.testing.assert_array_equal(node.test_value, given)
    assert calls == []


def test_join_nonshared_inputs_takes_make_shared():
    outs = []
    for pm, f, node_mod in ((pj, jaxf, jnode), (pt, torchf, tnode)):
        with pm.Model():
            a = pm.Normal("a", 0.0, 1.0, shape=2)
            b = pm.Normal("b", 0.0, 1.0)
        (out,), joined = f.join_nonshared_inputs(
            [pm.math.sum(a) * b], [a, b], {}, make_shared=True)
        flat = np.array([0.5, -1.0, 2.0], np.float32)
        outs.append((np.asarray(joined.test_value),
                     float(np.asarray(node_mod.evaluate(
                         out, {"__joined__": flat if pm is pj
                               else torch.from_numpy(flat)}, {})))))
    np.testing.assert_allclose(outs[1][0], outs[0][0], **TOL)
    np.testing.assert_allclose(outs[1][1], outs[0][1], **TOL)


# -- numpy generators of the host samplers ------------------------------------
@pytest.mark.parametrize("rng", ["RandomState", "Generator"])
def test_random_choice_and_clipped_beta_take_rng(rng):
    make = {"RandomState": np.random.RandomState,
            "Generator": np.random.default_rng}[rng]
    p = np.array([0.2, 0.5, 0.3])
    want = jdm.random_choice(p, N_DRAWS, rng=make(0))
    got = tdm.random_choice(p, N_DRAWS, rng=make(0))
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    assert got.shape == want.shape
    _same_moments(got[:, None], want[:, None])
    rows = np.array([[0.9, 0.1, 0.0], [0.0, 0.1, 0.9]])
    assert tdm.random_choice(rows, rng=make(1)).shape == \
        jdm.random_choice(rows, rng=make(1)).shape
    want = jdm.clipped_beta_rvs(2.0, 3.0, size=N_DRAWS, rng=make(2))
    got = tdm.clipped_beta_rvs(2.0, 3.0, size=N_DRAWS, rng=make(2))
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype
    _same_moments(got[:, None], want[:, None])
    with pytest.raises(ValueError):
        tdm.random_choice(p, 3, rng=make(0), gen=torch.Generator())


# -- what forward draws return ------------------------------------------------
_TRI_X = np.linspace(0.0, 3.0, 61)
#: every family of ``tests/test_torch_random.py``'s list, built alike in
#: both packages
FAMILIES = {
    "uniform": lambda pm: pm.Uniform.dist(lower=-1.0, upper=2.0),
    "normal": lambda pm: pm.Normal.dist(mu=1.0, sigma=2.0),
    "truncnormal": lambda pm: pm.TruncatedNormal.dist(
        mu=0.5, sigma=1.5, lower=-1.0, upper=2.0),
    "truncnormal-tail": lambda pm: pm.TruncatedNormal.dist(
        mu=0.0, sigma=1.0, lower=2.5),
    "halfnormal": lambda pm: pm.HalfNormal.dist(sigma=2.0),
    "wald": lambda pm: pm.Wald.dist(mu=1.5, lam=2.0),
    "beta": lambda pm: pm.Beta.dist(alpha=2.0, beta=3.0),
    "beta-small": lambda pm: pm.Beta.dist(alpha=0.5, beta=0.5),
    "kumaraswamy": lambda pm: pm.Kumaraswamy.dist(a=2.0, b=5.0),
    "exponential": lambda pm: pm.Exponential.dist(lam=2.0),
    "laplace": lambda pm: pm.Laplace.dist(mu=1.0, b=2.0),
    "lognormal": lambda pm: pm.Lognormal.dist(mu=0.3, sigma=0.6),
    "studentt": lambda pm: pm.StudentT.dist(nu=3.0, mu=1.0, sigma=2.0),
    "studentt-lam": lambda pm: pm.StudentT.dist(nu=8.0, mu=-1.0, lam=0.25),
    "pareto": lambda pm: pm.Pareto.dist(alpha=5.0, m=2.0),
    "cauchy": lambda pm: pm.Cauchy.dist(alpha=1.0, beta=2.0),
    "halfcauchy": lambda pm: pm.HalfCauchy.dist(beta=2.0),
    "gamma": lambda pm: pm.Gamma.dist(alpha=2.5, beta=1.5),
    "gamma-small": lambda pm: pm.Gamma.dist(alpha=0.3, beta=1.0),
    "inversegamma": lambda pm: pm.InverseGamma.dist(alpha=5.0, beta=2.0),
    "chisquared": lambda pm: pm.ChiSquared.dist(nu=4.0),
    "weibull": lambda pm: pm.Weibull.dist(alpha=1.5, beta=2.0),
    "halfstudentt": lambda pm: pm.HalfStudentT.dist(nu=5.0, sigma=2.0),
    "exgaussian": lambda pm: pm.ExGaussian.dist(mu=1.0, sigma=0.5, nu=2.0),
    "vonmises": lambda pm: pm.VonMises.dist(mu=0.5, kappa=2.0),
    "vonmises-flat": lambda pm: pm.VonMises.dist(mu=0.0, kappa=0.1),
    "vonmises-peaked": lambda pm: pm.VonMises.dist(mu=-2.0, kappa=50.0),
    "skewnormal": lambda pm: pm.SkewNormal.dist(mu=1.0, sigma=2.0,
                                                alpha=3.0),
    "triangular": lambda pm: pm.Triangular.dist(lower=-1.0, c=0.0,
                                                upper=3.0),
    "gumbel": lambda pm: pm.Gumbel.dist(mu=1.0, beta=2.0),
    "rice": lambda pm: pm.Rice.dist(nu=2.0, sigma=1.0),
    "logistic": lambda pm: pm.Logistic.dist(mu=1.0, s=2.0),
    "logitnormal": lambda pm: pm.LogitNormal.dist(mu=0.5, sigma=1.0),
    "interpolated": lambda pm: pm.Interpolated.dist(
        x_points=_TRI_X, pdf_points=st.triang(1 / 3, 0, 3).pdf(_TRI_X)),
    "bound-normal": lambda pm: pm.Bound(pm.Normal, lower=0.5).dist(
        mu=1.0, sigma=2.0),
    "normalmixture": lambda pm: pm.NormalMixture.dist(
        w=np.array([0.3, 0.7]), mu=np.array([-2.0, 3.0]),
        sigma=np.array([0.5, 1.0])),
}
#: heavy tails: the mean of a Cauchy does not exist
NO_MEAN = {"cauchy", "halfcauchy"}


@pytest.mark.parametrize("name", list(FAMILIES))
def test_random_returns_numpy_of_the_jax_dtype(name):
    assert list(FAMILIES) == [c[0] for c in CELLS]
    np.random.seed(0)
    want = FAMILIES[name](pj).random(size=N_DRAWS)
    got = FAMILIES[name](pt).random(size=N_DRAWS,
                                     gen=torch.Generator().manual_seed(0))
    assert isinstance(got, np.ndarray) and isinstance(want, np.ndarray)
    assert got.dtype == want.dtype and got.shape == want.shape
    _same_moments(got[:, None], want[:, None], mean=name not in NO_MEAN)
    assert np.shape(FAMILIES[name](pt).random()) == \
        np.shape(FAMILIES[name](pj).random())


@pytest.mark.parametrize("cls,params", [
    ("Poisson", dict(mu=3.5)), ("Bernoulli", dict(p=0.3)),
    ("Categorical", dict(p=np.array([0.2, 0.5, 0.3])))])
def test_integer_draws_are_int64(cls, params):
    np.random.seed(1)
    want = getattr(pj, cls).dist(**params).random(size=N_DRAWS)
    got = getattr(pt, cls).dist(**params).random(
        size=N_DRAWS, gen=torch.Generator().manual_seed(1))
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype == np.int64
    _same_moments(got[:, None], want[:, None])


def test_model_variables_random_returns_numpy():
    """A free variable and a transformed one (``model["s"]``)."""
    np.random.seed(2)
    jm, tm = _small(pj), _small(pt)
    for name in ("mu", "s"):
        want = jm[name].random(size=N_DRAWS)
        got = tm[name].random(size=N_DRAWS)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        _same_moments(got[:, None], want[:, None])
        assert tm[name].random(size=3).shape == (3,)


def test_draw_values_draws_from_a_distribution():
    np.random.seed(3)
    want = pj.distributions.draw_values([pj.Normal.dist(1.0, 2.0), 2.0],
                                        size=N_DRAWS)
    got = pt.distributions.draw_values([pt.Normal.dist(1.0, 2.0), 2.0],
                                       size=N_DRAWS)
    assert tuple(got[0].shape) == np.shape(want[0]) == (N_DRAWS,)
    assert float(got[1]) == float(want[1]) == 2.0
    _same_moments(got[0].numpy()[:, None], want[0][:, None])
    assert tuple(pt.distributions.draw_values(
        [pt.Normal.dist(0.0, 1.0), 2.0], size=3)[0].shape) == (3,)


#: ``sample_prior_predictive``'s dtypes on radon, the JAX package's; the
#: card's check (``chip_smoke.py``'s phase 30) holds the port to the same
#: table
RADON_PRIOR_DTYPES = {
    "mu_a": "float64", "sigma_a": "float64", "sigma_a_log__": "float32",
    "mu_b": "float64", "sigma_b": "float64", "sigma_b_log__": "float32",
    "a": "float64", "b": "float64", "eps": "float64", "eps_log__": "float32",
    "radon_like": "float64"}


def test_prior_predictive_dtypes_on_radon():
    np.random.seed(4)
    want = pj.sample_prior_predictive(samples=500, model=radon_model(pj),
                                      random_seed=4)
    got = pt.sample_prior_predictive(samples=500, model=radon_model(pt),
                                     random_seed=4)
    assert {k: str(v.dtype) for k, v in want.items()} == RADON_PRIOR_DTYPES
    assert {k: str(v.dtype) for k, v in got.items()} == RADON_PRIOR_DTYPES
    for name in ("mu_a", "sigma_b_log__", "eps"):
        _same_moments(got[name][:, None], want[name][:, None],
                      mean=name != "eps")
    assert got["radon_like"].shape == want["radon_like"].shape


def _mixed(pm):
    """Continuous, integer and transformed variables, and deterministics
    of each kind."""
    with pm.Model() as model:
        lam = pm.Gamma("lam", 2.0, 1.0)
        k = pm.Poisson("k", lam)
        pm.Bernoulli("z", 0.3, shape=2)
        b = pm.Beta("b", 2.0, 2.0)
        pm.Deterministic("d", lam * 2.0)
        pm.Deterministic("n", k + 1)
        pm.Poisson("y", lam, observed=np.array([1, 2, 3]))
        pm.Normal("yb", b, 1.0, observed=np.array([1.0, 2.0]))
    return model


def test_predictive_dtypes_by_kind():
    np.random.seed(5)
    jm, tm = _mixed(pj), _mixed(pt)
    want = pj.sample_prior_predictive(samples=N_DRAWS // 4, model=jm,
                                      random_seed=5)
    got = pt.sample_prior_predictive(samples=N_DRAWS // 4, model=tm,
                                     random_seed=5)
    assert {k: v.dtype for k, v in got.items()} == \
        {k: v.dtype for k, v in want.items()}
    for name in ("lam", "b", "k", "y", "yb"):
        _same_moments(got[name].reshape(got[name].shape[0], -1),
                      want[name].reshape(want[name].shape[0], -1))
    S = 2000
    rng = np.random.RandomState(6)
    lam = rng.gamma(3.0, 1.0, S)
    trace = {"lam": lam, "lam_log__": np.log(lam),
             "k": rng.poisson(2.0, S), "z": rng.randint(0, 2, (S, 2)),
             "b": np.full(S, 0.5), "b_logodds__": np.zeros(S)}
    names = ["y", "yb", "d", "n", "lam", "k"]
    want = pj.sample_posterior_predictive(trace, model=jm, var_names=names,
                                          random_seed=6, progressbar=False)
    got = pt.sample_posterior_predictive(trace, model=tm, var_names=names,
                                         random_seed=6)
    assert {k: (v.dtype, v.shape) for k, v in got.items()} == \
        {k: (v.dtype, v.shape) for k, v in want.items()}
    for name in ("y", "yb"):
        _same_moments(got[name], want[name])
    np.testing.assert_allclose(got["d"], want["d"], **TOL)
