"""Five call forms where the port raised or answered otherwise than the JAX
package, each run on both packages from the same seeded numpy inputs.

- ``Minibatch`` with a per-axis ``batch_size`` (a list or tuple): the JAX
  package keeps it, samples rows i.i.d. and takes ``batch_size[0]`` rows of
  axis 0. Compared: the test value, the rows one replayed draw selects, and
  one ADVI step (the objective and the new parameters, to rtol and atol
  1e-4 as ``tests/test_torch_variational.py``) on a model observed through
  it.
- ``pm.math.cholesky`` of a matrix that is not positive definite: NaN on
  the factor's triangle, batch entry by batch entry, as
  ``jax.scipy.linalg.cholesky``; a model that factors a covariance built
  from its parameters then samples, the NaN region counted as divergences.
- ``pm.math.outer`` / ``flat_outer`` of operands that are not 1-D: both
  flattened first, as ``jnp.outer``.
- ``pm.math.full_like`` with an array, tensor or node ``fill_value``,
  broadcast as ``jnp.full_like``.
- ``pm.math.eye``: ``floatX``'s dtype, on the model's device.

Values agree to float32 tolerance, ``TOL`` (rtol 1e-5, atol 1e-6), or to
rtol 1e-12 at float64; NaN where the JAX package has NaN.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import variational as jv
from pymc3_tpu.data import MinibatchNode as JMinibatch, RNG_ENV_KEY as JKEY
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu_torch import variational as tv
from pymc3_tpu_torch.data import MinibatchNode, RNG_ENV_KEY

from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
TOL = dict(rtol=1e-5, atol=1e-6)
VI_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture
def x32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(params=["float32", "float64"])
def floatx(request):
    prev = jax.config.jax_enable_x64, pj.get_config().floatX
    pj.set_config(floatX=request.param)
    jax.config.update("jax_enable_x64", request.param == "float64")
    pt.set_config(floatX=request.param)
    yield request.param
    pt.set_config(floatX="float32")
    pj.set_config(floatX=prev[1])
    jax.config.update("jax_enable_x64", prev[0])


def _tol(floatx):
    return TOL if floatx == "float32" else dict(rtol=1e-12, atol=1e-12)


# -- Minibatch(batch_size=[rows, ...]) ---------------------------------------
DATA = np.arange(300.0).reshape(100, 3)


@pytest.mark.parametrize("batch_size", [[10, 2], (10,), (7, 3)])
def test_per_axis_minibatch_test_value(x32, batch_size):
    jmb = JMinibatch(DATA, batch_size, random_seed=5)
    mb = MinibatchNode(DATA, batch_size, random_seed=5)
    assert mb.sampling == jmb.sampling == "random"
    assert mb.batch_size == jmb.batch_size == batch_size
    want = np.asarray(jmb._test_value)
    assert want.shape == (batch_size[0], 3)
    np.testing.assert_array_equal(mb._test_value, want)
    np.testing.assert_array_equal(DATA[mb.indices().numpy()], want)


def _replayed_rows(jmb, key):
    """The row positions the JAX package draws for ``key``."""
    return np.array(jax.random.randint(
        jax.random.fold_in(key, jmb._fold), (jmb.batch_size[0],), 0,
        jmb.data.shape[0]))


def test_per_axis_minibatch_rows_of_a_replayed_draw(x32):
    jmb = JMinibatch(DATA, [10, 2], random_seed=3)
    mb = MinibatchNode(DATA, [10, 2], random_seed=3)
    assert mb.noise_shape(4) == (4, 10)
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        r = torch.as_tensor(_replayed_rows(jmb, key))
        want = np.asarray(jmb._eval_default({JKEY: key}, {}))
        got = mb._eval_default({RNG_ENV_KEY: {mb.noise_key: r}}, {})
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(
            DATA[mb.indices(r).numpy()], np.asarray(
                jmb.data[np.asarray(jmb.indices(key))]))


def _per_axis_model(pm):
    """A normal mean observed through a per-axis minibatch, scaled to the
    data's 100 rows."""
    data = np.random.RandomState(0).randn(100, 3).astype(np.float32) + 1.0
    mb = pm.Minibatch(data, batch_size=[10, 2], random_seed=9)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 1.0, shape=3)
        sd = pm.HalfNormal("sd", 2.0)
        pm.Normal("obs", mu, sd, observed=mb, total_size=100)
    return model, mb


def test_per_axis_minibatch_one_advi_step(x32):
    """One default ``adagrad_window`` step of mean-field ADVI on the JAX
    package's random numbers replayed into the port's noise (the group's
    normals and each sample's rows)."""
    jmodel, jmb = _per_axis_model(pj)
    tmodel, _ = _per_axis_model(pt)
    ja, ta = jv.MeanField(model=jmodel), tv.MeanField(model=tmodel)
    rng = np.random.RandomState(2)
    params = {i: {k: (np.asarray(v) + 0.3 * rng.randn(*np.shape(v))).astype(
        np.float32) for k, v in p.items()} for i, p in ja.params.items()}
    ja.params = {i: {k: jnp.asarray(v) for k, v in p.items()}
                 for i, p in params.items()}
    ta.params = {i: {k: torch.as_tensor(v) for k, v in p.items()}
                 for i, p in params.items()}
    nmc = 3
    jstep, jo = jv.KL(ja)().step_function(obj_n_mc=nmc)
    tstep, to = tv.KL(ta)().step_function(obj_n_mc=nmc)
    key = jax.random.PRNGKey(11)
    jparams, _, jloss = jax.jit(jstep)(ja.params, jo.init(ja.params), key)
    # the key splits of ``ObjectiveFunction.loss_fn`` and ``sample_q``
    k_q, k_mb = jax.random.split(key)
    groups = [torch.as_tensor(np.array(jax.random.normal(
        k, (nmc, g.ndim), jnp.float32))) for k, g in zip(
            jax.random.split(k_q, len(ja.groups)), ja.groups)]
    node = tv.opvi.minibatch_nodes(tmodel)[0]
    rows = torch.as_tensor(np.stack([_replayed_rows(jmb, k) for k in
                                     jax.random.split(k_mb, nmc)]))
    assert rows.shape == node.noise_shape(nmc)
    tparams, _, tloss = tstep(ta.params, to.init(ta.params), {
        "groups": groups, "minibatch": {node.noise_key: rows}})
    np.testing.assert_allclose(float(tloss), float(jloss), **VI_TOL)
    for i in jparams:
        for k in jparams[i]:
            np.testing.assert_allclose(tparams[i][k].detach().numpy(),
                                       np.asarray(jparams[i][k]), err_msg=k,
                                       **VI_TOL)


# -- cholesky ----------------------------------------------------------------
def _spd(rng, n=3):
    a = rng.randn(n, n)
    return a @ a.T + n * np.eye(n)


def _cholesky_inputs():
    rng = np.random.RandomState(6)
    not_pd = np.array([[1.0, 2.0, 0.0], [2.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    return {"pd": _spd(rng), "not-pd": not_pd, "negative": -np.eye(3),
            "batched": np.stack([_spd(rng), not_pd, _spd(rng), -np.eye(3)])}


@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("case", list(_cholesky_inputs()))
def test_cholesky_nan_where_the_jax_package_has_nan(floatx, case, lower):
    m = _cholesky_inputs()[case]
    want = np.asarray(pj.math.cholesky(m, lower=lower).test_value)
    got = pt.math.cholesky(m, lower=lower).test_value
    assert got.dtype == want.dtype == np.dtype(floatx)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, equal_nan=True, **_tol(floatx))


def test_cholesky_under_vmap_with_no_host_sync(monkeypatch):
    """Each batch entry of a ``torch.func.vmap`` gets its own NaN pattern,
    and the factor reads nothing back to the host."""
    m = torch.as_tensor(_cholesky_inputs()["batched"], dtype=torch.float32)
    with pt.Model():
        x = pt.Data("x", m[0].numpy())
        node = pt.math.cholesky(x)

    def no_sync(*args):
        raise AssertionError("host sync")
    monkeypatch.setattr(torch.Tensor, "item", no_sync)
    monkeypatch.setattr(torch.Tensor, "__bool__", no_sync)
    out = torch.func.vmap(lambda v: pt.node.evaluate(node, {"x": v}))(m)
    monkeypatch.undo()
    for i in range(m.shape[0]):
        want = pt.math.cholesky(m[i].numpy()).test_value
        np.testing.assert_array_equal(out[i].numpy(), want)
    assert np.isnan(out[1].numpy()).any() and np.isfinite(out[0].numpy()).all()


def _probe(pm):
    """``r ~ Normal(0, 1)``; the log-diagonal of the Cholesky factor of
    [[1, r], [r, 1]] as a potential: NaN where |r| >= 1."""
    with pm.Model() as model:
        r = pm.Normal("r", 0.0, 1.0)
        L = pm.math.cholesky(pm.math.stack([pm.math.stack([1.0, r]),
                                            pm.math.stack([r, 1.0])]))
        pm.Potential("p", pm.math.sum(pm.math.log(pm.math.extract_diag(L))))
    return model


def test_cholesky_probe_logp(x32):
    jm, tm = _probe(pj), _probe(pt)
    for r in (0.5, 0.9, -0.3):
        want = float(jm.logp({"r": np.float32(r)}))
        got = float(tm.logp({"r": np.float32(r)}))
        np.testing.assert_allclose(got, want, **TOL)
    assert np.isnan(float(jm.logp({"r": np.float32(2.0)})))
    assert np.isnan(float(tm.logp({"r": np.float32(2.0)})))


def test_cholesky_probe_samples(x32):
    """``sample(draws=20, tune=20, chains=4)`` finishes in both packages;
    no draw leaves |r| < 1, and the port counts the NaN region's steps as
    divergences, as the JAX package does."""
    diverging = {}
    for pm in (pj, pt):
        with _probe(pm):
            trace = pm.sample(draws=20, tune=20, chains=4, random_seed=1,
                              progressbar=False,
                              compute_convergence_checks=False)
        r = np.asarray(trace["r"])
        assert r.shape == (80,)
        assert np.isfinite(r).all() and np.abs(r).max() < 1.0
        diverging[pm.__name__] = int(np.sum(
            trace.get_sampler_stats("diverging")))
    assert diverging["pymc3_tpu"] > 0 and diverging["pymc3_tpu_torch"] > 0


# -- outer, flat_outer -------------------------------------------------------
OUTER_SHAPES = [((), ()), ((), (3,)), ((4,), (3,)), ((2, 2), (3,)),
                ((2, 3), (2, 2)), ((2,), (2, 1, 2))]


@pytest.mark.parametrize("fn", ["outer", "flat_outer"])
@pytest.mark.parametrize("shapes", OUTER_SHAPES,
                         ids=[f"{a}x{b}" for a, b in OUTER_SHAPES])
def test_outer_flattens_its_operands(x32, fn, shapes):
    rng = np.random.RandomState(len(shapes[0]) * 10 + len(shapes[1]))
    a, b = (rng.randn(*s) for s in shapes)
    want = np.asarray(getattr(pj.math, fn)(a, b).test_value)
    got = getattr(pt.math, fn)(a, b).test_value
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


# -- full_like ---------------------------------------------------------------
def _fills(pm, rng):
    return {"scalar": 2.5, "int": 3, "array": rng.randn(4),
            "matrix": rng.randn(3, 4), "int-array": np.arange(4),
            "tensor": torch.as_tensor(rng.randn(4).astype(np.float32)),
            "node": pm.math.constant(rng.randn(1, 4).astype(np.float32))}


@pytest.mark.parametrize("fill", ["scalar", "int", "array", "matrix",
                                  "int-array", "tensor", "node"])
@pytest.mark.parametrize("a", ["float", "int"])
def test_full_like_broadcasts_its_fill(x32, a, fill):
    """``fill_value`` of every kind, broadcast to ``a``'s shape in ``a``'s
    dtype; the JAX package gets the tensor fill as numpy."""
    base = np.random.RandomState(1).randn(3, 4) if a == "float" else \
        np.arange(12).reshape(3, 4)
    tfill = _fills(pt, np.random.RandomState(2))[fill]
    jfill = _fills(pj, np.random.RandomState(2))[fill]
    if isinstance(jfill, torch.Tensor):
        jfill = jfill.numpy()
    want = np.asarray(pj.math.full_like(base, jfill).test_value)
    got = pt.math.full_like(base, tfill).test_value
    assert got.shape == want.shape == (3, 4)
    assert got.dtype.kind == want.dtype.kind
    np.testing.assert_allclose(got, want, **TOL)


def test_full_like_dtype_and_shape_keywords(x32):
    base = np.ones((2, 3), np.float32)
    fill = np.arange(3.0)
    for kw in (dict(dtype=np.int32), dict(shape=(4, 3)),
               dict(dtype=np.float32, shape=(1, 3))):
        want = np.asarray(pj.math.full_like(base, fill, **kw).test_value)
        got = pt.math.full_like(base, fill, **kw).test_value
        assert got.shape == want.shape and got.dtype == want.dtype, kw
        np.testing.assert_array_equal(got, want)


# -- eye ---------------------------------------------------------------------
@pytest.mark.parametrize("args", [(3,), (3, 4), (4, 3, 1)])
def test_eye_in_floatx_on_the_model_device(floatx, args):
    want = np.asarray(pj.math.eye(*args))
    got = pt.math.eye(*args)
    assert str(got.dtype) == f"torch.{floatx}" and want.dtype == floatx
    np.testing.assert_array_equal(got.numpy(), want)
    with pt.Model(device="cpu"):
        assert pt.math.eye(*args).device == torch.device("cpu")


def test_eye_in_a_logp(floatx):
    """``x @ eye(3)`` inside a logp keeps ``floatX``: the logp and its
    gradient equal the JAX package's."""
    def build(pm):
        with pm.Model() as model:
            x = pm.Normal("x", 0.0, 1.0, shape=3)
            pm.Potential("p", -pm.math.sum(pm.math.sqr(
                pm.math.dot(x, 2.0 * pm.math.eye(3)))))
        return model
    q = np.array([[0.3, -0.2, 0.5]], floatx)
    jm, tm = build(pj), build(pt)
    want = jax.vmap(jax.value_and_grad(JaxVGF(jm).jax_fn))(jnp.asarray(q))
    got = tm.logp_dlogp_function()(torch.as_tensor(q))
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, floatx)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **_tol(floatx))
