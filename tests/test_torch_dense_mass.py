"""Dense and fixed mass matrices of the port against the JAX package.

- ``dense_adapt_update`` over 300 draws of 64 chains, per chain and pooled,
  against the JAX update under ``vmap`` and ``psum``: every field of the
  state within rtol = atol = 2e-5 (float32; the pooled merge sums 64
  chains in another order), window ends and promotions exactly;
- the host-side ``QuadPotentialFullAdapt.update`` (with its shrinkage) of
  one chain over 300 draws against the JAX class: rtol 1e-5;
- the fixed potentials' ``velocity``, ``energy`` and seeded ``random``:
  rtol 1e-5;
- one NUTS and one HamiltonianMC transition with a dense adaptive (pooled
  and per chain) and a fixed dense potential, on the JAX transition's
  replayed random numbers: the same tree depth and size (NUTS), step count
  and acceptance (HMC), and the next ``q`` within 1e-4;
- ``init_nuts`` for each newly accepted ``init``: the same start points as
  the JAX package for a seed (rtol 1e-6) and the same potential;
- a short CPU run with ``init="jitter+adapt_full"`` on a correlated normal:
  means within 4 Monte-Carlo standard errors, the draws' covariance
  within 25% of the target's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu.step_methods.hmc import quadpotential as jqp
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.step_methods.arraystep import TuneContext
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tqp

from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .test_torch_hmc import ReplayNoise

torch.set_num_threads(2)
COV = np.array([[1.0, 0.8, -0.3], [0.8, 2.0, 0.1], [-0.3, 0.1, 0.5]])
MEAN = np.array([1.0, -1.0, 0.5])


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _assert_states(t, j, rtol=2e-5):
    for name, got, want in zip(type(t)._fields, t, j):
        if isinstance(got, tuple):
            _assert_states(got, want, rtol)
            continue
        got = got.numpy()
        want = np.asarray(want)
        got = np.broadcast_to(got, want.shape) if got.ndim == want.ndim \
            else got
        np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol,
                                   err_msg=name)


@pytest.mark.parametrize("pooled", [False, True], ids=["per_chain", "pooled"])
def test_dense_adapt_update_matches_jax(pooled):
    C, n, window = 64, 3, 5
    rng = np.random.RandomState(4)
    mean0 = rng.randn(n).astype(np.float32)
    init = jqp.dense_adapt_init(mean0, adaptation_window=window)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape), init)
    tstate = tqp.dense_adapt_init(torch.from_numpy(mean0), torch.eye(n), 1.0,
                                  C, adaptation_window=window)
    _assert_states(tstate, jstate)
    axis = "chains_local" if pooled else None
    jupd = jax.jit(jax.vmap(
        lambda s, x, tune: jqp.dense_adapt_update(s, x, tune,
                                                  axis_name=axis),
        in_axes=(0, 0, None), axis_name="chains_local"))
    L = np.linalg.cholesky(COV)
    scales = rng.uniform(0.5, 2.0, C)[:, None]   # chains that disagree
    for i in range(300):
        x = (MEAN + scales * (rng.randn(C, n) @ L.T)).astype(np.float32)
        tune = i < 280
        jstate = jupd(jstate, jnp.asarray(x), tune)
        tstate = tqp.dense_adapt_update(tstate, torch.from_numpy(x), tune,
                                        pooled=pooled)
    # windows of 5, 10, 20, 40 and 80 ended at draws 5, 15, 35, 75, 155
    np.testing.assert_array_equal(tstate.prev_update.numpy(),
                                  np.asarray(jstate.prev_update))
    assert int(tstate.window[0]) == 160 and int(tstate.prev_update[0]) == 155
    assert int(tstate.n_samples[0]) == 280
    assert tstate.cov.shape[0] == (1 if pooled else C)
    _assert_states(tstate, jstate)
    # per chain each lane learns its own scale, pooled every lane the mix
    cov = tstate.cov.numpy()
    assert (np.std(cov[:, 0, 0]) > 0.1) != pooled


def test_dense_update_keeps_the_factor_where_the_estimate_is_not_pd():
    """Two identical draws leave a zero covariance estimate in a chain:
    that chain keeps its previous factor, the other takes the new one,
    without a host sync or an error."""
    n = 2
    st = tqp.dense_adapt_init(torch.zeros(n), torch.eye(n), 0.0, 2,
                              adaptation_window=100)
    for x in ([[1.0, 1.0], [0.0, 1.0]], [[1.0, 1.0], [1.0, -1.0]],
              [[1.0, 1.0], [2.0, 3.0]]):
        st = tqp.dense_adapt_update(st, torch.tensor(x), True)
    assert torch.isfinite(st.chol).all()
    np.testing.assert_array_equal(st.cov[0].numpy(), np.eye(n))
    assert not np.allclose(st.cov[1].numpy(), np.eye(n))
    np.testing.assert_allclose((st.chol[1] @ st.chol[1].T).numpy(),
                               st.cov[1].numpy(), rtol=1e-5)


def test_host_full_adapt_update_with_shrinkage_matches_jax():
    n = 3
    rng = np.random.RandomState(5)
    mean0 = rng.randn(n)
    jp = jqp.QuadPotentialFullAdapt(n, mean0, adaptation_window=10)
    tp = tqp.QuadPotentialFullAdapt(n, mean0, adaptation_window=10)
    L = np.linalg.cholesky(COV)
    for i in range(300):
        x = (MEAN + rng.randn(n) @ L.T).astype(np.float32)
        jp.update(x, None, i < 250)
        tp.update(x, None, i < 250)
        np.testing.assert_allclose(tp._cov, jp._cov, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tp._chol, jp._chol, rtol=1e-5, atol=1e-6)
    # 4 windows ended (10, 20, 40, 80 draws after the previous), each shrunk
    assert tp._previous_update == jp._previous_update == 150
    np.testing.assert_allclose(tp._cov, COV, rtol=0.5)


def test_fixed_potentials_match_jax():
    x = np.array([0.3, -1.2, 0.7], np.float32)
    for cls, arg in (("QuadPotentialDiag", np.diag(COV)),
                     ("QuadPotentialFull", COV),
                     ("QuadPotentialFullInv", COV),
                     ("quad_potential", None)):
        if arg is None:
            pots = [(getattr(jqp, cls)(a, c), getattr(tqp, cls)(a, c))
                    for a in (COV, np.diag(COV)) for c in (True, False)]
        else:
            pots = [(getattr(jqp, cls)(arg), getattr(tqp, cls)(arg))]
        for jp, tp in pots:
            assert type(tp).__name__ == type(jp).__name__
            np.testing.assert_allclose(tp.velocity(x), jp.velocity(x),
                                       rtol=1e-5, atol=1e-6)
            assert tp.energy(x) == pytest.approx(jp.energy(x), rel=1e-5)
            np.random.seed(3)
            want = jp.random()
            np.random.seed(3)
            np.testing.assert_allclose(tp.random(), want, rtol=1e-5,
                                       atol=1e-6)
            jst = jp.init_kernel_state()
            tst = tp.init_kernel_state(4, "cpu")
            np.testing.assert_allclose(
                np.broadcast_to(tqp.kernel_mass(tst).numpy()[0],
                                np.shape(jqp.kernel_mass(jst))),
                np.asarray(jqp.kernel_mass(jst)), rtol=1e-5, atol=1e-6)
    with pytest.raises(tqp.PositiveDefiniteError):
        tqp.quad_potential(np.array([1.0, -1.0]), True)


def test_mass_velocity_and_momentum_dispatch():
    rng = np.random.RandomState(6)
    C, n = 4, 3
    p = torch.from_numpy(rng.randn(C, n).astype(np.float32))
    A = torch.from_numpy(COV.astype(np.float32))
    per_chain = A[None] * torch.arange(1.0, C + 1)[:, None, None]
    np.testing.assert_allclose(tqp.mass_velocity(A[None], p).numpy(),
                               p.numpy() @ COV, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tqp.mass_velocity(per_chain, p).numpy(),
        np.einsum("cij,cj->ci", per_chain.numpy(), p.numpy()), rtol=1e-5)
    np.testing.assert_allclose(tqp.mass_velocity(A, p[0]).numpy(),
                               COV @ p[0].numpy(), rtol=1e-5, atol=1e-6)
    chol = torch.linalg.cholesky(per_chain)
    z = p
    got = tqp.kernel_momentum(tqp.DenseState(per_chain, chol), z)
    for c in range(C):
        want = np.linalg.solve(chol[c].numpy().T, z[c].numpy())
        np.testing.assert_allclose(got[c].numpy(), want, rtol=1e-5, atol=1e-5)


# -- one transition on replayed noise ---------------------------------------
def _model(pm):
    with pm.Model() as model:
        pm.MvNormal("x", mu=MEAN, cov=COV, shape=3)
        pm.Normal("s", 0.0, 2.0)
    return model


def _potential(pkg, kind, n):
    qp = jqp if pkg is pj else tqp
    if kind == "fixed":
        return qp.QuadPotentialFull(np.diag(np.arange(1.0, n + 1)) + 0.3)
    return qp.QuadPotentialFullAdapt(n, np.zeros(n), adaptation_window=3)


TRANSITION_CELLS = [("dense", False), ("dense", True), ("fixed", False)]


def _start(mt, C, seed):
    rng = np.random.RandomState(seed)
    return (mt.dict_to_array(mt.test_point)[None]
            + rng.uniform(-0.5, 0.5, (C, mt.ndim))).astype(np.float32)


@pytest.mark.parametrize("kind,pooled", TRANSITION_CELLS,
                         ids=[f"{k}-{'pooled' if p else 'per_chain'}"
                              for k, p in TRANSITION_CELLS])
def test_one_nuts_transition_on_identical_noise(kind, pooled):
    mj, mt = _model(pj), _model(pt)
    C, n, max_depth = 4, mt.ndim, 6
    axis = "chains_local" if pooled else None
    jstep = pj.NUTS(model=mj, max_treedepth=max_depth, axis_name=axis,
                    potential=_potential(pj, kind, n))
    tstep = pt.NUTS(model=mt, max_treedepth=max_depth, axis_name=axis,
                    potential=_potential(pt, kind, n))
    q0 = _start(mt, C, 7)
    jinit = jax.vmap(jstep.kernel_init)(jnp.asarray(q0))
    tinit = convert.nuts_kernel_state(_np(jinit))
    jtune = JaxTune(jnp.asarray(True), jnp.asarray(250, jnp.int32), 1000)
    keys = jax.random.split(jax.random.PRNGKey(12), 3 * C).reshape(3, C, 2)
    jstate, tstate = jinit, tinit
    jq, tq = jnp.asarray(q0), torch.from_numpy(q0)
    jkernel = jax.jit(jax.vmap(
        lambda k, q, s: jstep.kernel_step(k, q, s, jtune),
        axis_name="chains_local"))
    for ks in keys:  # three draws: the dense update promotes at draw 3
        jq, jstate, jstats = jkernel(ks, jq, jstate)
        tq, tstate, tstats = tstep.kernel_step(
            tq, tstate, TuneContext(True, 250, 1000),
            ReplayNoise(ks, n, max_depth))
        np.testing.assert_array_equal(tstats["depth"].numpy(),
                                      np.asarray(jstats["depth"]))
        np.testing.assert_array_equal(tstats["tree_size"].numpy(),
                                      np.asarray(jstats["tree_size"]))
        np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                                   atol=1e-4)
    assert isinstance(tstate.pot, tqp.DenseAdaptState if kind == "dense"
                      else tqp.DenseState)
    np.testing.assert_allclose(
        np.broadcast_to(tstate.pot.cov.numpy(), np.shape(jstate.pot.cov)),
        np.asarray(jstate.pot.cov), rtol=1e-4, atol=1e-5)
    if kind == "dense":
        assert not np.allclose(tstate.pot.cov.numpy()[0], np.eye(n))


@pytest.mark.parametrize("kind", ["dense", "fixed"])
def test_one_hmc_transition_on_identical_noise(kind):
    mj, mt = _model(pj), _model(pt)
    C, n = 5, mt.ndim
    kw = dict(path_length=0.8, max_steps=16)
    js = pj.HamiltonianMC(model=mj, potential=_potential(pj, kind, n), **kw)
    ts = pt.HamiltonianMC(model=mt, potential=_potential(pt, kind, n), **kw)
    q0 = _start(mt, C, 8)
    jinit = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    eps = np.array([0.05, 0.11, 0.2, 0.33, 0.8], np.float32)
    jinit = jinit._replace(da=jinit.da._replace(
        log_step=jnp.log(jnp.asarray(eps))))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jq, jst, jstats = jax.jit(jax.vmap(
        lambda k, q, s: js.kernel_step(
            k, q, s, JaxTune(jnp.asarray(True), jnp.asarray(3, jnp.int32),
                             100))))(keys, jnp.asarray(q0), jinit)

    class Noise:
        def normal(self, dim):
            return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
                jax.random.split(k)[0], (dim,), jnp.float32)) for k in keys]))

        def uniform(self, dim=None):
            return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                jax.random.split(k)[1], (), jnp.float32)) for k in keys]))
    tinit = convert.nuts_kernel_state(_np(jinit))
    tq, tst, tstats = ts.kernel_step(torch.from_numpy(q0), tinit,
                                     TuneContext(True, 3, 100), Noise())
    np.testing.assert_array_equal(tstats["n_steps"].numpy(),
                                  np.asarray(jstats["n_steps"]))
    np.testing.assert_array_equal(tstats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(
        np.broadcast_to(tst.pot.cov.numpy(), np.shape(jst.pot.cov)),
        np.asarray(jst.pot.cov), rtol=1e-4, atol=1e-5)


def test_nuts_and_hmc_take_a_scaling():
    mt = _model(pt)
    for cls in (pt.NUTS, pt.HamiltonianMC):
        for scaling, is_cov, kind in ((np.ones(4), True, "QuadPotentialDiag"),
                                      (np.eye(4) * 2, False,
                                       "QuadPotentialFullInv")):
            step = cls(model=mt, scaling=scaling, is_cov=is_cov)
            assert type(step.potential).__name__ == kind


# -- init_nuts -----------------------------------------------------------------
INITS = ["adapt_diag", "jitter+adapt_diag", "adapt_full",
         "jitter+adapt_full", "nuts"]


@pytest.mark.parametrize("init", INITS)
def test_init_nuts_matches_jax(init):
    mj, mt = _model(pj), _model(pt)
    js, jstep = pj.init_nuts(init=init, chains=3, model=mj, random_seed=17)
    ts, tstep = pt.init_nuts(init=init, chains=3, model=mt, random_seed=17)
    assert type(tstep.potential).__name__ == type(jstep.potential).__name__
    assert len(ts) == len(js) == 3
    for a, b in zip(ts, js):
        for k in b:
            np.testing.assert_allclose(np.asarray(a[k]), np.asarray(b[k]),
                                       rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tstep.potential._initial_mean,
                               jstep.potential._initial_mean, rtol=1e-6,
                               atol=1e-7)


def test_init_nuts_refuses_the_vi_strategies_by_name():
    """The VI strategies, refused until the port had VI, now give their
    potentials; a strategy the JAX package does not know is refused by
    name."""
    from pymc3_tpu_torch.step_methods.hmc import quadpotential as tq
    mt = _model(pt)
    for init, kind in (("advi", tq.QuadPotentialDiag),
                       ("advi+adapt_diag", tq.QuadPotentialDiagAdapt),
                       ("advi_map", tq.QuadPotentialDiag),
                       ("map", tq.QuadPotentialFull)):
        _, step = pt.init_nuts(init=init, chains=2, model=mt, n_init=300,
                               random_seed=1, progressbar=False)
        assert type(step.potential) is kind, init
    with pytest.raises(ValueError, match="Unknown initializer"):
        pt.init_nuts(init="bogus", chains=2, model=mt)


def test_adapt_full_sample_learns_the_covariance():
    with pt.Model() as model:
        pt.MvNormal("x", mu=MEAN, cov=COV * 4.0, shape=3)
    tr = pt.sample(draws=200, tune=200, chains=16, model=model,
                   init="jitter+adapt_full", random_seed=3,
                   progressbar=False, compute_convergence_checks=False)
    x = tr["x"].astype(np.float64)
    ess = np.asarray(pt.ess(tr, var_names=["x"])["x"])
    z = np.abs(x.mean(0) - MEAN) / (x.std(0) / np.sqrt(ess))
    assert np.all(z < 4), z
    np.testing.assert_allclose(np.cov(x.T), COV * 4.0, rtol=0.25, atol=0.3)
    assert float(np.max(pt.rhat(tr, var_names=["x"])["x"])) < 1.05
