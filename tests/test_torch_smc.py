"""The port's SMC against the JAX package's: the stage functions on the
same inputs, one mutation step on replayed random numbers, the models'
prior and likelihood terms, and ``sample_smc`` end to end on the models of
``tests/test_smc.py`` by Monte-Carlo error.

Tolerances:
- ``_beta_stage``: new β within 1e-6, weights rtol 2e-6 (atol 1e-12 for
  the weights that underflow), evidence increment within 1e-5: the same
  float32 formulas, but torch's and XLA's logsumexp over 512 terms differ
  by an ulp, which exp(lw - lse) at lw - lse near -8 turns into up to
  1.15e-6 relative (measured);
- systematic indices: identical on weights whose cumulative sums sit away
  from the positions (u + i) / N; on random weights every particle's count
  within 1 (a float32 cumsum may round across a position);
- ``_particle_cov_chol``: rtol 1e-5, atol 1e-5 x the largest entry;
- one mutation step: the same accept decisions, q and logps rtol 1e-5,
  atol 1e-5 (the proposal is ``chol @ z`` in both, reduced in another
  order);
- prior and likelihood terms: rtol 1e-5, atol 1e-5.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.node import apply as japply
from pymc3_tpu.smc import smc as jsmc
from pymc3_tpu_torch.examples.suite import abc_data
from pymc3_tpu_torch.smc import smc as tsmc
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# ---------------------------------------------------------------------------
# the models of tests/test_smc.py, in either package
# ---------------------------------------------------------------------------

N_DIM = 4
MU1 = np.ones(N_DIM) * 0.5
STDEV = 0.1
SIGMA = STDEV ** 2 * np.eye(N_DIM)
ISIGMA = np.linalg.inv(SIGMA)
DSIGMA = np.linalg.det(SIGMA)
W1 = STDEV


def _two_gaussians(xp):
    isig = xp.asarray(ISIGMA.astype(np.float32)) if xp is jnp else \
        torch.tensor(ISIGMA, dtype=torch.float32)
    mu1 = xp.asarray(MU1.astype(np.float32)) if xp is jnp else \
        torch.tensor(MU1, dtype=torch.float32)
    logaddexp = jnp.logaddexp if xp is jnp else torch.logaddexp

    def logp(x):
        c = -0.5 * N_DIM * np.log(2 * np.pi) - 0.5 * np.log(DSIGMA)
        l1 = c - 0.5 * (x - mu1) @ isig @ (x - mu1)
        l2 = c - 0.5 * (x + mu1) @ isig @ (x + mu1)
        return logaddexp(np.log(W1) + l1, np.log(1 - W1) + l2)
    return logp


def bimodal(pm):
    apply = japply if pm is pj else pt.node.apply
    with pm.Model() as model:
        X = pm.Uniform("X", lower=-2, upper=2, shape=N_DIM)
        pm.Potential("muh", apply(_two_gaussians(
            jnp if pm is pj else torch), X))
    return model


BB_DATA = np.repeat([1, 0], [50, 50]).astype(np.int32)


def beta_binomial(pm):
    with pm.Model() as model:
        a = pm.Beta("a", 1.0, 1.0)
        pm.Bernoulli("y", a, observed=BB_DATA)
    return model


def abc(pm, simulator=None):
    if simulator is None:
        zeros = jnp.zeros if pm is pj else torch.zeros

        def simulator(a, b):
            return a + b * zeros(200)
    with pm.Model() as model:
        a = pm.Normal("a", mu=0, sigma=5)
        b = pm.HalfNormal("b", sigma=2)
        pm.Simulator("s", simulator, a, b, observed=abc_data())
    return model


def hierarchical(pm):
    """A model with a transformed prior that depends on another variable,
    so both terms carry jacobians and parents."""
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 2.0)
        sd = pm.HalfNormal("sd", 1.5)
        x = pm.Normal("x", mu=mu, sigma=sd, shape=3)
        pm.Normal("y", mu=x, sigma=0.5,
                  observed=np.array([0.3, -1.2, 2.1], np.float32))
    return model


MODELS = {"bimodal": bimodal, "beta_binomial": beta_binomial, "abc": abc,
          "hierarchical": hierarchical}


# ---------------------------------------------------------------------------
# stage functions
# ---------------------------------------------------------------------------

def _loglikes():
    rng = np.random.RandomState(0)
    bimodal_ll = np.where(rng.rand(512) < 0.3, -2.0, -40.0) \
        + rng.randn(512)
    flat = np.full(512, -3.0)
    infs = -np.abs(rng.randn(512)) * 20.0
    infs[::37] = -np.inf
    infs[5] = np.inf
    infs[11] = np.nan
    return {"bimodal": bimodal_ll, "flat": flat, "inf": infs,
            "steep": -np.abs(rng.randn(512)) * 500.0}


@pytest.mark.parametrize("old_beta", [0.0, 0.3, 0.999])
@pytest.mark.parametrize("name", ["bimodal", "flat", "inf", "steep"])
def test_beta_stage_matches_jax(name, old_beta):
    ll = _loglikes()[name].astype(np.float32)
    bj, wj, lj = jsmc._beta_stage(jnp.asarray(ll),
                                  jnp.asarray(old_beta, jnp.float32),
                                  jnp.asarray(256, jnp.int32))
    bt, wt, lt = tsmc._beta_stage(torch.from_numpy(ll),
                                  torch.tensor(old_beta, dtype=torch.float32),
                                  256)
    assert abs(float(bt) - float(bj)) <= 1e-6
    np.testing.assert_allclose(wt.numpy(), np.asarray(wj), rtol=2e-6,
                               atol=1e-12)
    assert abs(float(lt) - float(lj)) <= 1e-5


def test_systematic_indices_match_jax():
    key = jax.random.PRNGKey(3)
    u = jax.random.uniform(key, (), jnp.float32)
    # weights that are multiples of 1/N: every cumulative sum is k / N, and
    # the positions (u + i) / N lie u / N past one (u = 0.074 for this key),
    # far from any rounding of a float32 sum
    n = 256
    counts = np.random.RandomState(1).multinomial(n, np.ones(64) / 64)
    w = np.concatenate([counts / n, np.zeros(n - 64)]).astype(np.float32)
    for weights, exact in ((w, True),
                           (np.random.RandomState(2).dirichlet(
                               np.ones(4096)).astype(np.float32), False)):
        want = np.asarray(jsmc._systematic_indices(key, jnp.asarray(weights)))
        got = tsmc._systematic_indices(torch.tensor(float(u)),
                                       torch.from_numpy(weights)).numpy()
        if exact:
            np.testing.assert_array_equal(got, want)
        else:
            m = len(weights)
            diff = np.bincount(got, minlength=m) - np.bincount(want,
                                                               minlength=m)
            assert np.abs(diff).max() <= 1


def test_resample_gather_takes_every_array_through_one_index():
    w = torch.tensor([0.0, 0.5, 0.0, 0.5])
    a = torch.arange(4.0)
    b = torch.arange(8.0).reshape(4, 2)
    ga, gb = tsmc._resample_gather(torch.tensor(0.3), w, (a, b))
    assert ga.tolist() == [1.0, 1.0, 3.0, 3.0]
    assert gb[:, 0].tolist() == [2.0, 2.0, 6.0, 6.0]


def test_particle_cov_chol_matches_jax():
    rng = np.random.RandomState(4)
    X = (rng.randn(500, 3) @ np.array([[1.0, 0.5, 0], [0, 1.0, 0.3],
                                        [0, 0, 0.2]])).astype(np.float32)
    cj, Lj, okj = jsmc._particle_cov_chol(jnp.asarray(X))
    ct, Lt, okt = tsmc._particle_cov_chol(torch.from_numpy(X))
    assert bool(okt) and bool(okj)
    for got, want in ((ct, cj), (Lt, Lj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def test_particle_cov_chol_flags_a_failed_factorisation():
    """The case of ``tests/test_smc.py:159`` is positive definite in float32
    (1e6 + 1e-3 rounds to 1e6: the centred Gram is 0 and the jitter
    remains): both packages pass it. A non-finite particle fails in both.
    Near-collinear columns of magnitude 1e3-1e6 make Grams whose last pivot
    is rounding noise, which one LAPACK factors and another refuses (JAX on
    this CPU and torch disagree case by case), so there the port is held to
    its own factor: ``ok`` exactly when the factor's diagonal is finite and
    positive and reproduces the covariance."""
    base = np.full((64,), 1e6, dtype=np.float32)
    X = np.stack([base, base + 1e-3]).T.astype(np.float32)
    X = np.concatenate([X, X], axis=1)
    okj = bool(jsmc._particle_cov_chol(jnp.asarray(X))[2])
    okt = bool(tsmc._particle_cov_chol(torch.from_numpy(X))[2])
    assert okt and okj
    X = np.random.RandomState(5).randn(64, 3).astype(np.float32)
    X[7, 1] = np.inf
    assert not bool(jsmc._particle_cov_chol(jnp.asarray(X))[2])
    assert not bool(tsmc._particle_cov_chol(torch.from_numpy(X))[2])
    flags = []
    for scale in (1e3, 3e3, 1e4, 3e4, 1e5, 1e6):
        for rel in (0.0, 1e-7, 3e-7):
            r = np.random.RandomState(5).randn(64).astype(np.float32) * scale
            X = np.stack([r, r * np.float32(1 + rel)], 1)
            cov, L, ok = tsmc._particle_cov_chol(torch.from_numpy(X))
            d = torch.diagonal(L).double()
            valid = bool(torch.isfinite(d).all() and (d > 0).all()) and \
                np.allclose((L @ L.T).numpy(), cov.numpy(), rtol=1e-5,
                            atol=1e-5 * float(cov.abs().max()))
            assert bool(ok) == valid, (scale, rel, L)
            flags.append(bool(ok))
    assert not all(flags)


def test_tune_scalings_matches_jax():
    rng = np.random.RandomState(6)
    s = rng.uniform(0.1, 2.0, 300).astype(np.float32)
    a = rng.uniform(0.0, 1.0, 300).astype(np.float32)
    want = np.asarray(jsmc._tune_scalings(jnp.asarray(s), jnp.asarray(a)))
    got = tsmc._tune_scalings(torch.from_numpy(s), torch.from_numpy(a))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("name", ["bimodal", "hierarchical"])
def test_one_mutation_step_matches_jax_on_replayed_noise(name):
    """JAX's vmapped mutation chain at ``n_steps = 1`` on per-particle keys;
    the port's step on the normals and uniforms those keys give
    (``particle_chain``: ``key, k1, k2 = split(key, 3)``)."""
    mj, mt = MODELS[name](pj), MODELS[name](pt)
    draws = 200
    sj = jsmc.SMC(draws=draws, model=mj, random_seed=3)
    sj.initialize_population()
    sj.setup_kernel()
    sj.initialize_logp()
    sj.update_weights_beta()
    sj.resample()
    sj.update_proposal()
    keys = jax.random.split(jax.random.PRNGKey(9), draws)
    beta = np.float32(sj.beta)
    q, pl, ll, acc = sj._mutate_fn(
        keys, sj.posterior, sj.scalings, sj.prior_logp, sj.likelihood_logp,
        jnp.asarray(beta), sj.chol, jnp.asarray(1, jnp.int32))
    dim = sj.posterior.shape[1]

    def draws_of(k):
        _, k1, k2 = jax.random.split(k, 3)
        return (jax.random.normal(k1, (dim,), jnp.float32),
                jax.random.uniform(k2, (), jnp.float32))
    z, u = jax.vmap(draws_of)(keys)

    st = tsmc.SMC(draws=draws, model=mt, random_seed=3)
    st.setup_kernel()
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    qt, plt, llt, acct = tsmc._mutation_step(
        t(sj.posterior), t(sj.prior_logp), t(sj.likelihood_logp),
        float(beta), t(sj.chol), t(sj.scalings), t(z), t(u), st._logp_fn)
    np.testing.assert_array_equal(acct.numpy(), np.asarray(acc) > 0)
    assert 0 < acct.sum() < draws
    for got, want in ((qt, q), (plt, pl), (llt, ll)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("name", list(MODELS))
def test_prior_and_likelihood_terms_match_jax(name):
    mj, mt = MODELS[name](pj), MODELS[name](pt)
    rng = np.random.RandomState(12)
    q0 = mj.dict_to_array(mj.test_point)
    q = (q0[None] + 0.5 * rng.randn(16, q0.size)).astype(np.float32)
    for jfn, tfn in ((mj.varlogpt_fn(), mt.varlogpt_fn()),
                     (mj.datalogpt_fn(), mt.datalogpt_fn())):
        want = np.asarray(jax.jit(jax.vmap(jfn))(jnp.asarray(q)))
        got = tfn(torch.from_numpy(q)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# sample_smc end to end
# ---------------------------------------------------------------------------

def test_bimodal_mode_balance():
    """``tests/test_smc.py::test_sample_bimodal`` with the port: the
    dominant mode (weight 0.9, at -0.5) holds the mean, and the other mode
    keeps between 1% and 40% of the particles."""
    x = pt.sample_smc(draws=2000, model=bimodal(pt), random_seed=1,
                      n_steps=20)["X"]
    assert np.all(np.sign(x.mean(axis=0)) == -1)
    assert 0.01 < np.mean(x[:, 0] > 0) < 0.4


def test_beta_binomial_evidence():
    """The log evidence against its closed form, betaln(51, 51) -
    betaln(1, 1), within 0.3: four JAX seeds (2-5) at 2000 particles missed
    it by -0.029, 0.023, 0.020 and 0.034, so 0.3 is nine times the largest
    (``tests/test_smc.py`` allows 1.0)."""
    from scipy.special import betaln
    trace = pt.sample_smc(2000, model=beta_binomial(pt), random_seed=2)
    expected = betaln(51.0, 51.0) - betaln(1.0, 1.0)
    assert abs(trace.report.log_marginal_likelihood - expected) < 0.3
    assert abs(trace["a"].mean() - 0.5) < 0.02


def test_abc_with_a_torch_and_a_numpy_simulator():
    """``tests/test_smc.py::test_smc_abc``: ``a`` within 0.5 of the data's
    mean. A torch simulator runs batched under ``vmap`` and never moves
    the host counter; a numpy one is called on the host once per particle
    per evaluation."""
    data = abc_data()
    before = tsmc.HOST_SIMULATOR_CALLS
    trace = pt.sample_smc(draws=1000, kernel="abc", epsilon=0.5,
                          model=abc(pt), random_seed=4)
    assert abs(trace["a"].mean() - data.mean()) < 0.5
    assert tsmc.HOST_SIMULATOR_CALLS == before

    def numpy_sim(a, b):
        return np.asarray(a) + np.asarray(b) * np.zeros(200)
    trace = pt.sample_smc(draws=500, kernel="abc", epsilon=0.5,
                          model=abc(pt, numpy_sim), random_seed=4)
    assert abs(trace["a"].mean() - data.mean()) < 0.5
    assert tsmc.HOST_SIMULATOR_CALLS - before >= 500 * 2


def test_abc_requires_a_simulator():
    smc = tsmc.SMC(draws=10, kernel="abc", model=beta_binomial(pt))
    with pytest.raises(ValueError, match="Simulator"):
        smc.setup_kernel()


def test_conjugate_posterior_and_trace():
    """A conjugate normal (``tests/test_smc.py::TestShardedSMC`` on one
    device): posterior means within 0.1, and the trace holds every
    unobserved variable."""
    with pt.Model() as model:
        pt.Normal("x", 0.0, 1.0, shape=2)
        pt.HalfNormal("s", 1.0)
        pt.Normal("y", mu=model["x"], sigma=0.5,
                  observed=np.array([1.0, -1.0], np.float32))
    trace = pt.sample_smc(draws=4096, model=model, random_seed=1)
    post_mean = np.array([1.0, -1.0]) * (1 / 0.25) / (1 + 1 / 0.25)
    np.testing.assert_allclose(trace["x"].mean(axis=0), post_mean, atol=0.1)
    assert set(trace.varnames) == {"x", "s", "s_log__"}
    assert trace["x"].shape == (4096, 2)
    np.testing.assert_allclose(np.log(trace["s"]), trace["s_log__"],
                               rtol=1e-5, atol=1e-5)


def test_start_points_seed_the_population():
    model = beta_binomial(pt)
    smc = tsmc.SMC(draws=8, model=model, start={"a_logodds__": 0.25})
    smc.initialize_population()
    assert smc.posterior.shape == (8, 1)
    assert torch.all(smc.posterior == 0.25)


def test_a_stage_reads_three_numbers_from_the_device(monkeypatch):
    """Per stage: β with the evidence increment (one copy), the proposal's
    ok flag and the mean acceptance; nothing else is read back, however
    many mutation steps run (``Tensor.item``, ``__bool__``, ``__float__``
    and ``tolist`` are spied on)."""
    model = hierarchical(pt)
    smc = tsmc.SMC(draws=300, model=model, random_seed=5, n_steps=7)
    smc.initialize_population()
    smc.setup_kernel()
    smc.initialize_logp()
    calls = []
    for name in ("item", "__bool__", "__float__", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    stages = 0
    while smc.beta < 1:
        smc.update_weights_beta()
        smc.resample()
        smc.update_proposal()
        if stages > 0:
            smc.tune()
        smc.mutate()
        stages += 1
        assert len(calls) == 3 * stages, calls
    monkeypatch.undo()
    assert stages >= 2
    assert calls == ["tolist", "__bool__", "item"] * stages


def test_devices_and_mesh_raise():
    """Sharded SMC is ported (``test_torch_parallel.py``); outside a
    process group two devices raise, and a ``mesh`` must be a
    ``parallel.ChainMesh``."""
    model = beta_binomial(pt)
    with pytest.raises(ValueError, match="one process each"):
        pt.sample_smc(draws=10, model=model, devices=["cpu", "cpu"])
    with pytest.raises(TypeError, match="ChainMesh"):
        pt.sample_smc(draws=10, model=model, mesh=object())


def test_stage_state_stays_on_the_model_device():
    """``test_particle_state_stays_on_device``: between stages the particle
    state is tensors, β and the acceptance host floats."""
    with pt.Model() as model:
        x = pt.Normal("x", 0.0, 1.0, shape=2)
        pt.Normal("obs", mu=x.sum(), sigma=1.0, observed=np.array([0.3]))
    smc = tsmc.SMC(draws=256, model=model, random_seed=4, n_steps=3)
    smc.initialize_population()
    smc.setup_kernel()
    smc.initialize_logp()
    for _ in range(3):
        if smc.beta >= 1:
            break
        smc.update_weights_beta()
        smc.resample()
        smc.update_proposal()
        smc.mutate()
        for name in ("posterior", "prior_logp", "likelihood_logp",
                     "acc_per_chain", "scalings", "weights", "chol"):
            val = getattr(smc, name)
            assert isinstance(val, torch.Tensor) and \
                val.device == model.device, name
        assert isinstance(smc.beta, float)
        assert isinstance(smc.acc_rate, float)
