"""The port's Metropolis family against the JAX package's, one transition
on the same injected noise.

The JAX kernels draw inside the kernel from key splits. Each test replays
those splits with ``jax.random`` (the same calls on the same sub-keys, per
chain), hands the numbers to the port's kernel as its ``noise``, starts
both from the same state (``pymc3_tpu_torch.convert``), and compares the new
``q`` (float32: rtol 2e-5, atol 2e-6; discrete coordinates and ``accepted``
exactly), ``accept`` and the tuned scales.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods import metropolis as jm
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.step_methods import metropolis as tm
from pymc3_tpu_torch.step_methods.arraystep import (
    GeneratorNoise, TuneContext, metrop_select,
)

from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-6)
F32 = jnp.float32
P3 = np.array([0.2, 0.5, 0.3])
P4 = np.array([0.1, 0.4, 0.3, 0.2])


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


class Replay:
    """Hands out, per kind of draw, the arrays queued for it, in order."""

    device = torch.device("cpu")

    def __init__(self):
        self.queues = {}

    def push(self, kind, rows):
        """One call's worth: ``rows`` stacked over the chains."""
        self.queues.setdefault(kind, []).append(np.stack(
            [np.asarray(r) for r in rows]))

    def _pop(self, kind):
        return torch.from_numpy(np.array(self.queues[kind].pop(0)))

    def normal(self, dim):
        return self._pop("normal")

    def uniform(self, dim=None):
        return self._pop("uniform")

    def randint(self, low, high, dim=None):
        return self._pop("randint").long()

    def permutation(self, n):
        return self._pop("permutation").long()

    def spent(self):
        return all(len(v) == 0 for v in self.queues.values())


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _tune(tune=True, idx=5):
    return (JaxTune(jnp.asarray(tune), jnp.asarray(idx, jnp.int32), 100),
            TuneContext(tune, idx, 100))


def _mixed_model(pm):
    with pm.Model() as model:
        x = pm.Normal("x", 0.0, 1.0, shape=2)
        k = pm.Poisson("k", 3.0)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", mu=x.sum() + k, sigma=s + 0.5,
                  observed=np.array([2.5, 4.0, 3.1]))
    return model


def _start(model, C, seed, spread=0.4, discrete=()):
    rng = np.random.RandomState(seed)
    q0 = model.dict_to_array(model.test_point)
    q = q0[None] + rng.uniform(-spread, spread, (C, q0.size))
    for col in discrete:
        q[:, col] = np.round(q[:, col])
    return q.astype(np.float32)


@pytest.mark.parametrize("vars_", [["x", "k", "s"], ["k"], ["x"]],
                         ids=["all", "discrete-only", "partial"])
def test_metropolis_transition_matches_jax(vars_):
    """New q, accepted, accept and the tuned scaling (this draw closes a
    tuning interval; the chains' acceptance counts span the table)."""
    mj, mt = _mixed_model(pj), _mixed_model(pt)
    C = 7
    js = pj.Metropolis(vars=[mj[v] for v in vars_], model=mj, blocked=True,
                       scaling=0.5, tune_interval=20)
    ts = pt.Metropolis(vars=[mt[v] for v in vars_], model=mt, blocked=True,
                       scaling=0.5, tune_interval=20)
    assert isinstance(ts, pt.Metropolis) and ts.dim == js.dim
    np.testing.assert_array_equal(ts.q_indices, js.q_indices)
    np.testing.assert_array_equal(ts.discrete, js.discrete)
    q0 = _start(mt, C, 1, discrete=[2])
    jstate = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    jstate = jstate._replace(
        since_tune=jnp.full((C,), 19, jnp.int32),
        accept_sum=jnp.asarray([0.0, 0.5, 3.0, 8.0, 11.0, 15.5, 19.0], F32))
    keys = jax.random.split(jax.random.PRNGKey(4), C)
    jt, tt = _tune()
    jq, jnew, jstats = jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, jt))(keys, jnp.asarray(q0),
                                                     jstate)
    noise = Replay()
    splits = [jax.random.split(k) for k in keys]
    noise.push("normal", [jax.random.normal(s[0], (js.dim,), F32)
                          for s in splits])
    noise.push("uniform", [jax.random.uniform(s[1], (), F32) for s in splits])
    tq, tnew, tstats = ts.kernel_step(torch.from_numpy(q0),
                                      convert.metropolis_state(_np(jstate)),
                                      tt, noise)
    assert noise.spent()
    np.testing.assert_array_equal(tstats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    assert 0 < int(tstats["accepted"].sum()) < C
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_array_equal(tq.numpy()[:, 2], np.asarray(jq)[:, 2])
    assert np.all(tq.numpy()[:, 2] == np.round(tq.numpy()[:, 2]))
    np.testing.assert_allclose(tstats["accept"].numpy(),
                               np.asarray(jstats["accept"]), rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(tnew.scaling.numpy(), np.asarray(jnew.scaling),
                               rtol=1e-6)
    assert len(np.unique(tnew.scaling.numpy())) >= 5
    np.testing.assert_allclose(tnew.logp.numpy(), np.asarray(jnew.logp),
                               rtol=2e-5, atol=2e-5)
    assert tnew.since_tune == 0 and not tnew.accept_sum.any()
    assert tstats["tune"].all() and set(tstats) == set(
        pt.Metropolis.stats_dtypes[0])


def test_metropolis_does_not_tune_off_schedule():
    mt = _mixed_model(pt)
    ts = pt.Metropolis(vars=mt.free_RVs, model=mt, blocked=True,
                       tune_interval=3)
    q = torch.from_numpy(_start(mt, 4, 2, discrete=[2]))
    noise = GeneratorNoise(torch.Generator().manual_seed(0), 4, "cpu")
    state = ts.kernel_init(q)
    for i in range(2):
        q, state, stats = ts.kernel_step(q, state, TuneContext(True, i, 9),
                                         noise)
        assert state.since_tune == i + 1 and (stats["scaling"] == 1.0).all()
    # off tune the interval passes and nothing is tuned
    q, state, stats = ts.kernel_step(q, state, TuneContext(False, 2, 2),
                                     noise)
    assert state.since_tune == 3 and (stats["scaling"] == 1.0).all()
    assert not stats["tune"].any()


def test_tune_scaling_on_all_seven_branches():
    acc = np.array([0.0, 0.0005, 0.001, 0.01, 0.05, 0.1, 0.2, 0.3, 0.5, 0.6,
                    0.75, 0.8, 0.95, 0.99, 1.0], np.float32)
    scale = np.linspace(0.5, 2.0, acc.size).astype(np.float32)
    got = tm.tune_scaling(torch.from_numpy(scale), torch.from_numpy(acc))
    want = jm.tune_scaling(jnp.asarray(scale), jnp.asarray(acc))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    assert len(np.unique(np.round(got.numpy() / scale, 4))) == 7


def _binary_model(pm):
    coef = np.array([0.8, -0.5, 1.2, 0.3])
    with pm.Model() as model:
        z = pm.Bernoulli("z", p=0.4, shape=4)
        w = pm.Normal("w", 0.0, 1.0)
        pm.Normal("y", mu=(z * coef).sum() + w, sigma=1.0, observed=1.3)
    return model


def _binary_start(mt, C, seed):
    q0 = _start(mt, C, seed)
    q0[:, :4] = np.random.RandomState(seed).randint(0, 2, (C, 4))
    return q0


def test_binary_metropolis_transition_matches_jax():
    mj, mt = _binary_model(pj), _binary_model(pt)
    C = 8
    js = pj.BinaryMetropolis([mj["z"]], model=mj, scaling=1.5)
    ts = pt.BinaryMetropolis([mt["z"]], model=mt, scaling=1.5)
    q0 = _binary_start(mt, C, 3)
    jstate = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(9), C)
    jt, tt = _tune()
    jq, jnew, jstats = jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, jt))(keys, jnp.asarray(q0),
                                                     jstate)
    noise = Replay()
    splits = [jax.random.split(k) for k in keys]
    noise.push("uniform", [jax.random.uniform(s[0], (4,), F32)
                           for s in splits])
    noise.push("uniform", [jax.random.uniform(s[1], (), F32) for s in splits])
    tq, tnew, tstats = ts.kernel_step(torch.from_numpy(q0),
                                      convert.binary_state(_np(jstate)), tt,
                                      noise)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tq.numpy() != q0).any()
    np.testing.assert_allclose(tstats["accept"].numpy(),
                               np.asarray(jstats["accept"]), rtol=2e-4)
    np.testing.assert_allclose(tstats["p_jump"].numpy(),
                               np.asarray(jstats["p_jump"]), rtol=1e-6)
    np.testing.assert_allclose(tnew.logp.numpy(), np.asarray(jnew.logp),
                               rtol=2e-5, atol=2e-5)
    with pytest.raises(ValueError, match="must be Bernoulli"):
        pt.BinaryMetropolis([mt["w"]], model=mt)


def _scan_noise(keys, dim, jump_max=None):
    """The numbers a JAX Gibbs scan consumes: the permutation, then per
    coordinate the proposal draw and the acceptance uniform."""
    noise = Replay()
    perms, scan_keys = [], []
    for k in keys:
        k_perm, k_scan = jax.random.split(k)
        perms.append(jax.random.permutation(k_perm,
                                            jnp.arange(dim, dtype=jnp.int32)))
        scan_keys.append(k_scan)
    noise.push("permutation", perms)
    for _ in range(dim):
        props, accs = [], []
        for c, key in enumerate(scan_keys):
            scan_keys[c], k_p, k_a = jax.random.split(key, 3)
            if jump_max is None:
                props.append(jax.random.uniform(k_p, (), F32))
            else:
                props.append(jax.random.randint(k_p, (), 1, jump_max))
            accs.append(jax.random.uniform(k_a, (), F32))
        if jump_max is None:
            noise.push("uniform", props)
        else:
            noise.push("randint", props)
        noise.push("uniform", accs)
    return noise


def test_binary_gibbs_transition_matches_jax():
    """One permutation per chain, as in the JAX package."""
    mj, mt = _binary_model(pj), _binary_model(pt)
    C = 8
    js = pj.BinaryGibbsMetropolis([mj["z"]], model=mj)
    ts = pt.BinaryGibbsMetropolis([mt["z"]], model=mt)
    q0 = _binary_start(mt, C, 5)
    jstate = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(2), C)
    jt, tt = _tune()
    jq, jnew, _ = jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, jt))(keys, jnp.asarray(q0),
                                                     jstate)
    noise = _scan_noise(keys, 4)
    tq, tnew, tstats = ts.kernel_step(torch.from_numpy(q0),
                                      convert.binary_state(_np(jstate)), tt,
                                      noise)
    assert noise.spent()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tq.numpy() != q0).any()
    np.testing.assert_allclose(tnew.logp.numpy(), np.asarray(jnew.logp),
                               rtol=2e-5, atol=2e-5)
    assert tstats["tune"].all()


def test_binary_gibbs_fixed_order_visits_only_those():
    mt = _binary_model(pt)
    ts = pt.BinaryGibbsMetropolis([mt["z"]], model=mt, order=[2, 0],
                                  transit_p=1.0)
    q0 = torch.from_numpy(_binary_start(mt, 16, 1))
    noise = GeneratorNoise(torch.Generator().manual_seed(3), 16, "cpu")
    q, _, _ = ts.kernel_step(q0, ts.kernel_init(q0), TuneContext(True, 0, 1),
                             noise)
    assert (q[:, [1, 3, 4]] == q0[:, [1, 3, 4]]).all()
    assert (q[:, [0, 2]] != q0[:, [0, 2]]).any()


def _categorical_model(pm):
    with pm.Model() as model:
        c = pm.Categorical("c", p=P3, shape=2)
        d = pm.Categorical("d", p=P4)
        pm.Normal("y", mu=c.sum() * 0.7 + d * 0.4, sigma=1.0, observed=1.9)
    return model


def test_categorical_gibbs_transition_matches_jax():
    """Variables of 3 and 4 categories in one scan: the jump is drawn up to
    the largest and folded into each coordinate's own range."""
    mj, mt = _categorical_model(pj), _categorical_model(pt)
    C = 10
    js = pj.CategoricalGibbsMetropolis([mj["c"], mj["d"]], model=mj)
    ts = pt.CategoricalGibbsMetropolis([mt["c"], mt["d"]], model=mt)
    np.testing.assert_array_equal(ts._k, js._k)
    assert ts.max_k == js.max_k == 4
    rng = np.random.RandomState(0)
    q0 = np.stack([rng.randint(0, 3, C), rng.randint(0, 3, C),
                   rng.randint(0, 4, C)], 1).astype(np.float32)
    jstate = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(6), C)
    jt, tt = _tune()
    jq, jnew, _ = jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, jt))(keys, jnp.asarray(q0),
                                                     jstate)
    noise = _scan_noise(keys, 3, jump_max=4)
    tq, tnew, _ = ts.kernel_step(torch.from_numpy(q0),
                                 convert.binary_state(_np(jstate)), tt, noise)
    assert noise.spent()
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert (tq.numpy() != q0).any()
    assert tq[:, :2].max() <= 2 and tq[:, 2].max() <= 3 and tq.min() >= 0
    np.testing.assert_allclose(tnew.logp.numpy(), np.asarray(jnew.logp),
                               rtol=2e-5, atol=2e-5)


def _continuous_model(pm):
    with pm.Model() as model:
        x = pm.Normal("x", 0.5, 2.0, shape=3)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", mu=x.sum(), sigma=s + 0.2,
                  observed=np.array([1.0, 2.0]))
    return model


def test_demetropolis_population_step_matches_jax():
    mj, mt = _continuous_model(pj), _continuous_model(pt)
    C = 9
    js = pj.DEMetropolis(model=mj, tune="scaling", scaling=0.05,
                         tune_interval=10)
    ts = pt.DEMetropolis(model=mt, tune="scaling", scaling=0.05,
                         tune_interval=10)
    assert ts.population_based and ts.lamb == pytest.approx(js.lamb)
    Q0 = _start(mt, C, 8, spread=1.0)
    jstate = js.kernel_init(jnp.asarray(Q0))._replace(
        since_tune=jnp.asarray(9, jnp.int32), accept_sum=jnp.asarray(8.0, F32))
    key = jax.random.PRNGKey(12)
    jt, tt = _tune()
    jQ, jnew, jstats = js.population_kernel_step(key, jnp.asarray(Q0), jstate,
                                                 jt)
    k_r1, k_r2, k_eps, k_acc = jax.random.split(key, 4)
    noise = Replay()
    noise.queues = {
        "randint": [np.asarray(jax.random.randint(k, (C,), 0, C - 1))
                    for k in (k_r1, k_r2)],
        "normal": [np.asarray(jax.random.normal(k_eps, Q0.shape, F32))],
        "uniform": [np.asarray(jax.random.uniform(k_acc, (C,), F32))]}
    tQ, tnew, tstats = ts.population_kernel_step(
        torch.from_numpy(Q0), convert.dem_state(_np(jstate)), tt, noise)
    np.testing.assert_array_equal(tstats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    assert 0 < int(tstats["accepted"].sum()) < C
    np.testing.assert_allclose(tQ.numpy(), np.asarray(jQ), **TOL)
    np.testing.assert_allclose(tstats["accept"].numpy(),
                               np.asarray(jstats["accept"]), rtol=2e-4,
                               atol=1e-6)
    for name in ("scaling", "lambda"):
        np.testing.assert_allclose(tstats[name].numpy(),
                                   np.asarray(jstats[name]), rtol=1e-6)
    # 8 of 9 intervals accepted and this draw's share: above 0.75, doubled
    assert float(tnew.scaling) == pytest.approx(0.1)
    assert tnew.since_tune == 0
    with pytest.raises(ValueError, match="must be one of"):
        pt.DEMetropolis(model=mt, tune="both")


def test_demetropolis_z_transition_matches_jax():
    mj, mt = _continuous_model(pj), _continuous_model(pt)
    C, cap = 6, 12
    kw = dict(tune="lambda", tune_interval=10, history_capacity=cap,
              scaling=0.01)
    js, ts = pj.DEMetropolisZ(model=mj, **kw), pt.DEMetropolisZ(model=mt, **kw)
    q0 = _start(mt, C, 10, spread=0.8)
    rng = np.random.RandomState(4)
    hist = np.zeros((C, cap, q0.shape[1]), np.float32)
    hist[:, :5] = q0[:, None] + rng.normal(0, 0.7, (C, 5, q0.shape[1]))
    jstate = jax.vmap(js.kernel_init)(jnp.asarray(q0))._replace(
        history=jnp.asarray(hist), hist_len=jnp.full((C,), 5, jnp.int32),
        since_tune=jnp.full((C,), 9, jnp.int32),
        accept_sum=jnp.asarray([0.0, 1.0, 3.0, 5.0, 7.0, 9.0], F32))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    jt, tt = _tune()
    jq, jnew, jstats = jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, jt))(keys, jnp.asarray(q0),
                                                     jstate)
    noise = Replay()
    splits = [jax.random.split(k, 4) for k in keys]
    noise.push("randint", [jax.random.randint(s[0], (), 0, 5)
                           for s in splits])
    noise.push("randint", [jax.random.randint(s[1], (), 0, 5)
                           for s in splits])
    noise.push("normal", [jax.random.normal(s[2], (q0.shape[1],), F32)
                          for s in splits])
    noise.push("uniform", [jax.random.uniform(s[3], (), F32) for s in splits])
    tstate = convert.demz_state(_np(jstate))
    assert tstate.history.shape == (cap, C, q0.shape[1])
    tq, tnew, tstats = ts.kernel_step(torch.from_numpy(q0), tstate, tt, noise)
    np.testing.assert_array_equal(tstats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    assert 0 < int(tstats["accepted"].sum()) < C
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), **TOL)
    np.testing.assert_allclose(tnew.lamb.numpy(), np.asarray(jnew.lamb),
                               rtol=1e-6)
    np.testing.assert_allclose(tnew.scaling.numpy(),
                               np.asarray(jnew.scaling), rtol=1e-6)
    assert len(np.unique(tnew.lamb.numpy())) >= 4
    assert tnew.hist_len == 6 and tnew.since_tune == 0
    np.testing.assert_allclose(
        tnew.history.numpy(), np.swapaxes(np.asarray(jnew.history), 0, 1),
        **TOL)
    np.testing.assert_array_equal(tnew.history[5].numpy(), tq.numpy())


def test_demetropolis_z_ring_wraps_and_starts_empty():
    mt = _continuous_model(pt)
    ts = pt.DEMetropolisZ(model=mt, history_capacity=4)
    q = torch.from_numpy(_start(mt, 5, 1))
    noise = GeneratorNoise(torch.Generator().manual_seed(1), 5, "cpu")
    state = ts.kernel_init(q)
    for i in range(6):
        q, state, _ = ts.kernel_step(q, state, TuneContext(True, i, 6), noise)
        np.testing.assert_array_equal(state.history[i % 4].numpy(), q.numpy())
    assert state.hist_len == 6 and state.history.shape == (4, 5, 4)
    assert torch.isfinite(q).all()


PROPOSALS = [
    ("Normal", pt.NormalProposal, lambda x, s: x.std(0) / s, 1.0),
    ("Uniform", pt.UniformProposal, lambda x, s: x.std(0) / s, 3 ** -0.5),
    ("Cauchy", pt.CauchyProposal,
     lambda x, s: np.median(np.abs(x), 0) / s, 1.0),
    ("Laplace", pt.LaplaceProposal, lambda x, s: x.std(0) / s, 2 ** 0.5),
    ("Poisson", pt.PoissonProposal, lambda x, s: x.var(0) / s, 1.0),
]


@pytest.mark.parametrize("name,cls,spread,want", PROPOSALS,
                         ids=[p[0] for p in PROPOSALS])
def test_proposal_scales_by_moments(name, cls, spread, want):
    """Each proposal's spread is its scale ``s`` times the family's
    constant, per coordinate, centred on zero (3%)."""
    s = np.array([0.5, 2.0, 4.0])
    noise = GeneratorNoise(torch.Generator().manual_seed(7), 60000, "cpu")
    x = cls(s).sample(noise, 3).double().numpy()
    assert x.shape == (60000, 3)
    np.testing.assert_allclose(spread(x, s), want, rtol=0.03)
    if name != "Poisson":       # a lattice: its mean is held below
        np.testing.assert_allclose(np.median(x, 0) / s, 0.0, atol=0.03)
    if name == "Uniform":
        assert np.all(np.abs(x) <= s)
    if name == "Poisson":
        np.testing.assert_allclose(x.mean(0), 0.0, atol=0.05)


def test_multivariate_normal_proposal_and_2d_S():
    cov = np.array([[2.0, 0.9], [0.9, 1.0]])
    noise = GeneratorNoise(torch.Generator().manual_seed(8), 60000, "cpu")
    x = pt.MultivariateNormalProposal(cov).sample(noise).double().numpy()
    np.testing.assert_allclose(np.cov(x.T), cov, rtol=0.05, atol=0.03)
    with pytest.raises(ValueError, match="not symmetric"):
        pt.MultivariateNormalProposal(np.ones((2, 3)))
    with pt.Model(device="cpu") as m:
        pt.Normal("x", 0.0, 1.0, shape=2)
    step = pt.Metropolis(model=m, S=cov, blocked=True)
    assert isinstance(step.proposal_dist, pt.MultivariateNormalProposal)
    assert isinstance(pt.Metropolis(model=m, S=np.ones(2), blocked=True,
                                    proposal_dist=pt.LaplaceProposal
                                    ).proposal_dist, pt.LaplaceProposal)
    with pytest.raises(ValueError, match="Invalid rank"):
        pt.Metropolis(model=m, S=np.ones((2, 2, 2)), blocked=True)


def test_metrop_select():
    q, q0 = torch.ones(3, 2), torch.zeros(3, 2)
    mr = torch.tensor([0.0, -1.0, -np.inf])
    u = torch.tensor([0.5, 0.5, 0.5])
    new, acc = metrop_select(mr, q, q0, u)
    assert acc.tolist() == [True, False, False]
    assert new[:, 0].tolist() == [1.0, 0.0, 0.0]


COMPETENCE = ["Metropolis", "BinaryMetropolis", "BinaryGibbsMetropolis",
              "CategoricalGibbsMetropolis", "DEMetropolis", "DEMetropolisZ",
              "Slice", "HamiltonianMC", "NUTS"]


@pytest.mark.parametrize("name", COMPETENCE)
def test_competence_matches_jax(name):
    def build(pm):
        with pm.Model() as model:
            pm.Normal("x", 0.0, 1.0)
            pm.Poisson("k", 3.0)
            pm.Bernoulli("b", 0.5)
            pm.Categorical("c2", p=np.array([0.5, 0.5]))
            pm.Categorical("c3", p=P3)
        return model
    mj, mt = build(pj), build(pt)
    for var in ("x", "k", "b", "c2", "c3"):
        for has_grad in (False, True):
            assert int(getattr(pt, name).competence(mt[var], has_grad)) == \
                int(getattr(pj, name).competence(mj[var], has_grad)), var
