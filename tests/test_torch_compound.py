"""Step assignment, compounding and partial NUTS of the port against the JAX
package's.

``assign_step_methods`` must give the JAX package's classes and variable
groups; a NUTS over a subset of the flat vector must see the JAX
``sub_logp``'s value and gradient (rtol 2e-5 / 1e-4) and make the JAX
transition on the same momentum and uniforms; ``q`` must thread through a
compound; the trace must hold one block of statistics per stepper; and
``sample()`` of the coal-mining switchpoint model must land on its exact
posterior (closed form, float64) within four Monte-Carlo standard errors.
"""
import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.examples import disaster_model as jdisaster
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.examples import disaster_model as tdisaster
from pymc3_tpu_torch.examples.suite import (
    correlated_normal_model, disaster_exact_posterior, moment_check,
    posterior_moments,
)
from pymc3_tpu_torch.step_methods.arraystep import GeneratorNoise, TuneContext

from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .test_torch_hmc import ReplayNoise

torch.set_num_threads(2)
P3 = np.array([0.2, 0.5, 0.3])


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _normal(pm):
    with pm.Model() as m:
        pm.Normal("x", 0, 1)
    return m


def _poisson(pm):
    with pm.Model() as m:
        pm.Poisson("z", 2.0)
    return m


def _bernoulli(pm):
    with pm.Model() as m:
        pm.Bernoulli("b", 0.5)
    return m


def _mixed(pm):
    with pm.Model() as m:
        pm.Normal("x", 0, 1)
        pm.Poisson("z", 2.0)
    return m


def _everything(pm):
    with pm.Model() as m:
        pm.HalfNormal("s", 1.0)
        pm.Categorical("c", p=P3)
        pm.Bernoulli("b", 0.5, shape=2)
        pm.Normal("x", 0, 1, shape=2)
        pm.DiscreteUniform("k", 0, 5)
    return m


def _disaster(pm):
    return (jdisaster if pm is pj else tdisaster).build_model()


MODELS = {"normal": _normal, "poisson": _poisson, "bernoulli": _bernoulli,
          "mixed": _mixed, "everything": _everything, "disaster": _disaster}


def _groups(steps):
    steps = steps if isinstance(steps, list) else [steps]
    return [(type(s).__name__, [v.name for v in s.vars]) for s in steps]


@pytest.mark.parametrize("name", list(MODELS))
def test_assign_step_methods_matches_jax(name):
    mj, mt = MODELS[name](pj), MODELS[name](pt)
    want = _groups(pj.assign_step_methods(mj))
    got = _groups(pt.assign_step_methods(mt))
    assert got == want
    if name == "disaster":
        assert got == [("Metropolis", ["switchpoint"]),
                       ("NUTS", ["early_mean_log__", "late_mean_log__"])]


def test_step_methods_tuple_and_exports_match_jax():
    from pymc3_tpu import step_methods as js
    from pymc3_tpu_torch import step_methods as ts
    assert [c.__name__ for c in ts.STEP_METHODS] == \
        [c.__name__ for c in js.STEP_METHODS]
    assert len(ts.STEP_METHODS) == 7
    for name in ["NUTS", "HamiltonianMC", "Metropolis", "BinaryMetropolis",
                 "BinaryGibbsMetropolis", "CategoricalGibbsMetropolis",
                 "DEMetropolis", "DEMetropolisZ", "Slice", "CompoundStep",
                 "NormalProposal", "UniformProposal", "CauchyProposal",
                 "LaplaceProposal", "PoissonProposal",
                 "MultivariateNormalProposal", "assign_step_methods",
                 "instantiate_steppers", "stop_tuning"]:
        assert hasattr(pt, name) and hasattr(pt.sampling, name) | \
            hasattr(pt.step_methods, name), name
        assert hasattr(pj, name) or hasattr(pj.sampling, name), name
        if hasattr(getattr(pt, name), "stats_dtypes"):
            assert getattr(pt, name).stats_dtypes == \
                getattr(pj, name).stats_dtypes, name
            assert getattr(pt, name).name == getattr(pj, name).name


def test_assign_keeps_given_steps_and_passes_kwargs():
    mt = _everything(pt)
    given = pt.Metropolis(vars=[mt["k"]], model=mt)
    steps = pt.assign_step_methods(
        mt, given, step_kwargs={"nuts": {"target_accept": 0.9}})
    assert steps[0] is given
    nuts = [s for s in steps if isinstance(s, pt.NUTS)][0]
    assert nuts.target_accept == 0.9 and nuts.is_partial
    assert sorted(v.name for s in steps for v in s.vars) == \
        sorted(v.name for v in mt.free_RVs)
    with pytest.raises(ValueError, match="Unused step method arguments"):
        pt.assign_step_methods(_normal(pt), step_kwargs={"slice": {"w": 2}})


def test_has_grad_never_differentiates_a_discrete_variable(monkeypatch):
    from pymc3_tpu_torch import sampling
    mt = _mixed(pt)

    def boom(self):
        raise AssertionError("autograd asked for a discrete variable")
    monkeypatch.setattr(type(mt), "logp_dlogp_function", boom)
    assert sampling._has_grad(mt, mt["z"]) is False


def test_blocked_step_new_splits_an_unblocked_list():
    mt = _everything(pt)
    comp = pt.Metropolis(vars=[mt["x"], mt["k"]], model=mt)
    assert isinstance(comp, pt.CompoundStep)
    assert [type(m) for m in comp.methods] == [pt.Metropolis] * 2
    assert [[v.name for v in m.vars] for m in comp.methods] == [["x"], ["k"]]
    assert all(m.is_partial for m in comp.methods)
    assert comp.stats_dtypes == pt.Metropolis.stats_dtypes * 2
    assert isinstance(pt.Slice(vars=[mt["x"], mt["s"]], model=mt),
                      pt.CompoundStep)
    blocked = pt.Metropolis(vars=[mt["x"], mt["k"]], model=mt, blocked=True)
    assert isinstance(blocked, pt.Metropolis) and blocked.dim == 3
    # NUTS is blocked by default; one variable is never split
    assert isinstance(pt.NUTS(vars=[mt["x"], mt["s"]], model=mt), pt.NUTS)
    assert isinstance(pt.Metropolis(vars=[mt["k"]], model=mt), pt.Metropolis)
    np.testing.assert_array_equal(blocked.q_indices, [4, 5, 6])
    args, kwargs = blocked.__getnewargs_ex__()
    assert [v.name for v in args[0]] == ["x", "k"] and kwargs["blocked"]
    pickle.dumps(kwargs)


def _disaster_points(C, seed):
    rng = np.random.RandomState(seed)
    q = np.empty((C, 3), np.float32)
    q[:, 0] = rng.randint(30, 60, C)
    q[:, 1] = np.log(3.0) + rng.uniform(-0.3, 0.3, C)
    q[:, 2] = np.log(1.0) + rng.uniform(-0.3, 0.3, C)
    return q


def _rates(m):
    return [m["early_mean"], m["late_mean"]]


def test_partial_nuts_logp_and_gradient_match_jax_sub_logp():
    mj, mt = _disaster(pj), _disaster(pt)
    js, ts = pj.NUTS(vars=_rates(mj), model=mj), pt.NUTS(vars=_rates(mt),
                                                         model=mt)
    assert ts.is_partial and ts.dim == js.dim == 2
    np.testing.assert_array_equal(ts.q_indices, js.q_indices)
    assert ts.step_size == pytest.approx(js.step_size)
    np.testing.assert_allclose(ts.potential._initial_mean,
                               [0.0, 0.0], atol=1e-6)
    q = _disaster_points(5, 0)
    x = q[:, 1:] + 0.1
    lj, gj = jax.vmap(jax.value_and_grad(js._kernel_logp))(jnp.asarray(x),
                                                          jnp.asarray(q))
    lt, gt = ts._value_and_grad_at(torch.from_numpy(q))(torch.from_numpy(x))
    assert gt.shape == (5, 2) and torch.isfinite(gt).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=2e-5)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4)
    # the full gradient is finite too, and nothing flows to the switchpoint
    _, full = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert torch.isfinite(full).all() and not full[:, 0].any()


def test_partial_nuts_transition_on_identical_noise():
    """Same depth, same number of leapfrogs, same next q (within 1e-4); the
    switchpoint column passes through, and the stale cached logp of the
    state is not used."""
    mj, mt = _disaster(pj), _disaster(pt)
    C, max_depth = 4, 5
    js = pj.NUTS(vars=_rates(mj), model=mj, max_treedepth=max_depth)
    ts = pt.NUTS(vars=_rates(mt), model=mt, max_treedepth=max_depth)
    q0 = _disaster_points(C, 1)
    jinit = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    q1 = q0.copy()
    q1[:, 0] += np.array([-7, 4, 0, 9], np.float32)   # "another stepper"
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    jq, jst, jstats = jax.vmap(
        lambda k, q, s: js.kernel_step(
            k, q, s, JaxTune(jnp.asarray(True), jnp.asarray(250, jnp.int32),
                             1000)))(keys, jnp.asarray(q1), jinit)
    tinit = convert.nuts_kernel_state(
        jax.tree_util.tree_map(np.asarray, jinit))
    tq, tst, tstats = ts.kernel_step(torch.from_numpy(q1), tinit,
                                     TuneContext(True, 250, 1000),
                                     ReplayNoise(keys, 2, max_depth))
    np.testing.assert_array_equal(tstats["depth"].numpy(),
                                  np.asarray(jstats["depth"]))
    np.testing.assert_array_equal(tstats["tree_size"].numpy(),
                                  np.asarray(jstats["tree_size"]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_array_equal(tq.numpy()[:, 0], q1[:, 0])
    assert tst.q.shape == (C, 2)
    np.testing.assert_allclose(tst.logp.numpy(), np.asarray(jst.logp),
                               rtol=1e-4)


def test_q_threads_through_a_compound():
    """A compound's transition is its members' transitions in order on one
    q and one noise stream; a nested compound's statistics are spliced into
    the flat list."""
    mt = _disaster(pt)
    C = 6
    q0 = torch.from_numpy(_disaster_points(C, 2))

    def members():
        return (pt.Metropolis(vars=[mt["switchpoint"]], model=mt),
                pt.NUTS(vars=_rates(mt), model=mt))

    def noise():
        return GeneratorNoise(torch.Generator().manual_seed(9), C, "cpu")
    tctx = TuneContext(True, 0, 10)
    met, nuts = members()
    comp = pt.CompoundStep([met, nuts])
    assert [v.name for v in comp.vars] == ["switchpoint", "early_mean_log__",
                                           "late_mean_log__"]
    q, states, stats = comp.kernel_step(q0, comp.kernel_init(q0), tctx,
                                        noise())
    n = noise()
    met2, nuts2 = members()
    qa, _, sa = met2.kernel_step(q0, met2.kernel_init(q0), tctx, n)
    qb, _, sb = nuts2.kernel_step(qa, nuts2.kernel_init(q0), tctx, n)
    assert (qa[:, 0] != q0[:, 0]).any() and (qa[:, 1:] == q0[:, 1:]).all()
    assert (qb[:, 0] == qa[:, 0]).all() and (qb[:, 1:] != qa[:, 1:]).any()
    np.testing.assert_array_equal(q.numpy(), qb.numpy())
    assert isinstance(stats, list) and len(stats) == 2 and len(states) == 2
    np.testing.assert_array_equal(stats[0]["accepted"].numpy(),
                                  sa["accepted"].numpy())
    np.testing.assert_array_equal(stats[1]["depth"].numpy(),
                                  sb["depth"].numpy())

    nested = pt.CompoundStep([pt.CompoundStep(list(members())),
                              pt.Metropolis(vars=[mt["switchpoint"]],
                                            model=mt)])
    assert len(nested.stats_dtypes) == 3
    _, _, flat = nested.kernel_step(q0, nested.kernel_init(q0), tctx,
                                    noise())
    assert [sorted(s) for s in flat] == \
        [sorted(d) for d in nested.stats_dtypes]
    nested.stop_tuning()
    assert not nested.tune and not nested.methods[1].tune
    assert nested.warnings() == []


@pytest.fixture(scope="module")
def disaster_trace():
    return pt.sample(draws=500, tune=300, chains=8, model=_disaster(pt),
                     random_seed=4, progressbar=False,
                     compute_convergence_checks=False)


def test_disaster_sample_lands_on_the_exact_posterior(disaster_trace):
    """No ``step`` argument: NUTS + Metropolis, 8 chains from the test
    point. Means within 4 MCSE and sds within 20% of the closed form."""
    names = ["switchpoint", "early_mean", "late_mean"]
    exact = disaster_exact_posterior(tdisaster.disasters_data)
    assert int(exact["w"].argmax()) == 41
    assert exact["switchpoint"]["mean"] == pytest.approx(40.003, abs=1e-3)
    assert exact["early_mean"]["mean"] == pytest.approx(3.0662, abs=1e-4)
    assert exact["late_mean"]["mean"] == pytest.approx(0.9361, abs=1e-4)
    ref = {n: {"mean": [exact[n]["mean"]], "sd": [exact[n]["sd"]],
               "mcse": [0.0]} for n in names}
    check = moment_check(posterior_moments(pt, disaster_trace, names), ref)
    assert check["pass"], check
    s = disaster_trace["switchpoint"]
    assert np.all(s == np.round(s)) and 30 <= s.min() and s.max() <= 55
    assert np.bincount(s.astype(int)).argmax() in (40, 41)


def test_trace_has_one_block_of_statistics_per_stepper(disaster_trace):
    tr = disaster_trace
    blocks = tr._straces[0].sampler_vars
    assert [sorted(b) for b in blocks] == \
        [sorted(pt.Metropolis.stats_dtypes[0]),
         sorted(pt.NUTS.stats_dtypes[0])]
    assert tr.nchains == 8 and len(tr) == 500
    assert tr.get_sampler_stats("depth").shape == (4000,)
    assert tr.get_sampler_stats("scaling").shape == (4000,)
    # both steppers report "tune": one column each
    assert tr.get_sampler_stats("tune").shape == (4000, 2)
    assert not tr.get_sampler_stats("tune").any()
    assert 0.2 < tr.get_sampler_stats("accepted").mean() < 0.9
    assert tr.get_sampler_stats("scaling").max() > 1.0


def test_trace_layout_of_a_discrete_variable_matches_jax():
    """The same short compound run in both packages: dtype of the discrete
    variable's trace, variable names and the statistics' blocks."""
    kw = dict(draws=6, tune=6, chains=2, random_seed=1, progressbar=False,
              compute_convergence_checks=False)
    tj = pj.sample(model=_disaster(pj), **kw)
    tt = pt.sample(model=_disaster(pt), record_stats=["accept", "depth"],
                   **kw)
    assert tt["switchpoint"].dtype == tj["switchpoint"].dtype
    assert tt["switchpoint"].shape == tj["switchpoint"].shape == (12,)
    assert sorted(tt.varnames) == sorted(tj.varnames)
    assert [sorted(b) for b in tt._straces[0].sampler_vars] == \
        [["accept"], ["depth", "diverging"]]
    assert tj.stat_names >= {"accept", "depth", "scaling", "diverging"}


@pytest.mark.parametrize("pm", [pj, pt], ids=["jax", "port"])
def test_population_checks_raise_and_warn(pm):
    model = correlated_normal_model(pm, n=4)[0]
    kw = dict(model=model, draws=3, tune=0, progressbar=False,
              compute_convergence_checks=False, random_seed=1)
    with pytest.raises(ValueError, match="at least 3 chains"):
        pm.sample(step=pm.DEMetropolis(model=model), chains=2, **kw)
    with pytest.warns(UserWarning, match="more chains than dimensions"):
        tr = pm.sample(step=pm.DEMetropolis(model=model), chains=4, **kw)
    assert tr["x"].shape == (12, 4) and "lambda" in tr.stat_names


def test_sample_step_arguments():
    mt = _mixed(pt)
    kw = dict(model=mt, draws=4, tune=4, chains=2, progressbar=False,
              compute_convergence_checks=False, random_seed=1)
    tr = pt.sample(metropolis={"scaling": 3.0, "tune": False},
                   step_kwargs={"nuts": {"max_treedepth": 3}}, **kw)
    assert (tr.get_sampler_stats("scaling") == 3.0).all()
    assert tr.get_sampler_stats("depth").max() <= 3
    with pytest.raises(ValueError, match="Unknown step method"):
        pt.sample(step_kwargs={"gibbs": {}}, **kw)
    with pytest.raises(ValueError, match="Unknown keyword"):
        pt.sample(nutz={}, **kw)
    # a list of steppers is compounded; the rest is assigned
    tr = pt.sample(step=[pt.Metropolis(vars=[mt["z"]], model=mt)], **kw)
    assert {"depth", "accepted"} <= tr.stat_names
    with pytest.raises(ValueError, match="continuous"):
        pt.init_nuts(model=mt)
    with pytest.raises(ValueError, match="Bad shape for start"):
        pt.sample(start={"x": np.zeros(3)}, **kw)
    tr = pt.sample(start={"x": 0.5, "z": 4}, **{**kw, "tune": 0, "draws": 1},
                   step=pt.Metropolis(vars=[mt["z"]], model=mt, scaling=0.0,
                                      tune=False))
    assert (tr["z"] == 4).all()


def test_host_side_step_and_tuning_switches():
    mt = _disaster(pt)
    steps = pt.assign_step_methods(mt)
    comp = pt.CompoundStep(steps)
    np.random.seed(3)
    point = dict(mt.test_point)
    for _ in range(3):
        point, stats = comp.step(point)
    assert set(point) == set(mt.test_point)
    assert len(stats) == 2 and "depth" in stats[1] and "accept" in stats[0]
    assert isinstance(stats[1]["depth"], int)
    assert point["switchpoint"] == np.round(point["switchpoint"])
    assert pt.stop_tuning(comp) is comp
    assert not comp.tune and not any(m.tune for m in comp.methods)
    _, stats = comp.step(point)
    assert stats[0]["tune"] is False
    comp.reset_tuning()
    assert all(m._host_state is None for m in comp.methods)
    q = convert.point_to_q(mt, point)
    back = convert.q_to_point(mt, q)
    assert back.keys() == point.keys()
    for k in point:
        np.testing.assert_array_equal(back[k], point[k])
        assert back[k].dtype == np.asarray(point[k]).dtype
