"""``Slice`` and ``HamiltonianMC`` of the port.

Both recover a normal's mean and sd (means within 4 Monte-Carlo standard
errors, sds within 10%); one ``HamiltonianMC`` transition on the JAX
package's momentum and acceptance uniform equals the JAX transition (q
within 1e-4: up to 16 leapfrog steps in float32), full and over a subset of
the flat vector; ``Slice``'s caps on stepping out and shrinking hold.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.step_methods.arraystep import GeneratorNoise, TuneContext

from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
MEAN, SD = np.array([1.0, -2.0]), np.array([2.0, 0.5])


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _normal_model(pm):
    with pm.Model() as model:
        pm.Normal("x", mu=MEAN, sigma=SD, shape=2)
    return model


def _mixed_model(pm):
    with pm.Model() as model:
        x = pm.Normal("x", 0.5, 1.5, shape=3)
        k = pm.Poisson("k", 3.0)
        pm.Normal("y", mu=x.sum() + 0.3 * k, sigma=1.0,
                  observed=np.array([2.0, 3.5]))
    return model


@pytest.mark.parametrize("stepper,kwargs,stat", [
    ("Slice", {}, "nstep_out"),
    ("HamiltonianMC", {"path_length": 1.5}, "n_steps"),
], ids=["slice", "hmc"])
def test_recovers_a_normal(stepper, kwargs, stat):
    model = _normal_model(pt)
    step = getattr(pt, stepper)(model=model, **kwargs)
    tr = pt.sample(draws=400, tune=300, chains=16, model=model, step=step,
                   random_seed=6, progressbar=False,
                   compute_convergence_checks=False)
    assert set(tr.stat_names) == set(getattr(pt, stepper).stats_dtypes[0])
    assert tr.get_sampler_stats(stat).min() >= (0 if stepper == "Slice"
                                                else 1)
    x = tr["x"].astype(np.float64)
    ess = np.asarray(pt.ess(tr, var_names=["x"])["x"])
    assert np.all(ess > 400)
    z = np.abs(x.mean(0) - MEAN) / (x.std(0) / np.sqrt(ess))
    assert np.all(z < 4), z
    np.testing.assert_allclose(x.std(0), SD, rtol=0.1)
    assert float(np.max(pt.rhat(tr, var_names=["x"])["x"])) < 1.05


@pytest.mark.parametrize("partial", [False, True], ids=["full", "partial"])
def test_hmc_transition_on_identical_noise(partial):
    build = _mixed_model if partial else _normal_model
    mj, mt = build(pj), build(pt)
    kw = dict(path_length=0.8, max_steps=16)
    js = pj.HamiltonianMC(vars=[mj["x"]], model=mj, **kw)
    ts = pt.HamiltonianMC(vars=[mt["x"]], model=mt, **kw)
    assert ts.is_partial == partial and ts.dim == js.dim
    assert ts.step_size == pytest.approx(js.step_size)
    C = 5
    rng = np.random.RandomState(2)
    q0 = np.tile(mt.dict_to_array(mt.test_point), (C, 1))
    q0[:, :ts.dim] += rng.uniform(-0.5, 0.5, (C, ts.dim))
    q0 = q0.astype(np.float32)
    jinit = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    # chains at different step sizes: different step counts in one batch
    eps = np.array([0.05, 0.11, 0.2, 0.33, 0.8], np.float32)
    jinit = jinit._replace(da=jinit.da._replace(
        log_step=jnp.log(jnp.asarray(eps))))
    q1 = q0.copy()
    if partial:
        q1[:, -1] += np.array([1, 0, -2, 3, 0], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(8), C)
    jq, jst, jstats = jax.vmap(
        lambda k, q, s: js.kernel_step(
            k, q, s, JaxTune(jnp.asarray(True), jnp.asarray(3, jnp.int32),
                             100)))(keys, jnp.asarray(q1), jinit)

    class Noise:
        def normal(self, dim):
            return torch.from_numpy(np.stack([np.asarray(jax.random.normal(
                jax.random.split(k)[0], (dim,), jnp.float32)) for k in keys]))

        def uniform(self, dim=None):
            return torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                jax.random.split(k)[1], (), jnp.float32)) for k in keys]))
    tinit = convert.nuts_kernel_state(
        jax.tree_util.tree_map(np.asarray, jinit))
    tq, tst, tstats = ts.kernel_step(torch.from_numpy(q1), tinit,
                                     TuneContext(True, 3, 100), Noise())
    np.testing.assert_array_equal(tstats["n_steps"].numpy(),
                                  np.asarray(jstats["n_steps"]))
    assert len(set(tstats["n_steps"].tolist())) >= 4
    np.testing.assert_array_equal(tstats["accepted"].numpy(),
                                  np.asarray(jstats["accepted"]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tstats["energy_error"].numpy(),
                               np.asarray(jstats["energy_error"]),
                               rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(tst.da.log_step.numpy(),
                               np.asarray(jst.da.log_step), rtol=1e-4)
    np.testing.assert_allclose(tst.pot.var.numpy(), np.asarray(jst.pot.var),
                               rtol=1e-4)
    if partial:
        np.testing.assert_array_equal(tq.numpy()[:, -1], q1[:, -1])


def _noise(chains, seed=0):
    return GeneratorNoise(torch.Generator().manual_seed(seed), chains, "cpu")


def test_slice_step_out_cap_holds():
    """On a flat density every bracket grows until the cap stops it:
    ``max_steps`` steps a side, the first shrinkage draw accepted."""
    with pt.Model() as model:
        pt.Flat("x", shape=2)
    step = pt.Slice(model=model, w=0.5, max_steps=4, blocked=True)
    q0 = torch.zeros(6, 2)
    calls = [0]
    logp_fn = step._logp_fn

    def counted(q):
        calls[0] += 1
        return logp_fn(q)
    step._logp_fn = counted
    state = step.kernel_init(q0)
    q, new, stats = step.kernel_step(q0, state, TuneContext(True, 0, 5),
                                     _noise(6))
    assert (stats["nstep_out"] == 2 * 2 * 4).all()
    assert (stats["nstep_in"] == 2).all()
    # bracket of width w (1 + 2 * max_steps) around the start
    assert q.abs().max() <= 0.5 * 9
    assert torch.isfinite(q).all() and (q != q0).all()
    # per coordinate: 5 turns of two calls stepping out, one draw in
    assert calls[0] == 1 + 2 * (2 * 5 + 1)
    # tuned widths: 0.9 w + 0.1 of the bracket
    np.testing.assert_allclose(new.w.numpy(), 0.9 * 0.5 + 0.1 * 4.5,
                               rtol=1e-5)
    assert new.n_tunes == 1
    _, off, _ = step.kernel_step(q0, state, TuneContext(False, 0, 0),
                                 _noise(6))
    assert (off.w == 0.5).all()


def test_slice_shrink_cap_holds_and_keeps_the_point():
    """A density that is finite at one point only: nothing steps out, every
    shrinkage draw misses, and after ``2 * max_steps`` of them the chain
    stays where it was."""
    with pt.Model() as model:
        x = pt.Flat("x")
        pt.Potential("spike", pt.node.apply(
            lambda v: torch.where(v == 0.25, 0.0, -torch.inf), x))
    step = pt.Slice(model=model, max_steps=3)
    q0 = torch.full((4, 1), 0.25)
    q, new, stats = step.kernel_step(q0, step.kernel_init(q0),
                                     TuneContext(True, 0, 5), _noise(4, 1))
    assert (q == q0).all() and (new.logp == 0).all()
    assert (stats["nstep_out"] == 0).all()
    assert (stats["nstep_in"] == 6).all()


def test_slice_moves_only_its_own_columns_and_lanes_finish_apart():
    mt = _mixed_model(pt)
    step = pt.Slice(vars=[mt["x"]], model=mt, blocked=True)
    assert step.is_partial and step.max_steps == 64
    assert pt.Slice(vars=[mt["x"]], model=mt, iter_limit=5).max_steps == 5
    q0 = torch.as_tensor(np.tile(mt.dict_to_array(mt.test_point), (8, 1)))
    q, _, stats = step.kernel_step(q0, step.kernel_init(q0),
                                   TuneContext(True, 0, 5), _noise(8, 2))
    assert (q[:, 3] == q0[:, 3]).all() and (q[:, :3] != q0[:, :3]).all()
    assert len(set(stats["nstep_in"].tolist())) > 1
