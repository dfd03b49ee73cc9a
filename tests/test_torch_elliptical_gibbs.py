"""``EllipticalSlice``, ``ElemwiseCategorical`` and ``Model.datalogpt_fn``
of the port against the JAX package.

- One elliptical-slice transition of 6 chains on the random numbers the JAX
  transition draws (its key splits replayed with ``jax.random``): the next
  ``q`` and log-likelihood within rtol = atol = 1e-4 (float32; a few
  shrinks of an angle, each a cos/sin of it).
- One categorical Gibbs scan of 6 chains over 4 labels on the JAX scan's
  Gumbel draws: the same labels, exactly.
- ``datalogpt_fn`` at random points: rtol 1e-5.
- Short CPU runs: the elliptical slice sampler on a latent Gaussian
  process of 8 inputs against its exact posterior (means within 4
  Monte-Carlo standard errors, sds within 10%), and the labelling model of
  ``examples/suite.py`` under ``[ElemwiseCategorical, Metropolis]`` (the
  GPU run compounds it with NUTS) against its label marginals by
  enumeration (each within 4 standard errors).
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
from pymc3_tpu_torch.examples import suite
from pymc3_tpu_torch.step_methods.arraystep import TuneContext

from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
N_GP = 8
NOISE = 0.3


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _gp_data():
    X = np.linspace(0.0, 1.0, N_GP)
    K = np.exp(-0.5 * ((X[:, None] - X[None, :]) / 0.3) ** 2) \
        + 1e-4 * np.eye(N_GP)
    y = np.sin(2 * np.pi * X) + NOISE * np.random.RandomState(0).randn(N_GP)
    return K.astype(np.float32), y.astype(np.float32)


def _latent_gp(pm):
    K, y = _gp_data()
    with pm.Model() as model:
        f = pm.MvNormal("f", mu=np.zeros(N_GP), cov=K, shape=N_GP)
        s = pm.HalfNormal("s", sigma=1.0)
        pm.Normal("y", mu=f, sigma=NOISE, observed=y)
        pm.Potential("p", -0.5 * s ** 2)
    return model


def _points(model, C, seed):
    rng = np.random.RandomState(seed)
    q0 = model.dict_to_array(model.test_point)
    return (q0[None] + rng.uniform(-1, 1, (C, q0.size))).astype(np.float32)


def test_datalogpt_fn_matches_jax():
    mj, mt = _latent_gp(pj), _latent_gp(pt)
    q = _points(mt, 5, 1)
    want = np.asarray(jax.vmap(mj.datalogpt_fn())(jnp.asarray(q)))
    got = mt.datalogpt_fn()(torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5)


class _ESReplay:
    """The JAX transition's draws (``elliptical_slice.py:63-92``): ``nu``'s
    normal, the slice level's and the first angle's uniforms, then one
    uniform per shrink."""

    def __init__(self, keys, dim, max_steps):
        self.z, self.u = [], []
        for key in keys:
            k_nu, k_y, k_theta, k = jax.random.split(key, 4)
            self.z.append(np.asarray(jax.random.normal(k_nu, (dim,),
                                                       jnp.float32)))
            us = [jax.random.uniform(k_y, (), jnp.float32),
                  jax.random.uniform(k_theta, (), jnp.float32)]
            for _ in range(max_steps):
                k, ku = jax.random.split(k)
                us.append(jax.random.uniform(ku, (), jnp.float32))
            self.u.append(np.asarray(us, np.float32))
        self.calls = 0

    def normal(self, dim):
        return torch.from_numpy(np.stack(self.z))

    def uniform(self, dim=None):
        self.calls += 1
        return torch.from_numpy(np.stack([u[self.calls - 1]
                                          for u in self.u]))


def test_one_elliptical_slice_transition_on_replayed_draws():
    mj, mt = _latent_gp(pj), _latent_gp(pt)
    K, _ = _gp_data()
    js = pj.EllipticalSlice(vars=[mj["f"]], prior_cov=K, model=mj)
    ts = pt.EllipticalSlice(vars=[mt["f"]], prior_cov=K, model=mt)
    assert ts.dim == js.dim == N_GP and ts.is_partial
    C = 6
    q0 = _points(mt, C, 2)
    q0[:, N_GP:] = 0.0
    jinit = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    tctx = JaxTune(jnp.asarray(False), jnp.asarray(0, jnp.int32), 0)
    jq, jst, _ = jax.jit(jax.vmap(
        lambda k, q, s: js.kernel_step(k, q, s, tctx)))(
            keys, jnp.asarray(q0), jinit)
    tinit = convert.es_state(jax.tree_util.tree_map(np.asarray, jinit))
    noise = _ESReplay(keys, N_GP, ts.max_steps)
    tq, tst, _ = ts.kernel_step(torch.from_numpy(q0), tinit,
                                TuneContext(False, 0, 0), noise)
    assert noise.calls >= 4   # some lane shrank its bracket at least twice
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tst.loglik.numpy(), np.asarray(jst.loglik),
                               rtol=1e-4, atol=1e-4)
    assert not np.allclose(tq.numpy()[:, :N_GP], q0[:, :N_GP])
    np.testing.assert_array_equal(tq.numpy()[:, N_GP:], q0[:, N_GP:])


def _label_pair():
    def build(pm):
        with pm.Model() as model:
            z = pm.Categorical("z", p=np.array([0.2, 0.3, 0.5]), shape=4)
            pm.Normal("y", mu=-1.5 + 1.5 * z, sigma=1.0,
                      observed=np.array([-1.0, 0.3, 2.0, 0.9]))
        return model
    return build(pj), build(pt)


def test_one_categorical_gibbs_scan_on_replayed_gumbels():
    mj, mt = _label_pair()
    js = pj.ElemwiseCategorical([mj["z"]], model=mj)
    ts = pt.ElemwiseCategorical([mt["z"]], model=mt)
    assert ts.k == js.k == 3
    C = 6
    q0 = np.random.RandomState(4).randint(0, 3, (C, 4)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), C)
    tctx = JaxTune(jnp.asarray(False), jnp.asarray(0, jnp.int32), 0)
    jinit = jax.vmap(js.kernel_init)(jnp.asarray(q0))
    jq, _, _ = jax.vmap(lambda k, q, s: js.kernel_step(k, q, s, tctx))(
        keys, jnp.asarray(q0), jinit)

    gumbels = []
    for key in keys:
        rows = []
        for _ in range(4):
            key, kc = jax.random.split(key)
            rows.append(np.asarray(jax.random.gumbel(kc, (3,), jnp.float32)))
        gumbels.append(rows)

    class Noise:
        calls = 0

        def gumbel(self, k):
            self.calls += 1
            return torch.from_numpy(np.stack([g[self.calls - 1]
                                              for g in gumbels]))
    tq, _, _ = ts.kernel_step(torch.from_numpy(q0), ts.kernel_init(
        torch.from_numpy(q0)), TuneContext(False, 0, 0), Noise())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert not np.array_equal(tq.numpy(), q0)


def test_elliptical_slice_lands_on_the_exact_posterior():
    K, y = _gp_data()
    with pt.Model() as model:
        f = pt.MvNormal("f", mu=np.zeros(N_GP), cov=K, shape=N_GP)
        pt.Normal("y", mu=f, sigma=NOISE, observed=y)
    step = pt.EllipticalSlice(vars=[f], prior_cov=K, model=model)
    tr = pt.sample(draws=600, tune=200, chains=32, model=model, step=step,
                   random_seed=6, progressbar=False,
                   compute_convergence_checks=False)
    Kd = K.astype(np.float64)
    A = Kd + NOISE ** 2 * np.eye(N_GP)
    mean = Kd @ np.linalg.solve(A, y.astype(np.float64))
    sd = np.sqrt(np.diag(Kd - Kd @ np.linalg.solve(A, Kd)))
    x = tr["f"].astype(np.float64)
    ess = np.asarray(pt.ess(tr, var_names=["f"])["f"])
    z = np.abs(x.mean(0) - mean) / (x.std(0) / np.sqrt(ess))
    assert np.all(z < 4), z
    np.testing.assert_allclose(x.std(0), sd, rtol=0.1)


def test_categorical_gibbs_lands_on_the_label_marginals():
    model = suite.label_model(pt)
    step = [pt.ElemwiseCategorical([model["z"]], model=model),
            pt.Metropolis([model["w"]], model=model)]
    tr = pt.sample(draws=100, tune=30, chains=256, model=model, step=step,
                   random_seed=7, progressbar=False,
                   compute_convergence_checks=False)
    z = tr["z"].astype(np.int64)
    want = suite.label_exact_marginals()
    ess = np.asarray(pt.ess(tr, var_names=["z"])["z"])
    for k in range(3):
        got = (z == k).mean(0)
        se = np.sqrt(want[:, k] * (1 - want[:, k]) / ess)
        assert np.all(np.abs(got - want[:, k]) < 4 * se), (k, got,
                                                           want[:, k])
