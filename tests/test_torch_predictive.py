"""The slice as a whole: BEST and the 3-component mixture in the port
against the JAX package, and the predictive entry points.

- logp and gradient of both models at 5 seeded points: rtol 1e-4, atol
  1e-4 x max(1, the largest gradient) (float32; the packages sum the
  1000-row mixture likelihood in another order);
- ``sample_prior_predictive`` / ``sample_posterior_predictive`` return the
  JAX package's keys and shapes for int and tuple ``samples``,
  ``keep_size``, ``size`` and ``var_names``, on a fixed trace dict;
- draws come from the seeded generator (same seed, same draws) and line
  up with their trace points.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu_torch.examples.suite import mixture_model
from . import torch_models  # noqa: F401  (asks the port for the CPU)

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
from bench_suite import best_model, mixture_model as jax_mixture_model  # noqa

torch.set_num_threads(2)
RTOL = ATOL = 1e-4


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _pair(name):
    if name == "best":
        return best_model(pj)[0], best_model(pt)[0]
    return jax_mixture_model(pj)[0], mixture_model(pt)[0]


@pytest.mark.parametrize("name", ["best", "mixture"])
def test_model_logp_and_gradient_match_jax(name):
    mj, mt = _pair(name)
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    rng = np.random.RandomState(11)
    q0 = mj.dict_to_array(mj.test_point)
    # small steps keep the mixture's means ordered (its Potential)
    q = (q0[None] + rng.uniform(-0.3, 0.3, (5, q0.size))).astype(np.float32)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert np.all(np.isfinite(np.asarray(lj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=RTOL,
                               atol=ATOL)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=RTOL,
                               atol=ATOL * scale)


def _shapes(d):
    return {k: np.shape(v) for k, v in d.items()}


@pytest.mark.parametrize("name", ["best", "mixture"])
@pytest.mark.parametrize("samples", [7, (2, 3)], ids=["int", "tuple"])
def test_prior_predictive_keys_and_shapes_match_jax(name, samples):
    mj, mt = _pair(name)
    np.random.seed(0)
    want = pj.sample_prior_predictive(samples=samples, model=mj)
    got = pt.sample_prior_predictive(samples=samples, model=mt,
                                     random_seed=0)
    assert _shapes(got) == _shapes(want)
    assert all(np.all(np.isfinite(v)) for v in got.values())
    names = ["w", "x_obs"] if name == "mixture" else ["nu_minus_one", "drug"]
    np.random.seed(0)
    want = pj.sample_prior_predictive(samples=samples, model=mj,
                                      var_names=names)
    got = pt.sample_prior_predictive(samples=samples, model=mt,
                                     var_names=names, random_seed=0)
    assert _shapes(got) == _shapes(want)


def _trace_dict(mj, n=6):
    """A fixed trace: prior draws of every unobserved variable."""
    np.random.seed(1)
    prior = pj.sample_prior_predictive(samples=n, model=mj)
    return {v.name: prior[v.name] for v in mj.unobserved_RVs}


@pytest.mark.parametrize("name", ["best", "mixture"])
def test_posterior_predictive_keys_and_shapes_match_jax(name):
    mj, mt = _pair(name)
    trace = _trace_dict(mj)
    obs = [v.name for v in mj.observed_RVs]
    calls = [dict(), dict(samples=4), dict(samples=9), dict(size=3),
             dict(keep_size=True), dict(var_names=obs[:1] + [
                 mj.deterministics[0].name if mj.deterministics else "mu"])]
    for kw in calls:
        want = pj.sample_posterior_predictive(trace, model=mj,
                                              progressbar=False, **kw)
        got = pt.sample_posterior_predictive(trace, model=mt,
                                             random_seed=2, **kw)
        assert _shapes(got) == _shapes(want), kw
        assert all(np.all(np.isfinite(v)) for v in got.values()), kw


def test_posterior_predictive_draws_follow_their_points():
    """Each row is drawn at its own trace point: y ~ N(mu_i, 0.01)."""
    with pt.Model() as m:
        mu = pt.Normal("mu", 0.0, 10.0)
        pt.Normal("y", mu=mu, sigma=0.01, observed=np.zeros(5))
    mus = np.linspace(-20.0, 20.0, 9).astype(np.float32)
    ppc = pt.sample_posterior_predictive({"mu": mus}, model=m,
                                         random_seed=0, size=2)
    assert ppc["y"].shape == (9, 2, 5)
    np.testing.assert_allclose(ppc["y"].mean(axis=(1, 2)), mus, atol=0.05)


def test_predictive_seeding():
    _, mt = _pair("mixture")
    a = pt.sample_prior_predictive(20, model=mt, random_seed=5)
    b = pt.sample_prior_predictive(20, model=mt, random_seed=5)
    c = pt.sample_prior_predictive(20, model=mt, random_seed=6)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["x_obs"], c["x_obs"])
    # the simplex stays a simplex, and its unconstrained value matches
    np.testing.assert_allclose(a["w"].sum(-1), 1.0, atol=1e-5)
    z = torch.from_numpy(a["w_stickbreaking__"])
    np.testing.assert_allclose(
        pt.transforms.stick_breaking.backward(z).numpy(), a["w"], atol=1e-5)


def test_hierarchical_prior_predictive_is_per_sample():
    """theta ~ N(mu, 0.01) drawn for 400 prior samples of mu: each row
    sits on its own mu (the JAX package draws this shape per sample)."""
    with pt.Model() as m:
        mu = pt.Normal("mu", 0.0, 5.0)
        pt.Normal("theta", mu=mu, sigma=0.01, shape=8)
    prior = pt.sample_prior_predictive(400, model=m, random_seed=3)
    assert prior["theta"].shape == (400, 8)
    np.testing.assert_allclose(prior["theta"].mean(1), prior["mu"],
                               atol=0.02)


def test_sample_posterior_predictive_of_a_multitrace_and_n_init():
    """``sample(n_init=...)`` is accepted (as in the JAX package), and the
    predictive keeps (chains, draws) with keep_size."""
    mt = best_model(pt)[0]
    tr = pt.sample(draws=10, tune=10, chains=2, model=mt, n_init=1000,
                   random_seed=1, progressbar=False,
                   compute_convergence_checks=False)
    ppc = pt.sample_posterior_predictive(tr, model=mt, keep_size=True,
                                         random_seed=1)
    assert _shapes(ppc) == {"drug": (2, 10, 47), "placebo": (2, 10, 42)}
    w = pt.sample_posterior_predictive_w([tr, tr], models=[mt, mt],
                                         samples=12, random_seed=0)
    assert w["drug"].shape == (12, 47)
