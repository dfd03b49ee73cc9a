"""Missing-value imputation in the port against the JAX package
(``pymc3_tpu/model.py:236-320``), on the CPU.

Masked and NaN-holding data under Normal, Bernoulli and Poisson: the
``name_missing`` free variables (names, shapes, test values), the
``ImputationWarning``, logp and its gradient at seeded points (rtol 1e-5
in float32, as the examples' tests), and the step methods that
``assign_step_methods`` gives each variable.
"""
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu.sampling import assign_step_methods as jassign
from pymc3_tpu_torch.sampling import assign_step_methods as tassign
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _data(family, missing):
    """Twelve values of ``family`` as a (3, 4) array, four of them missing,
    as a masked array or as NaN."""
    rng = np.random.RandomState(3)
    values = {"normal": rng.normal(1.0, 2.0, 12),
              "bernoulli": rng.binomial(1, 0.3, 12).astype(float),
              "poisson": rng.poisson(2.5, 12).astype(float)}[family]
    values = values.reshape(3, 4)
    mask = np.zeros((3, 4), bool)
    mask[[0, 1, 1, 2], [1, 0, 3, 2]] = True
    if missing == "masked":
        return np.ma.masked_array(np.where(mask, -999.0, values), mask=mask)
    return np.where(mask, np.nan, values)


def _model(pm, family, missing):
    data = _data(family, missing)
    with pm.Model() as model:
        if family == "normal":
            mu = pm.Normal("mu", 0.0, 3.0)
            sd = pm.HalfNormal("sd", 2.0)
            obs = pm.Normal("obs", mu, sd, observed=data)
        elif family == "bernoulli":
            p = pm.Beta("p", 1.0, 1.0)
            obs = pm.Bernoulli("obs", p, observed=data)
        else:
            lam = pm.Exponential("lam", 1.0)
            obs = pm.Poisson("obs", lam, observed=data)
        # a downstream use of the imputed data, as lasso_missing's predictors
        w = pm.Normal("w", 0.0, 1.0)
        pm.Normal("z", w * obs, 1.0,
                  observed=np.linspace(-1, 1, 12).reshape(3, 4))
    return model


CASES = [(f, m) for f in ("normal", "bernoulli", "poisson")
         for m in ("masked", "nan")]


@pytest.mark.parametrize("family,missing", CASES)
def test_missing_values_become_free_variables(family, missing):
    with pytest.warns(pt.ImputationWarning, match="obs contains missing"):
        mt = _model(pt, family, missing)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mj = _model(pj, family, missing)
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    assert [v.name for v in mt.missing_values] == ["obs_missing"]
    assert mt["obs_missing"] is mt.missing_values[0]
    assert mt["obs"].missing_values is mt["obs_missing"]
    dist = mt["obs_missing"].distribution
    assert type(dist).__name__ == "NoDistribution"
    assert dist.parent_dist is mt["obs"].distribution
    assert mt["obs_missing"].test_value.shape == (4,)
    np.testing.assert_allclose(mt.test_point["obs_missing"],
                               mj.test_point["obs_missing"])
    for name in mj.test_point:
        np.testing.assert_allclose(mt.test_point[name], mj.test_point[name])


@pytest.mark.parametrize("family,missing", CASES)
def test_imputed_logp_and_gradient_match_jax(family, missing):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt, mj = _model(pt, family, missing), _model(pj, family, missing)
    rng = np.random.RandomState(CASES.index((family, missing)))
    q0 = mj.dict_to_array(mj.test_point).astype(np.float64)
    miss = mj.ordering.by_name["obs_missing"].slc
    rows = []
    for _ in range(3):
        q = q0 + 0.3 * rng.randn(q0.size)
        q[miss] = (rng.randint(0, 2, 4) if family == "bernoulli"
                   else rng.randint(0, 6, 4) if family == "poisson"
                   else q[miss])
        rows.append(q)
    q = np.stack(rows).astype(np.float32)
    vag = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))
    lj, gj = (np.asarray(a) for a in vag(jnp.asarray(q)))
    lt, gt = (a.numpy() for a in mt.logp_dlogp_function()(
        torch.from_numpy(q)))
    np.testing.assert_allclose(lt, lj, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(lj).max()))
    np.testing.assert_allclose(gt, gj, rtol=RTOL,
                               atol=RTOL * max(1.0, np.abs(gj).max()))


@pytest.mark.parametrize("family,missing", CASES)
def test_imputed_values_are_scattered_into_the_data(family, missing):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt = _model(pt, family, missing)
    data = np.ma.masked_invalid(_data(family, missing))
    point = dict(mt.test_point, obs_missing=np.array([7.0, 8.0, 9.0, 5.0],
                                                     np.float32))
    (value,) = mt.makefn([mt["obs"]])(point)
    want = np.asarray(data.filled(0.0), np.float32)
    want[np.ma.getmaskarray(data)] = [7.0, 8.0, 9.0, 5.0]
    np.testing.assert_array_equal(np.asarray(value), want)


@pytest.mark.parametrize("family,missing", CASES)
def test_steppers_assigned_as_the_jax_package(family, missing):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        mt, mj = _model(pt, family, missing), _model(pj, family, missing)

    def by_var(step):
        steps = step if isinstance(step, list) else [step]
        return {v.name: type(s).__name__ for s in steps for v in s.vars}
    assigned = by_var(tassign(mt))
    assert assigned == by_var(jassign(mj))
    want = {"normal": "NUTS", "bernoulli": "BinaryGibbsMetropolis",
            "poisson": "Metropolis"}[family]
    assert assigned["obs_missing"] == want


def test_imputed_model_samples():
    """A short ``sample()`` of the Poisson case: NUTS compounds with
    Metropolis over the imputed counts, which stay non-negative integers."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = _model(pt, "poisson", "nan")
    with model:
        trace = pt.sample(draws=30, tune=30, chains=2, progressbar=False,
                          random_seed=2, compute_convergence_checks=False)
    imputed = np.asarray(trace["obs_missing"])
    assert imputed.shape == (60, 4)
    assert np.all(imputed >= 0) and np.all(imputed == np.round(imputed))
