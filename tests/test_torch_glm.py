"""The port's GLM module against the JAX package's, on the same inputs.

- ``design_matrices`` gives the same X and labels for ``y ~ x``, ``y ~ 0 +
  x``, ``C(g)``, ``a*a`` and the radon formula (exactly: the same numpy
  code path in both).
- A dict of numpy arrays builds a GLM with pandas hidden.
- ``GLM.from_formula`` for all five families and ``LinearComponent`` with
  a ``priors`` dict: the same free variables, and logp and gradient at a
  few points (through ``convert.point_to_q``) within rtol 1e-4, atol 1e-4 x
  the largest gradient, as the port's other model tests (float32 sums over
  the rows in another order).
- The unpooled radon GLM, whose 85 regressors share one prior object: the
  model evaluates that prior once on the stacked coefficients
  (``Model._logp_plan``), with the same logp and gradient.
"""
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.glm.utils import design_matrices as jdesign
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.examples.radon import load_radon_columns
from pymc3_tpu_torch.glm.utils import (any_to_tensor_and_labels,
                                       design_matrices as tdesign)
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _data(n=40, seed=10):
    rng = np.random.RandomState(seed)
    x = np.linspace(-1, 1, n)
    a = rng.normal(size=n)
    g = np.array(["u", "v", "w"])[rng.randint(0, 3, n)]
    mu = 0.5 + 1.5 * x - 0.4 * a
    return {"x": x, "a": a, "g": g, "y": mu + 0.3 * rng.normal(size=n),
            "k": rng.poisson(np.exp(0.3 * mu)).astype(float),
            "b": (rng.uniform(size=n) < 1 / (1 + np.exp(-mu))).astype(
                float)}


@pytest.mark.parametrize("formula", [
    "y ~ x", "y ~ 0 + x", "y ~ a + C(g)", "y ~ a * a", "y ~ x * a",
    "log_radon ~ floor + C(county)"])
def test_design_matrices_match(formula):
    data = load_radon_columns() if "radon" in formula else _data()
    yt, Xt, lt = tdesign(formula, data)
    yj, Xj, lj = jdesign(formula, data)
    assert lt == lj
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(yt, yj)
    if "county" in formula:
        assert Xt.shape == (919, 86)


def test_dict_input_without_pandas(monkeypatch):
    monkeypatch.setitem(sys.modules, "pandas", None)
    data = _data()
    x, labels = any_to_tensor_and_labels({"x": data["x"], "a": data["a"]})
    assert labels == ["x", "a"] and x.shape == (40, 2)
    with pt.Model() as model:
        pt.GLM.from_formula("y ~ x + C(g)", data)
    assert [v.name for v in model.free_RVs] == [
        "Intercept", "x", "C(g)[T.v]", "C(g)[T.w]", "sd_log__"]
    assert np.isfinite(model.check_test_point()["y"])


def _points(model, n=3, seed=2, scale=0.2):
    rng = np.random.RandomState(seed)
    q0 = model.dict_to_array(model.test_point)
    return (q0 + scale * rng.randn(n, q0.size)).astype(np.float32)


def _logp_grad_match(mj, mt):
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    q = _points(mt)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert np.all(np.isfinite(np.asarray(lj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4 * scale)


FAMILIES = {"normal": "y ~ x + a", "student": "y ~ x + C(g)",
            "binomial": "b ~ x", "poisson": "k ~ x + a",
            "negative_binomial": "k ~ x"}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_glm_family_logp_grad(family):
    def build(pm):
        with pm.Model() as model:
            pm.GLM.from_formula(FAMILIES[family], _data(), family=family)
        return model
    _logp_grad_match(build(pj), build(pt))


def test_linear_component_with_priors():
    def build(pm):
        data = _data()
        with pm.Model() as model:
            lc = pm.LinearComponent(
                np.column_stack([data["x"], data["a"]]), data["y"],
                labels=["x", "a"], priors={
                    "Intercept": pm.Normal.dist(mu=0.0, sigma=5.0),
                    "Regressor": pm.Laplace.dist(mu=0.0, b=2.0),
                    "a": pm.StudentT.dist(nu=4.0, mu=0.0, sigma=1.0)})
            sigma = pm.HalfCauchy("sigma", 5)
            pm.Normal("obs", mu=lc.y_est, sigma=sigma,
                      observed=data["y"].astype(np.float32))
        return model
    mt = build(pt)
    assert [v.name for v in mt.free_RVs] == ["Intercept", "x", "a",
                                             "sigma_log__"]
    _logp_grad_match(build(pj), mt)


def test_named_glm_and_family_object():
    """A prefixed GLM with a family instance whose prior is overridden."""
    def build(pm):
        with pm.Model() as model:
            fam = pm.glm.families.StudentT(
                priors={"nu": 3.0, "lam": pm.Gamma.dist(alpha=2.0, beta=1.0)})
            pm.GLM.from_formula("y ~ x", _data(), family=fam, name="m")
        return model
    mt = build(pt)
    assert [v.name for v in mt.free_RVs] == [
        "m_Intercept", "m_x", "m_lam_log__"]
    _logp_grad_match(build(pj), mt)


def test_shared_prior_is_one_logp_call():
    """The unpooled radon GLM's 85 regressors share their default prior:
    the port evaluates it once on the stacked coefficients, and the model's
    logp and gradient stay the JAX package's."""
    from pymc3_tpu_torch.examples.suite import glm_radon_unpooled
    mt = glm_radon_unpooled(pt)[0]
    groups = [item for item in mt._logp_plan() if isinstance(item, tuple)]
    assert [len(rvs) for _, rvs in groups] == [85]
    assert [rv.name for rv in groups[0][1]][:2] == ["floor",
                                                    "C(county)[T.ANOKA]"]
    _logp_grad_match(glm_radon_unpooled(pj)[0], mt)


def test_consecutive_scalars_are_one_slice(monkeypatch):
    """The unpooled GLM's coefficients are consecutive scalars of the flat
    point: the prior group and the linear predictor take them as one slice
    of it (``model.stack_scalars``), with bit for bit the logp and gradient
    of stacking them one by one."""
    from pymc3_tpu_torch import model as tmodel
    from pymc3_tpu_torch.examples.suite import glm_radon_unpooled
    from pymc3_tpu_torch.node import _ev
    mt = glm_radon_unpooled(pt)[0]
    rng = np.random.RandomState(3)
    q0 = mt.dict_to_array(mt.test_point)
    q = torch.as_tensor((q0 + 0.3 * rng.randn(4, q0.size)).astype(np.float32))
    sliced = []
    fast, stack = tmodel.stack_scalars, torch.stack

    def spy(nodes, env, memo):
        stacked = []
        with monkeypatch.context() as m:
            m.setattr(torch, "stack", lambda *a, **k: stacked.append(1)
                      or stack(*a, **k))
            out = fast(nodes, env, memo)
        sliced.append(len(nodes) > 1 and not stacked)
        return out
    monkeypatch.setattr(tmodel, "stack_scalars", spy)
    got = [x.numpy() for x in mt.logp_dlogp_function()(q)]
    assert sliced == [True, True]
    monkeypatch.setattr(tmodel, "stack_scalars", lambda nodes, env, memo:
                        torch.stack([tmodel._scalar(_ev(n, env, memo))
                                     for n in nodes]))
    want = [x.numpy() for x in mt.logp_dlogp_function()(q)]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_start_points_build_the_ordering_once(monkeypatch):
    """Completing a chain's start point builds the model's ordering once,
    not once for each of the unpooled GLM's 87 variables (256 chains
    started from points spent most of a sampling run there)."""
    from pymc3_tpu_torch import blocking, sampling
    from pymc3_tpu_torch.examples.suite import glm_radon_unpooled
    mt = glm_radon_unpooled(pt)[0]
    point = dict(mt.test_point)
    built = []
    init = blocking.ArrayOrdering.__init__

    def counting(self, vars):
        built.append(1)
        init(self, vars)
    monkeypatch.setattr(blocking.ArrayOrdering, "__init__", counting)
    out = sampling._complete_point(mt, point)
    assert len(built) == 1
    assert list(out) == [rv.name for rv in mt.free_RVs]
