"""The port's model-core surface against the JAX package's on the CPU.

Each case builds one model in both packages from the same seeded numpy
values and compares what the JAX package returns with the port's answer:
the operators and tensor methods of a ``Node`` (through a
``Deterministic``), each factor's ``logp`` and the model's ``dlogp``,
``logp_elemwise`` and functions, ``coords``/``dims`` through to
InferenceData, ``ValueGradFunction``'s flat maps and ``grad_vars``
subsets, the package's exports, and ``generate_samples`` with a host
generator. Tolerance: rtol 1e-5, atol 1e-5 for float32 values (one op
each), 1e-4 for sums over a model's terms; integer and boolean results and
shapes are compared exactly.
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt

from . import torch_models  # noqa: F401  (the port on the CPU)

TOL = dict(rtol=1e-5, atol=1e-5)
SUM_TOL = dict(rtol=1e-4, atol=1e-4)


def _x_model(pm):
    with pm.Model() as model:
        pm.Normal("x", 0.0, 1.0, shape=(3, 4))
    return model


X_POINT = {"x": np.random.RandomState(0).randn(3, 4).astype(np.float32)
           * 2.0}

# (id, expression of the node x): every operator and method of queue 3,
# fault 1, with numpy's semantics where torch's differ (population sd,
# axis=None over everything, // and % with the divisor's sign, .T reversing
# all axes and leaving a vector alone)
NODE_CASES = [
    ("floordiv", lambda x: x // 2),
    ("floordiv_neg", lambda x: x // -1.5),
    ("rfloordiv", lambda x: 7.0 // (x + 10.0)),
    ("mod", lambda x: x % 1.5),
    ("mod_neg_divisor", lambda x: x % -1.5),
    ("rmod", lambda x: -7.0 % (x + 10.0)),
    ("invert", lambda x: ~(x > 0)),
    ("max", lambda x: x.max()),
    ("max_axis", lambda x: x.max(axis=0)),
    ("max_keepdims", lambda x: x.max(axis=1, keepdims=True)),
    ("max_all_keepdims", lambda x: x.max(keepdims=True)),
    ("min", lambda x: x.min()),
    ("min_axes", lambda x: x.min(axis=(0, 1))),
    ("prod", lambda x: x.prod()),
    ("prod_axis", lambda x: x.prod(axis=1)),
    ("prod_axes", lambda x: x.prod(axis=(0, 1), keepdims=True)),
    ("std", lambda x: x.std()),
    ("std_axis", lambda x: x.std(axis=0)),
    ("std_keepdims", lambda x: x.std(axis=1, keepdims=True)),
    ("cumsum", lambda x: x.cumsum()),
    ("cumsum_axis", lambda x: x.cumsum(axis=1)),
    ("clip", lambda x: x.clip(-0.5, 0.5)),
    ("clip_upper", lambda x: x.clip(-10.0, 0.2)),
    ("clip_node", lambda x: x.clip(x[0], 1.0)),
    ("squeeze", lambda x: x.reshape(1, 3, 1, 4).squeeze()),
    ("squeeze_axis", lambda x: x.reshape(1, 12).squeeze(0)),
    ("astype_float", lambda x: (x > 0).astype("float32")),
    ("astype_int", lambda x: x.astype("int32")),
    ("transpose", lambda x: x.transpose()),
    ("transpose_axes", lambda x: x.transpose(1, 0)),
    ("transpose_3d", lambda x: x.reshape(2, 3, 2).transpose(2, 0, 1)),
    ("T", lambda x: x.T),
    ("T_vector", lambda x: x[0].T),
    ("T_3d", lambda x: x.reshape(2, 3, 2).T),
    ("eq", lambda x: x.eq(x[0])),
    ("neq", lambda x: x.neq(0.0)),
    ("composite", lambda x: (x.max() - x.min()) / x.std()),
]


@pytest.mark.parametrize("make", [c[1] for c in NODE_CASES],
                         ids=[c[0] for c in NODE_CASES])
def test_node_operator_through_a_deterministic(make):
    out = []
    for pm in (pj, pt):
        with _x_model(pm) as model:
            det = pm.Deterministic("d", make(model["x"]))
        out.append((model.makefn(det)(X_POINT), det.test_value))
    (want, want_tv), (got, got_tv) = out
    assert got.shape == want.shape
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, **TOL)
    np.testing.assert_allclose(got_tv, want_tv, **TOL)


def test_node_methods_run_under_vmap_in_forward_draws():
    """A deterministic of ``max``/``min``/``std``/``//``/``%`` is
    evaluated at every prior draw under ``torch.func.vmap``."""
    with pt.Model():
        x = pt.Normal("x", 0.0, 1.0, shape=6)
        pt.Deterministic("r", x.max() - x.min())
        pt.Deterministic("s", x.std(axis=0))
        pt.Deterministic("m", (x * 3) // 1 + x % 0.5)
        prior = pt.sample_prior_predictive(samples=7, random_seed=2)
    x = prior["x"]
    np.testing.assert_allclose(prior["r"], x.max(1) - x.min(1), **TOL)
    np.testing.assert_allclose(prior["s"], x.std(1), **TOL)
    np.testing.assert_allclose(prior["m"], (x * 3) // 1 + x % 0.5, **TOL)


def test_node_tag_is_the_node():
    model = _x_model(pt)
    x = model["x"]
    assert x.tag is x
    np.testing.assert_array_equal(x.tag.test_value, x.test_value)


# -- per-variable logp and draws (fault 2) ------------------------------------
def _mixed(pm, density_dist=True):
    """Free, transformed, observed and (unless ``density_dist`` is false)
    dict-observed factors."""
    rng = np.random.RandomState(4)
    y = rng.randn(12).astype(np.float32)
    obs = rng.randn(5).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 2.0)
        sigma = pm.HalfNormal("sigma", 1.5)
        w = pm.Normal("w", 0.0, 1.0, shape=3, total_size=9)
        pm.Normal("y", mu=mu + w.sum(), sigma=sigma, observed=y)
        if density_dist:
            pm.DensityDist("dd", lambda value: -0.5 * ((value - mu) ** 2),
                           observed={"value": obs})
    return model


MIXED_POINT = {"mu": np.float32(0.3), "sigma_log__": np.float32(-0.2),
               "w": np.array([0.1, -0.4, 0.2], np.float32)}


def _factors(model):
    return {f.name: f for f in list(model.free_RVs) + list(model.observed_RVs)}


def test_each_factor_logp_matches_the_jax_package():
    jm, tm = _mixed(pj), _mixed(pt)
    jf, tf = _factors(jm), _factors(tm)
    assert sorted(jf) == sorted(tf)
    for name in jf:
        np.testing.assert_allclose(tf[name].logp(MIXED_POINT),
                                   jf[name].logp(MIXED_POINT), err_msg=name,
                                   **SUM_TOL)
    total = sum(f.logp(MIXED_POINT) for f in tf.values())
    np.testing.assert_allclose(total, tm.logp(MIXED_POINT), **SUM_TOL)
    np.testing.assert_allclose(tm.logp(MIXED_POINT), jm.logp(MIXED_POINT),
                               **SUM_TOL)


def test_a_point_in_the_constrained_space():
    """A Point that gives a transformed variable by its own name
    (``sigma``, not ``sigma_log__``) is read in that space, as the JAX
    package reads it; the port used the test value instead."""
    point = {"mu": np.float32(0.3), "sigma": np.float32(0.8),
             "w": np.array([0.1, -0.4, 0.2], np.float32)}
    jm, tm = _mixed(pj), _mixed(pt)
    np.testing.assert_allclose(tm.logp(point), jm.logp(point), **SUM_TOL)
    np.testing.assert_allclose(tm["y"].logp(point), jm["y"].logp(point),
                               **SUM_TOL)


def test_logp_elemwise_env_with_and_without_jacobian():
    jm, tm = _mixed(pj), _mixed(pt)
    jenv = jm._point_to_env(MIXED_POINT)
    tenv = tm._point_to_env(MIXED_POINT)
    for jrv, trv in zip(jm.free_RVs, tm.free_RVs):
        for method in ("logp_elemwise_env", "logp_elemwise_env_nojac"):
            np.testing.assert_allclose(
                float(getattr(trv, method)(tenv, {})),
                float(getattr(jrv, method)(jenv, {})), err_msg=method,
                **SUM_TOL)


def test_multi_observed_rv_is_a_factor_like_the_jax_packages():
    jm, tm = _mixed(pj), _mixed(pt)
    jdd = [o for o in jm.observed_RVs if o.name == "dd"][0]
    tdd = [o for o in tm.observed_RVs if o.name == "dd"][0]
    assert isinstance(tdd, pt.MultiObservedRV)
    assert type(jdd).__name__ == type(tdd).__name__
    np.testing.assert_allclose(tdd.logp(MIXED_POINT), jdd.logp(MIXED_POINT),
                               **SUM_TOL)
    assert "dd" not in tm.named_vars and "dd" not in jm.named_vars


def test_init_value_and_random():
    jm, tm = _mixed(pj), _mixed(pt)
    for name in ("mu", "sigma_log__", "w"):
        np.testing.assert_allclose(tm[name].init_value, jm[name].init_value,
                                   **TOL)
    gen = torch.Generator().manual_seed(5)
    for name in ("w", "sigma"):
        want = np.asarray(jm[name].random(size=4))
        got = tm[name].random(size=4, gen=gen)
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        assert got.shape == want.shape
        assert np.all(np.isfinite(got))
    assert np.all(tm["sigma"].random(size=1000, gen=gen) > 0)


# -- the model's surface (fault 3) --------------------------------------------
def test_dlogp_fastlogp_and_logp_elemwise():
    jm, tm = _mixed(pj), _mixed(pt)
    np.testing.assert_allclose(tm.dlogp(MIXED_POINT), jm.dlogp(MIXED_POINT),
                               **SUM_TOL)
    np.testing.assert_allclose(tm.fastlogp(MIXED_POINT),
                               jm.fastlogp(MIXED_POINT), **SUM_TOL)
    want, got = jm.logp_elemwise(MIXED_POINT), tm.logp_elemwise(MIXED_POINT)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **SUM_TOL)
    q = jm.dict_to_array(MIXED_POINT)
    jl, jg = pj.model.jax.value_and_grad(jm.make_logp_fn())(q)
    tl, tg = tm.make_logp_dlogp_fn()(q)
    np.testing.assert_allclose(float(tl), float(jl), **SUM_TOL)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **SUM_TOL)


def test_model_views_and_functions():
    jm, tm = _mixed(pj), _mixed(pt)
    assert [v.name for v in tm.basic_RVs] == [v.name for v in jm.basic_RVs]
    for name in ("fn", "fastfn"):
        want = getattr(jm, name)([jm["w"] * 2, jm["sigma"]])(MIXED_POINT)
        got = getattr(tm, name)([tm["w"] * 2, tm["sigma"]])(MIXED_POINT)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a, b, **TOL)
    with tm:
        f = pt.compilef(tm["mu"] + 1)
        g = pt.fn(tm["mu"] * 3)
    np.testing.assert_allclose(f(MIXED_POINT), 1.3, **TOL)
    np.testing.assert_allclose(g(MIXED_POINT), 0.9, **TOL)
    jflat, tflat = jm.flatten(), tm.flatten()
    np.testing.assert_allclose(tflat.input, jflat.input, **TOL)
    assert {k: (v.slc, v.shp) for k, v in tflat.replacements.items()} == \
        {k: (v.slc, v.shp) for k, v in jflat.replacements.items()}
    prof = tm.profile(tm["w"].sum(), n=3)
    assert set(prof) == set(jm.profile(jm["w"].sum(), n=3))
    assert prof["n_calls"] == 3


@pytest.mark.parametrize("call", [
    lambda: pt.Model(devcie="cpu"),
    lambda: pt.Model(device="cpu").logp_dlogp_function(dtpye="float32"),
], ids=["Model", "logp_dlogp_function"])
def test_an_unknown_keyword_raises(call):
    """A misspelt or unsupported keyword is a ``TypeError``, not an option
    that is accepted and ignored."""
    with pytest.raises(TypeError):
        call()


def test_submodel_root_isroot_and_name_of():
    out = []
    for pm in (pj, pt):
        with pm.Model() as root:
            with pm.Model("inner") as inner:
                v = pm.Normal("v", 0.0, 1.0)
        out.append((root.isroot, inner.isroot, inner.root is root,
                    v.name, inner.name_of(v.name), root.name_of(v.name)))
    assert out[1] == out[0]


def test_add_random_variable_registers_a_named_variable():
    for pm in (pj, pt):
        model = _x_model(pm)
        assert model.add_random_variable == model.add_named_variable


def _coords_model(pm):
    with pm.Model(coords={"county": ["a", "b", "c"]}) as model:
        model.add_coords({"obs_id": np.arange(4)})
        a = pm.Normal("a", 0.0, 1.0, shape=3, dims="county")
        pm.Data("x", np.arange(4.0), dims="obs_id")
        pm.Deterministic("a2", a * 2, dims="county")
        pm.Deterministic("a_range", a.max() - a.min())
    return model


def test_coords_and_dims_are_the_jax_packages():
    jm, tm = _coords_model(pj), _coords_model(pt)
    assert tm._RV_dims == jm._RV_dims
    assert list(tm.coords) == list(jm.coords)
    for k in jm.coords:
        np.testing.assert_array_equal(np.asarray(tm.coords[k]),
                                      np.asarray(jm.coords[k]))


def test_inference_data_reads_the_models_coords_and_dims():
    """The same two draws in both packages' traces: the posterior's dims,
    coords and values agree."""
    rng = np.random.RandomState(6)
    points = [{"a": rng.randn(3).astype(np.float32)} for _ in range(2)]
    out = []
    for pm in (pj, pt):
        model = _coords_model(pm)
        with model:
            pts = [dict(p, a2=2 * p["a"], a_range=np.float32(
                p["a"].max() - p["a"].min())) for p in points]
            trace = pm.point_list_to_multitrace(pts, model)
            out.append(pm.to_inference_data(trace, model))
    jid, tid = out
    assert tid.posterior.dims == jid.posterior.dims
    assert list(tid.posterior.coords) == list(jid.posterior.coords)
    for k in jid.posterior.coords:
        np.testing.assert_array_equal(np.asarray(tid.posterior.coords[k]),
                                      np.asarray(jid.posterior.coords[k]))
    for k in ("a", "a2", "a_range"):
        np.testing.assert_allclose(tid.posterior[k], jid.posterior[k], **TOL)


def test_sample_returns_inference_data_with_the_models_dims():
    with _coords_model(pt) as model:
        pt.Normal("y", model["a"].sum(), 1.0, observed=np.ones(2, "f"))
        idata = pt.sample(draws=5, tune=5, chains=2, progressbar=False,
                          random_seed=1, return_inferencedata=True,
                          compute_convergence_checks=False)
    assert idata.posterior.dims["a"] == ("county",)
    assert idata.posterior["a"].shape == (2, 5, 3)
    assert list(idata.posterior.coords["county"]) == ["a", "b", "c"]


def test_glm_default_priors_are_the_jax_packages():
    for attr, kind in (("default_regressor_prior", "Normal"),
                       ("default_intercept_prior", "Flat")):
        assert type(getattr(pj.GLM, attr)).__name__ == kind
        with pt.Model(device="cpu"):
            prior = getattr(pt.GLM, attr)
        assert type(prior).__name__ == kind
        assert type(getattr(pt.glm.LinearComponent, attr)).__name__ == kind
    np.testing.assert_allclose(float(pt.GLM.default_regressor_prior.tau.
                                     test_value), 1e-6, rtol=1e-6)


# -- ValueGradFunction and the steppers (fault 4) -----------------------------
def test_value_grad_function_flat_maps():
    jm, tm = _mixed(pj), _mixed(pt)
    jf, tf = jm.logp_dlogp_function(), tm.logp_dlogp_function()
    q = tf.dict_to_array(MIXED_POINT)
    np.testing.assert_allclose(q, jf.dict_to_array(MIXED_POINT), **TOL)
    for method in ("array_to_dict", "array_to_full_dict"):
        want, got = getattr(jf, method)(q), getattr(tf, method)(q)
        assert list(got) == list(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], **TOL)


def test_grad_vars_subset_with_fixed_extra_values():
    """logp and gradient over ``grad_vars`` with the other variables at
    fixed values: the JAX package's at one point, and the matching columns
    of the full gradient at every chain. (The JAX package's jitted function
    cannot trace a ``DensityDist`` whose logp builds nodes.)"""
    jm, tm = _mixed(pj, False), _mixed(pt, False)
    extra = {"sigma_log__": np.float32(0.4)}
    jf = jm.logp_dlogp_function(grad_vars=[jm["w"], jm["mu"]])
    tf = tm.logp_dlogp_function(grad_vars=[tm["w"], tm["mu"]])
    jf.set_extra_values(extra)
    tf.set_extra_values(extra)
    assert tf.get_extra_values().keys() == jf.get_extra_values().keys()
    point = dict(MIXED_POINT, **extra)
    q = tf.dict_to_array(point)
    jl, jg = jf(q)
    tl, tg = tf(torch.as_tensor(q)[None])
    np.testing.assert_allclose(float(tl[0]), jl, **SUM_TOL)
    np.testing.assert_allclose(tg[0].numpy(), jg, **SUM_TOL)
    # against the full gradient's columns, at several chains
    rng = np.random.RandomState(1)
    full = tm.logp_dlogp_function()
    qs = np.stack([full.dict_to_array(dict(point, w=rng.randn(3).astype(
        "f"), mu=np.float32(rng.randn()))) for _ in range(6)])
    fl, fg = full(torch.as_tensor(qs))
    cols = np.concatenate([np.arange(tm.ordering[n].slc.start,
                                     tm.ordering[n].slc.stop)
                           for n in ("w", "mu")])
    sl, sg = tf(torch.as_tensor(qs[:, cols]))
    np.testing.assert_allclose(sl.numpy(), fl.numpy(), **SUM_TOL)
    np.testing.assert_allclose(sg.numpy(), fg.numpy()[:, cols], **SUM_TOL)


def test_transformed_grad_var_stands_for_its_free_variable():
    tm = _mixed(pt)
    f = tm.logp_dlogp_function(grad_vars=[tm["sigma"]])
    assert [vm.var for vm in f.ordering.vmap] == ["sigma_log__"]


@pytest.mark.parametrize("name", ["NUTS", "HamiltonianMC"])
def test_hmc_steppers_warnings_and_default_blocked(name):
    assert getattr(pt, name).default_blocked == getattr(pj, name).\
        default_blocked
    model = _mixed(pt)
    with model:
        step = getattr(pt, name)()
    assert step.warnings() == []


# -- exports (fault 5) --------------------------------------------------------
@pytest.mark.parametrize("name", [
    "SMC", "DifferentialEquation", "ArrayOrdering", "DictToArrayBijection",
    "DictToVarBijection", "Factor", "map_args", "theano_constant",
    "bool_types", "int_types", "float_types", "complex_types",
    "continuous_types", "discrete_types", "typefilter", "isgenerator"])
def test_exported_name(name):
    assert hasattr(pt, name), name
    if name.endswith("_types"):
        assert getattr(pt, name) == getattr(pj, name)


def test_theano_constant_and_typefilter():
    c = pt.theano_constant(np.arange(3.0))
    np.testing.assert_array_equal(c.test_value,
                                  pj.theano_constant(np.arange(3.0))
                                  .test_value)
    model = _mixed(pt)
    got = [v.name for v in pt.typefilter(model.free_RVs, pt.float_types)]
    jm = _mixed(pj)
    assert got == [v.name for v in pj.typefilter(jm.free_RVs,
                                                  pj.float_types)]


# -- generate_samples with a host generator (fault 7) -------------------------
@pytest.mark.parametrize("call", [
    lambda gs: gs(np.random.normal, 0.0, 1.0, size=5),
    lambda gs: gs(np.random.normal, np.zeros(3), 2.0, size=(4,)),
    lambda gs: gs(st.norm.rvs, loc=1.0, scale=2.0, size=(2, 3)),
    lambda gs: gs(st.norm.rvs, loc=np.ones(2), scale=0.5, dist_shape=(2,),
                  size=6),
    lambda gs: gs(np.random.gamma, 2.0, size=None),
], ids=["normal", "normal_vector", "rvs_kwargs", "rvs_dist_shape",
        "no_size"])
def test_generate_samples_with_a_host_generator(call):
    np.random.seed(11)
    want = np.asarray(call(pj.distributions.generate_samples))
    np.random.seed(11)
    got = call(pt.distributions.generate_samples)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_density_dist_random_from_a_host_generator():
    """A PyMC3-style ``random`` through ``generate_samples(stats.norm.rvs,
    ...)``: prior predictive draws on the model's device, moments of
    N(2, 0.5)."""
    def random(point=None, size=None):
        return pt.distributions.generate_samples(
            st.norm.rvs, loc=2.0, scale=0.5, size=size)
    with pt.Model() as model:
        pt.DensityDist("d", lambda v: -0.5 * ((v - 2.0) / 0.5) ** 2,
                       random=random)
    np.random.seed(2)
    draws = model.sample_forward(4000)["d"]
    assert draws.device == model.device and tuple(draws.shape) == (4000,)
    assert abs(float(draws.mean()) - 2.0) < 4 * 0.5 / np.sqrt(4000)
    assert abs(float(draws.std()) - 0.5) < 0.05


def test_value_grad_function_profile_counts_evaluations():
    """``profile`` is the JAX package's evaluation count: one a call, at
    any chain count."""
    jf = _x_model(pj).logp_dlogp_function()
    tf = _x_model(pt).logp_dlogp_function()
    q = np.zeros(12, np.float32)
    for _ in range(3):
        jf(q)
        tf(torch.from_numpy(np.stack([q, q])))
    assert tf.profile == jf.profile == {"n_eval": 3}


def test_allinmodel_raises_as_the_jax_packages():
    from pymc3_tpu.tuning.starting import allinmodel as jax_allinmodel
    from pymc3_tpu_torch.tuning.starting import allinmodel
    errors = []
    for pm, check in ((pj, jax_allinmodel), (pt, allinmodel)):
        model, other = _x_model(pm), _x_model(pm)
        check(model.free_RVs, model)
        with pytest.raises(ValueError) as e:
            check(other.free_RVs, model)
        errors.append(str(e.value).split(":")[0])
    assert errors[0] == errors[1] == "Some variables not in the model"


def test_config_has_the_jax_packages_fields():
    assert pt.get_config().compute_test_value == \
        pj.config.get_config().compute_test_value == "raise"
    from pymc3_tpu import ops as jops
    from pymc3_tpu_torch import ops as tops
    assert tops.STATIONARY_KINDS == jops.STATIONARY_KINDS
    assert tops.stationary_cov is tops.gp_cov.stationary_cov
