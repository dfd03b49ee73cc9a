"""The port's local (AEVB) and rowwise variational groups against the JAX
package's, mirroring every case of ``tests/test_aevb.py`` and adding the
objective of each kind of local group at fixed parameters on the JAX
package's replayed random numbers.

The replay (``test_torch_variational._jax_noise``) turns the JAX
objective's key splits into the port's ``noise``: each group's standard
normals, and each Monte-Carlo sample's minibatch offset, from which both
the model's ``Minibatch`` and the encoder take their rows. On the same
numbers the two packages compute the same float32 function: tolerance
rtol 1e-4 and atol 1e-4 relative to the objective's scale (a sum over a
few hundred scaled terms in another order), as
``tests/test_torch_variational.py``'s. Fits run on other random streams
and are held to ``tests/test_aevb.py``'s own bounds.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import variational as jv
from pymc3_tpu_torch import variational as tv
from pymc3_tpu_torch.model import RNG_ENV_KEY

from .test_torch_variational import _jax_noise

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def aevb_model(pm):
    """``tests/test_aevb.py::aevb_model``."""
    with pm.Model() as model:
        x = pm.HalfNormal("x", shape=(2,), total_size=5)
        y = pm.Normal("y", shape=(2,))
    return model, x, y


def vae(pm, n=100, batch=10):
    """``tests/test_aevb.py::test_vae_minibatch_encoder``'s model and data,
    with its encoder written for either package."""
    data = np.random.default_rng(0).normal(1.5, 0.8, size=n).astype(
        np.float32)
    with pm.Model() as model:
        x_mini = pm.Minibatch(data, batch)
        zs = pm.Normal("zs", mu=0, sigma=1, shape=batch, total_size=n)
        pm.Normal("xs_", mu=zs, sigma=0.1, observed=x_mini, total_size=n)
    rows_all = jnp.asarray(data) if pm is pj else torch.as_tensor(data)

    def encoder(aux, draw):
        rows = rows_all[x_mini.indices(draw)]
        if pm is pj:
            return rows * aux["w"] + aux["b"], jnp.broadcast_to(aux["rho"],
                                                                rows.shape)
        return rows * aux["w"] + aux["b"], aux["rho"].expand(rows.shape)
    return model, zs, x_mini, encoder, data


AUX0 = {"w": np.float32(0.1), "b": np.float32(0.0), "rho": np.float32(-2.0)}


# -- tests/test_aevb.py, case by case -----------------------------------------
def test_aevb_trainable_local_params():
    model, x, y = aevb_model(pt)
    mu0 = np.zeros(2, dtype=np.float32)
    rho0 = np.zeros(2, dtype=np.float32)
    with model:
        inference = pt.ADVI(local_rv={x: dict(mu=mu0, rho=rho0)})
        approx = inference.fit(200, obj_n_mc=2, progressbar=False,
                               random_seed=1)
    tr = approx.sample(10)
    assert len(tr) == 10
    assert np.all(np.asarray(tr.get_values("x")) > 0)
    assert not np.allclose(approx.params[0]["mu"].numpy(), mu0)


def test_local_group_logq_scaling():
    for pm in (pj, pt):
        model, x, y = aevb_model(pm)
        groups = pm.variational.approximations
        g = groups.MeanFieldGroup([x], local=True,
                                  params=dict(mu=np.zeros(2),
                                              rho=np.zeros(2)), model=model)
        np.testing.assert_allclose(g.scale_vec, 2.5)
        np.testing.assert_allclose(
            groups.MeanFieldGroup([y], model=model).scale_vec, 1.0)


def test_local_group_requires_params():
    for pm in (pj, pt):
        model, x, y = aevb_model(pm)
        with pytest.raises(ValueError, match="user-provided params"):
            pm.variational.approximations.MeanFieldGroup(
                [x], local=True, model=model)


def test_vae_minibatch_encoder():
    """End-to-end amortized inference at ``tests/test_aevb.py``'s
    settings and bounds."""
    model, zs, x_mini, encoder, data = vae(pt)
    with model:
        inference = pt.ADVI(local_rv={zs: dict(encoder=encoder, aux=AUX0)})
        approx = inference.fit(2000, obj_n_mc=2, progressbar=False,
                               random_seed=2,
                               obj_optimizer=pt.adam(learning_rate=0.02))
    hist = np.asarray(approx.hist)
    assert np.isfinite(hist[-50:]).all()
    assert hist[-50:].mean() < hist[:50].mean()
    w = float(approx.params[0]["aux"]["w"])
    assert w > 0.5, w
    tr = approx.sample(7)
    assert np.asarray(tr.get_values("zs")).shape == (7, 10)


def test_fit_dispatcher_local_rv():
    model, x, y = aevb_model(pt)
    with model:
        approx = pt.fit(50, method="advi",
                        local_rv={x: dict(mu=np.zeros(2), rho=np.zeros(2))},
                        progressbar=False, random_seed=3)
    assert len(approx.groups) == 2
    with pytest.raises(NotImplementedError):
        with model:
            pt.fit(5, method="svgd",
                   local_rv={x: dict(mu=np.zeros(2), rho=np.zeros(2))})


def test_rowwise_fullrank_group():
    with pt.Model() as model:
        one = pt.Normal("one", shape=(3, 2))
        two = pt.Normal("two", shape=(2,))
    groups = tv.approximations
    g_row = groups.FullRankGroup([one], rowwise=True, model=model)
    g_rest = groups.MeanFieldGroup([two], model=model)
    assert g_row.rows == 3 and g_row.row_dim == 2
    approx = tv.Approximation([g_row, g_rest], model=model)
    cov = g_row.cov(approx.params[0]).numpy()
    assert cov.shape == (6, 6)
    assert np.all(cov[0:2, 2:6] == 0) and np.all(cov[2:4, 4:6] == 0)
    with model:
        approx = tv.KLqp(approx).fit(60, obj_n_mc=2, progressbar=False,
                                     random_seed=4)
    tr = approx.sample(5)
    assert np.asarray(tr.get_values("one")).shape == (5, 3, 2)


def test_rowwise_sampling_consistency():
    """Identity blocks draw like N(0, s^2), s = softplus(1), and logq is
    that density at the draws (``tests/test_aevb.py``'s tolerances)."""
    with pt.Model() as model:
        one = pt.Normal("one", shape=(4, 3))
    g = tv.approximations.FullRankGroup([one], rowwise=True, model=model)
    params = g.init_params()
    eps = g.draw_noise(torch.Generator().manual_seed(0), 4000)
    z, logq = g.sample_q(params, eps)
    z = z.numpy()
    s = float(np.log1p(np.exp(1.0)))
    np.testing.assert_allclose(z.mean(0), 0.0, atol=0.1)
    np.testing.assert_allclose(z.std(0), s, atol=0.12)
    want = (-0.5 * (np.log(2 * np.pi) + 2 * np.log(s)
                    + (z / s) ** 2)).sum(-1)
    np.testing.assert_allclose(logq.numpy(), want, rtol=2e-3, atol=2e-3)


# -- the same computation as the JAX package's --------------------------------
def _params_to_torch(params):
    def conv(v):
        if isinstance(v, dict):
            return {k: conv(x) for k, x in v.items()}
        return torch.as_tensor(np.array(v))
    return {i: conv(p) for i, p in params.items()}


def _perturb(params, seed):
    rng = np.random.RandomState(seed)

    def move(v):
        if isinstance(v, dict):
            return {k: move(x) for k, x in v.items()}
        v = np.asarray(v)
        return (v + 0.3 * rng.randn(*v.shape)).astype(np.float32)
    return {i: move(p) for i, p in params.items()}


def _local_pair(kind, family):
    """One approximation in each package with the same (perturbed)
    parameters: ``kind`` "trainable" (``aevb_model``'s x) or "encoder"
    (the VAE), ``family`` the global group's."""
    classes = {"advi": ("ADVI", "mean_field"),
                "fullrank_advi": ("FullRankADVI", "full_rank")}
    out = []
    for pm in (pj, pt):
        if kind == "trainable":
            model, x, y = aevb_model(pm)
            local = {x: dict(mu=np.zeros(2), rho=np.zeros(2))}
            mb = None
        else:
            model, zs, x_mini, encoder, _ = vae(pm)
            local = {zs: dict(encoder=encoder, aux=AUX0)}
            mb = x_mini
        with model:
            inference = getattr(pm, classes[family][0])(local_rv=local)
        out.append((inference.approx, mb))
    (ja, jmb), (ta, tmb) = out
    params = _perturb({i: jax.tree_util.tree_map(np.asarray, p)
                       for i, p in ja.params.items()}, 7)
    ja.params = jax.tree_util.tree_map(jnp.asarray, params)
    ta.params = _params_to_torch(params)
    return ja, ta, jmb


@pytest.mark.parametrize("family", ["advi", "fullrank_advi"])
@pytest.mark.parametrize("kind", ["trainable", "encoder"])
def test_local_elbo_and_gradient_on_replayed_noise(kind, family):
    """The KL objective and its gradient in every parameter, the encoder's
    ``aux`` included, at fixed parameters on replayed noise."""
    nmc = 4
    ja, ta, jmb = _local_pair(kind, family)
    key = jax.random.PRNGKey(13)
    want, jgrads = jax.value_and_grad(jv.KL(ja)().loss_fn(nmc))(ja.params,
                                                                key)
    noise = _jax_noise(ja, ta.model, key, nmc, jmb)
    got, tgrads = tv.opvi.value_and_grad(tv.KL(ta)().loss_fn(nmc), ta.params,
                                         noise)
    scale = max(1.0, abs(float(want)))
    np.testing.assert_allclose(float(got) / scale, float(want) / scale,
                               **TOL)
    jleaves = jax.tree_util.tree_leaves(jgrads)
    tleaves = tv.updates.tree_leaves(tgrads)
    assert len(jleaves) == len(tleaves)
    for g_t, g_j in zip(tleaves, jleaves):
        g_j = np.asarray(g_j)
        gscale = max(1.0, float(np.abs(g_j).max()))
        np.testing.assert_allclose(g_t.numpy() / gscale, g_j / gscale, **TOL)


def test_local_group_moments_match_the_jax_package():
    """``mean``, ``std`` and ``logq`` of the encoder group at the test
    value's rows, and the approximation's moments."""
    ja, ta, _ = _local_pair("encoder", "advi")
    jg, tg = ja.groups[0], ta.groups[0]
    np.testing.assert_allclose(tg.mean(ta.params[0]).numpy(),
                               np.asarray(jg.mean(ja.params[0])), **TOL)
    np.testing.assert_allclose(tg.std(ta.params[0]).numpy(),
                               np.asarray(jg.std(ja.params[0])), **TOL)
    z = np.random.RandomState(3).randn(jg.ndim).astype(np.float32)
    np.testing.assert_allclose(
        float(tg.logq(ta.params[0], torch.as_tensor(z))),
        float(jg.logq(ja.params[0], jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(ta.mean, ja.mean, **TOL)
    np.testing.assert_allclose(ta.std, ja.std, **TOL)


def test_encoder_and_likelihood_read_the_same_rows():
    """Under one minibatch draw the encoder's ``indices`` are the rows the
    model's ``Minibatch`` evaluates to, and the JAX package's for the same
    offset; a fit whose two sides drew apart would fit the prior's rows."""
    model, zs, x_mini, encoder, data = vae(pt)
    jmodel, jzs, jx_mini, _, _ = vae(pj)
    approx = tv.ADVI(model=model, local_rv={zs: dict(encoder=encoder,
                                                     aux=AUX0)}).approx
    noise = approx.draw_noise(torch.Generator().manual_seed(5), 6)
    draws = noise["minibatch"]
    assert list(draws) == [x_mini.noise_key]
    for i in range(6):
        draw = {k: v[i] for k, v in draws.items()}
        idx = x_mini.indices(draw)
        seen = x_mini._eval_default({RNG_ENV_KEY: draw}, {})
        np.testing.assert_array_equal(seen.numpy(), data[idx.numpy()])
    key = jax.random.PRNGKey(9)
    r = int(jax.random.randint(jax.random.fold_in(key, jx_mini._fold), (),
                               0, data.shape[0]))
    np.testing.assert_array_equal(
        x_mini.indices({x_mini.noise_key: torch.tensor(r)}).numpy(),
        np.asarray(jx_mini.indices(key)))
    np.testing.assert_array_equal(x_mini.indices(None).numpy(),
                                  np.asarray(jx_mini.indices(None)))


def test_rowwise_group_matches_the_jax_package():
    """``logq``, ``std``, ``cov`` and one draw of a rowwise full-rank group
    at perturbed parameters, the draw on the JAX package's normals."""
    out = []
    for pm in (pj, pt):
        with pm.Model() as model:
            one = pm.Normal("one", shape=(4, 3))
        out.append(pm.variational.approximations.FullRankGroup(
            [one], rowwise=True, model=model))
    jg, tg = out
    params = _perturb({0: {k: np.asarray(v) for k, v in
                           jg.init_params().items()}}, 2)[0]
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    tp = {k: torch.as_tensor(v) for k, v in params.items()}
    key = jax.random.PRNGKey(3)
    jz, jlogq = jg.sample_q(key, jp, 5)
    eps = torch.as_tensor(np.array(jax.random.normal(key, (5, jg.ndim),
                                                     jnp.float32)))
    tz, tlogq = tg.sample_q(tp, eps)
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), **TOL)
    np.testing.assert_allclose(tlogq.numpy(), np.asarray(jlogq), **TOL)
    z = np.asarray(jz)[0]
    np.testing.assert_allclose(float(tg.logq(tp, torch.as_tensor(z))),
                               float(jg.logq(jp, jnp.asarray(z))), **TOL)
    np.testing.assert_allclose(tg.std(tp).numpy(), np.asarray(jg.std(jp)),
                               **TOL)
    cov = tg.cov(tp).numpy()
    np.testing.assert_allclose(cov, np.asarray(jg.cov(jp)), **TOL)
    off = np.ones_like(cov, dtype=bool)
    for r in range(4):
        off[3 * r:3 * r + 3, 3 * r:3 * r + 3] = False
    assert np.all(cov[off] == 0.0)


def test_encoder_step_reads_nothing_back_within_a_block(monkeypatch):
    """An AEVB step keeps the VI step's properties: no host read inside a
    block, finite losses, trained ``aux``."""
    model, zs, x_mini, encoder, _ = vae(pt)
    calls = []
    for name in ("item", "__bool__", "__float__", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    with model:
        inference = tv.ADVI(local_rv={zs: dict(encoder=encoder, aux=AUX0)})
    approx = inference.fit(n=40, progressbar=False, random_seed=1, block=40,
                           obj_optimizer=tv.updates.adam(learning_rate=0.02))
    monkeypatch.undo()
    assert calls == [], calls
    assert np.isfinite(approx.hist).all()
    assert float(approx.params[0]["aux"]["w"]) != float(AUX0["w"])
