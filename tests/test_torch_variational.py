"""The port's variational inference against the JAX package's on the CPU.

One objective value, its gradient and one optimizer step of MeanField,
FullRank and NormalizingFlow are compared on the JAX package's own random
numbers: its key splits are replayed into the port's ``noise`` (the
standard normal draws of each group and the minibatch offsets), so the two
compute the same float32 function. Tolerances: rtol 1e-4 and atol 1e-4 on
values and gradients (float32 sums of a few hundred terms in another
order). The KSD direction is compared on fixed particles.

Fits cannot share random streams (Philox against threefry): the conjugate
fits are held to the closed forms at the JAX tests' own tolerances
(``tests/test_variational.py``, ``tests/test_variational_elbo.py``), and
ADVI on the GP model at n = 20 is held against the JAX package's fit of the
same model.
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

from .torch_models import gp_model

torch.set_num_threads(2)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


# -- models ------------------------------------------------------------------
def _logistic(pm, N=300, d=4, batch=40):
    """The minibatch logistic regression of the ADVI benchmark, small."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, d).astype(np.float32)
    w_true = rng.randn(d).astype(np.float32) * 0.5
    y = (rng.uniform(size=N) < 1 / (1 + np.exp(-X @ w_true))).astype(
        np.float32)
    X_mb, y_mb = pm.Minibatch(X, batch), pm.Minibatch(y, batch)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 1.0, shape=d)
        b = pm.Normal("b", 0.0, 1.0)
        p = pm.math.invlogit(pm.math.dot(X_mb, w) + b)
        pm.Bernoulli("obs", p=p, observed=y_mb, total_size=N)
    return model, X_mb


def _hierarchical(pm):
    """A transformed scale and a vector: the jacobian term is in play."""
    rng = np.random.RandomState(3)
    y = (rng.randn(30) * 1.5 + 0.7).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        sd = pm.HalfNormal("sd", 2.0)
        th = pm.Normal("th", mu, sd, shape=3)
        pm.Normal("obs", mu=th.sum() / 3.0, sigma=sd, observed=y)
    return model


# -- replaying the JAX package's random numbers ------------------------------
def _jax_noise(japprox, tmodel, key, nmc, mb=None):
    """The port's ``noise`` for the JAX objective's ``key``: the key splits
    of ``ObjectiveFunction.loss_fn`` and ``Approximation.sample_q``, and
    each sample's window offset (``MinibatchNode._eval_default``)."""
    k_q, k_mb = jax.random.split(key)
    mb_keys = jax.random.split(k_mb, nmc)
    keys = jax.random.split(k_q, len(japprox.groups))
    groups = [torch.as_tensor(np.array(jax.random.normal(
        keys[i], (nmc, g.ndim), jnp.float32)))
        for i, g in enumerate(japprox.groups)]
    draw = {}
    if mb is not None:
        r = [int(jax.random.randint(jax.random.fold_in(k, mb._fold), (), 0,
                                    mb.data.shape[0])) for k in mb_keys]
        tnode = tv.opvi.minibatch_nodes(tmodel)[0]
        draw[tnode.noise_key] = torch.as_tensor(r, dtype=torch.int64)
    return {"groups": groups, "minibatch": draw}


def _to_torch(params):
    return {i: {k: torch.as_tensor(np.array(v)) for k, v in p.items()}
            for i, p in params.items()}


def _assert_tree_close(got, want, **tol):
    for i in want:
        for k in want[i]:
            np.testing.assert_allclose(got[i][k].detach().numpy(),
                                       np.asarray(want[i][k]), err_msg=k,
                                       **tol)


def _perturbed(params, seed):
    """The families' start points moved off their symmetric values."""
    rng = np.random.RandomState(seed)
    return {i: {k: (np.asarray(v) + 0.3 * rng.randn(*np.shape(v))).astype(
        np.float32) for k, v in p.items()} for i, p in params.items()}


#: The flow parameters that ``init_params`` draws from an unseeded
#: generator in both packages, and the scale it draws them at (planar's
#: ``u`` and ``w``, radial's ``z0``, householder's ``v``); the others start
#: at fixed values.
FLOW_DRAWN = {"u": 0.01, "w": 0.01, "z0": 0.01, "v": 1.0}


def _seeded_flows(params, seed):
    """The flows' drawn parameters drawn again from ``seed``, at the scale
    of ``init_params``, so that both packages start from one point that the
    seed fixes (a flow group's keys are ``f{i}_{name}``)."""
    rng = np.random.RandomState(1000 + seed)
    return {i: {k: (FLOW_DRAWN[k.split("_", 1)[1]] * rng.randn(*np.shape(v))
                    if k.split("_", 1)[1] in FLOW_DRAWN
                    else np.asarray(v)).astype(np.float32)
                for k, v in p.items()} for i, p in params.items()}


FAMILIES = {
    "mean_field": (jv.MeanField, tv.MeanField, {}),
    "full_rank": (jv.FullRank, tv.FullRank, {}),
    "flow": (jv.NormalizingFlow, tv.NormalizingFlow,
             {"flow": "planar*2-radial-hh-scale-loc"}),
}
#: The flow's start seeds: "flow" is seed 4, the perturbation seed of the
#: other families, and "flow-seed{s}" the others.
FLOW_SEEDS = (4, 0, 1, 2, 3, 5, 6, 7, 8)
CASES = ["mean_field", "full_rank"] + [
    "flow" if s == 4 else f"flow-seed{s}" for s in FLOW_SEEDS]


def _pair(case, build):
    """Both packages' approximations of one family at one start point,
    made from a seed: the JAX package's initial parameters (the flows'
    drawn ones drawn again from the case's seed) moved by seeded noise,
    handed to both as the same arrays."""
    family, _, seed = case.partition("-seed")
    seed = int(seed) if seed else 4
    jcls, tcls, kw = FAMILIES[family]
    jmodel, tmodel = build(pj), build(pt)
    ja = jcls(model=jmodel, **kw)
    ta = tcls(model=tmodel, **kw)
    params = ja.params
    if family == "flow":
        params = _seeded_flows(params, seed)
    params = _perturbed(params, seed)
    ja.params = {i: {k: jnp.asarray(v) for k, v in p.items()}
                 for i, p in params.items()}
    ta.params = _to_torch(params)
    return ja, ta


@pytest.mark.parametrize("family", CASES)
@pytest.mark.parametrize("build", ["hierarchical", "logistic"])
def test_elbo_value_and_gradient_on_replayed_noise(family, build):
    nmc = 5
    if build == "logistic":
        ja, ta = _pair(family, lambda pm: _logistic(pm)[0])
        mb = ja.model.observed_RVs[0].data_node
    else:
        ja, ta = _pair(family, _hierarchical)
        mb = None
    key = jax.random.PRNGKey(7)
    jloss = jv.KL(ja)().loss_fn(nmc)
    want, jgrads = jax.jit(jax.value_and_grad(jloss))(ja.params, key)
    noise = _jax_noise(ja, ta.model, key, nmc, mb)
    got, tgrads = tv.opvi.value_and_grad(tv.KL(ta)().loss_fn(nmc), ta.params,
                                         noise)
    np.testing.assert_allclose(float(got), float(want), **TOL)
    _assert_tree_close(tgrads, jgrads, **TOL)


@pytest.mark.parametrize("family", CASES)
def test_one_optimizer_step_on_replayed_noise(family):
    """One default (``adagrad_window``) step, then one ``adam`` step."""
    ja, ta = _pair(family, lambda pm: _logistic(pm)[0])
    mb = ja.model.observed_RVs[0].data_node
    jparams, tparams = ja.params, ta.params
    for i, (jopt, topt) in enumerate(((None, None),
                                      (jv.updates.adam(learning_rate=0.05),
                                       tv.updates.adam(learning_rate=0.05)))):
        jstep, jo = jv.KL(ja)().step_function(obj_n_mc=3, obj_optimizer=jopt)
        tstep, to = tv.KL(ta)().step_function(obj_n_mc=3, obj_optimizer=topt)
        key = jax.random.PRNGKey(11 + i)
        jparams, _, jl = jax.jit(jstep)(jparams, jo.init(jparams), key)
        tparams, _, tl = tstep(tparams, to.init(tparams),
                               _jax_noise(ja, ta.model, key, 3, mb))
        np.testing.assert_allclose(float(tl), float(jl), **TOL)
        _assert_tree_close(tparams, jparams, **TOL)


def _flow_x64(params, eps, nmc):
    """The JAX package's flow objective and its gradients at x64 on the
    hierarchical model, from the float32 start ``params`` and the replayed
    standard normals ``eps`` (nmc, ndim), both taken exactly into float64:
    ``jax.random.normal`` hands back ``eps`` while the loss is traced."""
    prev = pj.get_config().floatX
    pj.set_config(floatX="float64")     # turns on jax_enable_x64
    try:
        ja = jv.NormalizingFlow(model=_hierarchical(pj),
                                **FAMILIES["flow"][2])
        ja.params = {i: {k: jnp.asarray(v, jnp.float64) for k, v in p.items()}
                     for i, p in params.items()}
        replay = jnp.asarray(np.asarray(eps, np.float64))
        normal = jax.random.normal
        jax.random.normal = lambda key, shape, dtype=None: replay
        try:
            val, grads = jax.value_and_grad(jv.KL(ja)().loss_fn(nmc))(
                ja.params, jax.random.PRNGKey(7))
        finally:
            jax.random.normal = normal
        return float(val), {i: {k: np.asarray(v) for k, v in g.items()}
                            for i, g in grads.items()}
    finally:
        pj.set_config(floatX=prev)
        jax.config.update("jax_enable_x64", False)


def _max_err(value, grads, truth):
    """max |x - truth| over the objective and every gradient entry, and
    max |x - truth| / (atol + rtol |truth|) at ``TOL``."""
    pairs = [(np.float64(value), np.float64(truth[0]))]
    for i in truth[1]:
        for k, want in truth[1][i].items():
            got = grads[i][k]
            got = got.detach().numpy() if torch.is_tensor(got) else got
            pairs.append((np.asarray(got, np.float64), want))
    err = max(float(np.max(np.abs(a - b))) for a, b in pairs)
    units = max(float(np.max(np.abs(a - b) / (TOL["atol"]
                                              + TOL["rtol"] * np.abs(b))))
                for a, b in pairs)
    return err, units


#: The port's float32 error against the x64 truth, at most this many times
#: the JAX package's float32 error on the same inputs.
FLOAT32_ERR_MULTIPLE = 4.0


@pytest.mark.parametrize("seed", list(FLOW_SEEDS) + [34])
def test_flow_float32_error_against_x64(seed):
    """Both packages' float32 objective and gradients against the JAX
    package's x64 ones, at the same start and normals.

    At seed 34 the two float32 results part by 1.09 x ``TOL`` in the
    Householder ``v`` gradient (-0.93561 against -0.93549, 1.23865 against
    1.23840): its entries there are sums of terms of a few hundred that
    cancel to about one, so one float32 rounding of a term (6e-8 x 400,
    about 2.4e-5) is a quarter of the atol, and five samples' worth of
    them in another order part the two by 2.4e-4. Neither package computes
    another expression: against x64 the JAX package errs by up to 3.4e-4
    over the tree and the port by up to 2.8e-4. So the comparison here is
    with the truth: the port's largest error over the objective and every
    gradient entry is at most ``FLOAT32_ERR_MULTIPLE`` times the JAX
    package's (4: two float32 sums of the same terms in two orders, whose
    ratio ranged over 0.06-3.08 at seeds 0-39). And each package lies
    within ``TOL`` of the x64 truth (at most 0.61 of it at these seeds),
    which shows that the truth replays the same normals: on other normals
    the errors are of the order of the values themselves, and their ratio
    near 1."""
    nmc = 5
    ja, ta = _pair(f"flow-seed{seed}", _hierarchical)
    key = jax.random.PRNGKey(7)
    want, jgrads = jax.jit(jax.value_and_grad(jv.KL(ja)().loss_fn(nmc)))(
        ja.params, key)
    noise = _jax_noise(ja, ta.model, key, nmc)
    got, tgrads = tv.opvi.value_and_grad(tv.KL(ta)().loss_fn(nmc), ta.params,
                                         noise)
    params = {i: {k: np.asarray(v) for k, v in p.items()}
              for i, p in ja.params.items()}
    truth = _flow_x64(params, noise["groups"][0].numpy(), nmc)
    jerr, junits = _max_err(want, jgrads, truth)
    terr, tunits = _max_err(got, tgrads, truth)
    assert junits <= 1.0 and tunits <= 1.0, (junits, tunits)
    assert terr <= FLOAT32_ERR_MULTIPLE * jerr, (terr, jerr)


def test_fullrank_logq_matches_jax():
    """``logq`` through the triangular solve, against the JAX package's."""
    ja, ta = _pair("full_rank", _hierarchical)
    z = np.random.RandomState(5).randn(ja.ndim).astype(np.float32)
    want = ja.groups[0].logq(ja.params[0], jnp.asarray(z))
    got = ta.groups[0].logq(ta.params[0], torch.as_tensor(z))
    np.testing.assert_allclose(float(got), float(want), **TOL)
    np.testing.assert_allclose(ta.cov, np.asarray(
        ja.groups[0].cov(ja.params[0])), **TOL)
    np.testing.assert_allclose(ta.std, ja.std, **TOL)


def test_ksd_direction_on_fixed_particles():
    jmodel, tmodel = _hierarchical(pj), _hierarchical(pt)
    x = np.random.RandomState(2).randn(64, 5).astype(np.float32) * 0.5
    jobj = jv.KSD(jv.Empirical(size=64, model=jmodel))()
    want = jobj._stein_phi(jnp.asarray(x), jax.grad(jmodel.make_logp_fn()))
    tobj = tv.KSD(tv.Empirical(size=64, model=tmodel))()
    tobj._logp_grad = tmodel.logp_dlogp_function()
    got = tobj.stein_phi(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    stein = tv.Stein(tobj.approx, tv.RBF()).grad(torch.as_tensor(x))
    np.testing.assert_allclose(stein.numpy(), np.asarray(want), **TOL)


def test_rbf_median_of_even_count_matches_jnp():
    x = np.random.RandomState(9).randn(6, 2).astype(np.float32)
    want = jv.RBF()(jnp.asarray(x))
    got = tv.RBF()(torch.as_tensor(x))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# -- closed forms (tests/test_variational_elbo.py) ---------------------------
class TestExactELBO:
    mu0, sigma = 1.5, 1.0
    y_obs = np.array([1.6, 1.4], np.float32)
    post_mu, post_sigma = 1.88, 1.0

    def _elbo_true(self, beta_lik=1.0):
        y, mu0, q_mu, q_sd = self.y_obs, self.mu0, self.post_mu, \
            self.post_sigma
        e_lik = sum(-0.5 * (np.log(2 * np.pi) + (yi - q_mu) ** 2 + q_sd ** 2)
                    for yi in y)
        e_prior = -0.5 * (np.log(2 * np.pi) + (q_mu - mu0) ** 2 + q_sd ** 2)
        entropy = 0.5 * (np.log(2 * np.pi) + 1.0) + np.log(q_sd)
        return beta_lik * e_lik + e_prior + entropy

    def _elbo_mc(self, total_size=None):
        with pt.Model() as model:
            mu = pt.Normal("mu", mu=self.mu0, sigma=self.sigma)
            pt.Normal("y", mu=mu, sigma=1.0, observed=self.y_obs,
                      total_size=total_size)
        approx = tv.MeanField(model=model)
        approx.params[0] = {
            "mu": torch.tensor([self.post_mu]),
            "rho": torch.tensor([np.log(np.exp(self.post_sigma) - 1)],
                                dtype=torch.float32)}
        gen = torch.Generator().manual_seed(0)
        obj = tv.KL(approx)()
        return -float(obj.loss_fn(10000)(approx.params,
                                         obj.draw_noise(gen, 10000)))

    def test_elbo(self):
        np.testing.assert_allclose(self._elbo_mc(), self._elbo_true(),
                                   atol=1e-1)

    @pytest.mark.parametrize("total_size", [2, 5, 8])
    def test_elbo_total_size_scales_likelihood(self, total_size):
        beta = total_size / float(len(self.y_obs))
        np.testing.assert_allclose(self._elbo_mc(total_size),
                                   self._elbo_true(beta_lik=beta), atol=2e-1)


class TestFitMethodGrid:
    """``tests/test_variational_elbo.py::TestFitMethodGrid``: every method
    recovers the conjugate posterior, full-data and minibatched, at the
    JAX test's tolerances."""

    N = 1000
    sigma0, mu0, sigma, mu_true = 2.0, 4.0, 3.0, -5.0

    @classmethod
    def setup_class(cls):
        rng = np.random.RandomState(42)
        cls.data = (cls.sigma * rng.randn(cls.N) + cls.mu_true).astype(
            np.float32)
        d = cls.N / cls.sigma ** 2 + 1 / cls.sigma0 ** 2
        cls.mu_post = (cls.N * np.mean(cls.data) / cls.sigma ** 2 +
                       cls.mu0 / cls.sigma0 ** 2) / d
        cls.sd_post = np.sqrt(1.0 / d)

    def _model(self, use_minibatch):
        obs = pt.Minibatch(self.data, batch_size=128) if use_minibatch \
            else self.data
        with pt.Model() as model:
            mu_ = pt.Normal("mu", mu=self.mu0, sigma=self.sigma0, testval=0)
            pt.Normal("x", mu=mu_, sigma=self.sigma, observed=obs,
                      total_size=self.N)
        return model

    GRID = [
        ("advi", dict(n=4000, obj_n_mc=3), 0.05, True),
        ("fullrank_advi", dict(n=4000, obj_n_mc=3), 0.05, True),
        ("svgd", dict(n=300, inf_kwargs={"n_particles": 100}), 0.2, False),
        ("asvgd", dict(n=500, obj_n_mc=50), 0.2, False),
        ("nfvi=scale-loc", dict(n=4000), 0.05, True),
    ]

    @pytest.mark.parametrize("use_minibatch", [False, True],
                             ids=["full", "mini"])
    @pytest.mark.parametrize("method,kwargs,tol,check_sd", GRID,
                             ids=[g[0] for g in GRID])
    def test_fit_recovers_posterior(self, method, kwargs, tol, check_sd,
                                    use_minibatch):
        opt = tv.updates.adam(learning_rate=0.1 if "svgd" in method
                              else 0.05)
        approx = tv.fit(method=method, model=self._model(use_minibatch),
                        random_seed=1, progressbar=False, obj_optimizer=opt,
                        **kwargs)
        mean = float(approx.mean[0])
        assert abs(mean - self.mu_post) < tol * abs(self.mu_post) + 0.2, \
            (method, mean, self.mu_post)
        if check_sd and not use_minibatch:
            np.testing.assert_allclose(float(approx.std[0]), self.sd_post,
                                       rtol=0.5)

    def test_trace_moments_advi(self):
        approx = tv.fit(n=4000, method="advi", model=self._model(False),
                        random_seed=1, progressbar=False, obj_n_mc=3,
                        obj_optimizer=tv.updates.adam(learning_rate=0.05))
        trace = approx.sample(10000, random_seed=2)
        np.testing.assert_allclose(np.mean(trace["mu"]), self.mu_post,
                                   rtol=0.05)
        np.testing.assert_allclose(np.std(trace["mu"]), self.sd_post,
                                   rtol=0.4)

    def test_run_profiling(self):
        with self._model(False):
            out = tv.ADVI().run_profiling(n=100)
        assert out["n"] == 100 and out["per_step_us"] > 0


# -- tests/test_variational.py -----------------------------------------------
@pytest.fixture(scope="module")
def conjugate():
    np.random.seed(0)
    data = (np.random.randn(80) + 2.0).astype(np.float32)
    with pt.Model() as model:
        mu = pt.Normal("mu", 0.0, 10.0)
        pt.Normal("obs", mu=mu, sigma=1.0, observed=data)
    post_var = 1.0 / (1.0 / 100.0 + len(data))
    return model, post_var * data.sum(), np.sqrt(post_var)


@pytest.mark.parametrize("method,tol_mu,tol_sd", [
    ("advi", 0.1, 0.05), ("fullrank_advi", 0.15, 0.1),
    ("nfvi=scale-loc", 0.15, None)])
def test_conjugate_fits(conjugate, method, tol_mu, tol_sd):
    model, post_mu, post_sd = conjugate
    approx = tv.fit(n=4000, method=method, model=model, random_seed=1,
                    progressbar=False, obj_n_mc=3,
                    obj_optimizer=tv.updates.adam(learning_rate=0.05))
    assert abs(approx.mean[0] - post_mu) < tol_mu
    if tol_sd is not None:
        assert abs(approx.std[0] - post_sd) < tol_sd
    assert np.isfinite(approx.hist).all()
    assert np.mean(approx.hist[-100:]) < np.mean(approx.hist[:100])


def test_svgd(conjugate):
    model, post_mu, _ = conjugate
    approx = tv.fit(n=400, method="svgd", model=model, progressbar=False,
                    inf_kwargs={"n_particles": 60},
                    obj_optimizer=tv.updates.adam(learning_rate=0.1))
    assert abs(approx.mean[0] - post_mu) < 0.3
    assert approx.histogram.shape == (60, 1)


def test_minibatch_advi():
    np.random.seed(7)
    N = 2000
    data = (np.random.randn(N) + 1.5).astype(np.float32)
    mb = pt.Minibatch(data, batch_size=100)
    with pt.Model() as model:
        mu = pt.Normal("mu", 0.0, 10.0)
        pt.Normal("obs", mu=mu, sigma=1.0, observed=mb, total_size=N)
    approx = tv.fit(n=4000, method="advi", model=model, random_seed=1,
                    progressbar=False, obj_n_mc=2,
                    obj_optimizer=tv.updates.adam(learning_rate=0.05))
    post_sd = 1.0 / np.sqrt(1.0 / 100.0 + N)
    assert abs(approx.mean[0] - data.mean()) < 0.1
    assert 0.3 * post_sd < approx.std[0] < 5 * post_sd


def test_flow_formula():
    assert len(tv.flows.Formula("planar*2-radial-loc").build(3)) == 4
    assert tv.flows.flow_for_short_name("hh") is tv.flows.HouseholderFlow
    with pytest.raises(ValueError):
        tv.flows.Formula("bogus")


def test_approx_sample_trace(conjugate):
    model, _, _ = conjugate
    approx = tv.fit(n=500, method="advi", model=model, progressbar=False,
                    obj_optimizer=tv.updates.adam(learning_rate=0.05))
    tr = tv.sample_approx(approx, draws=400, random_seed=1)
    assert len(tr) == 400 and "mu" in tr.varnames
    assert approx.sample_node(model["mu"], size=7).shape == (7,)


def test_fit_dispatch_raises(conjugate):
    model, _, _ = conjugate
    with pytest.raises(KeyError):
        tv.fit(10, method="bogus_method", model=model)
    # local_rv (AEVB) is for advi and fullrank_advi only, as in the JAX
    # package (tests/test_torch_aevb.py covers the methods that take it)
    with pytest.raises(NotImplementedError, match="advi and fullrank_advi"):
        tv.fit(10, method="svgd", model=model,
               local_rv={model["mu"]: (0.0, 1.0)})


def test_tracker_and_convergence(conjugate):
    model, _, _ = conjugate
    tracker = tv.callbacks.Tracker(mean=lambda approx, hist, i: approx.mean)
    cb = tv.callbacks.CheckParametersConvergence(every=200, tolerance=1e-8)
    tv.fit(n=1000, method="advi", model=model, progressbar=False, block=200,
           callbacks=[tracker, cb],
           obj_optimizer=tv.updates.adam(learning_rate=0.05))
    assert len(tracker["mean"]) == 5
    stop = tv.callbacks.CheckParametersConvergence(every=100, tolerance=1e9)
    approx = tv.fit(n=5000, method="advi", model=model, progressbar=False,
                    block=100, callbacks=[stop])
    assert len(approx.hist) == 200


def test_asvgd_amortized():
    np.random.seed(0)
    data = np.random.randn(100).astype(np.float32) + 2.0
    with pt.Model() as model:
        pt.Normal("mu", 0.0, 10.0)
        sd = pt.HalfNormal("sd", 2.0)
        pt.Normal("obs", mu=model["mu"], sigma=sd, observed=data)
    approx = tv.fit(n=2000, method="asvgd", model=model, random_seed=1,
                    progressbar=False,
                    obj_optimizer=tv.updates.adam(learning_rate=0.05))
    assert "particles" not in approx.params[0]
    tr = approx.sample(1000, random_seed=3)
    assert abs(tr["mu"].mean() - data.mean()) < 0.2
    assert abs(tr["sd"].mean() - data.std()) < 0.4


def test_fit_after_set_data_sees_new_data():
    """``test_fit_retraces_after_set_data``: the port keeps no trace, but
    must not keep a stale tensor either."""
    np.random.seed(1)
    d1 = (np.random.randn(200) * 0.5 + 3.0).astype(np.float32)
    d2 = (np.random.randn(200) * 0.5 - 3.0).astype(np.float32)
    with pt.Model() as model:
        y = pt.Data("y", d1)
        mu = pt.Normal("mu", 0.0, 10.0)
        pt.Normal("obs", mu=mu, sigma=0.5, observed=y)
        inf = tv.ADVI(model=model)
        opt = tv.updates.adam(learning_rate=0.1)
        approx = inf.fit(n=1500, progressbar=False, random_seed=1,
                         obj_optimizer=opt)
        assert abs(approx.mean[0] - 3.0) < 0.2
        pt.set_data({"y": d2})
        approx = inf.fit(n=1500, progressbar=False, random_seed=2,
                         obj_optimizer=opt)
    assert abs(approx.mean[0] - (-3.0)) < 0.2


def test_refine_carries_the_optimizer_state(conjugate):
    model, post_mu, _ = conjugate
    inf = tv.ADVI(model=model)
    inf.fit(n=300, progressbar=False, random_seed=1)
    state = inf.state
    inf.refine(300)
    assert len(inf.hist) == 600 and inf.state[1] == state[1] + 300


def test_no_host_sync_inside_a_block(conjugate, monkeypatch):
    """Within a block the step reads no value back: ``Tensor.item`` and
    ``__bool__`` are never called between the two host copies of the
    losses."""
    model, _, _ = conjugate
    calls = []
    for name in ("item", "__bool__", "__float__", "tolist"):
        orig = getattr(torch.Tensor, name)

        def spy(self, *a, _orig=orig, _name=name, **k):
            calls.append(_name)
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, spy)
    inf = tv.ADVI(model=model)
    inf.fit(n=50, progressbar=False, random_seed=1, block=50)
    monkeypatch.undo()
    assert calls == [], calls


@pytest.mark.parametrize("method", ["advi", "fullrank_advi"])
def test_gp_advi_matches_jax_fit(method):
    """ADVI on the GP marginal model (n = 20) through the plain covariance
    path: the port's fit against the JAX package's fit of the same model
    and settings. Two Adam fits of 3000 steps on different random streams
    differ by their optimizer noise: the JAX package's own fits at seeds 3
    and 4 differ by up to 0.35 of q's sd in a mean and 18% in an sd, so the
    means must agree within half of q's sd and the sds within 30%."""
    kw = dict(n=3000, method=method, random_seed=3, progressbar=False,
              obj_n_mc=2)
    japprox = jv.fit(model=gp_model(pj, n=20),
                     obj_optimizer=jv.updates.adam(learning_rate=0.02), **kw)
    tapprox = tv.fit(model=gp_model(pt, n=20),
                     obj_optimizer=tv.updates.adam(learning_rate=0.02), **kw)
    assert np.all(np.abs(tapprox.mean - japprox.mean) < 0.5 * japprox.std)
    np.testing.assert_allclose(tapprox.std, japprox.std, rtol=0.3)


@pytest.mark.parametrize("family", ["advi", "fullrank_advi"])
def test_gp_step_calls_the_covariance_op_once_each_way(family, monkeypatch):
    """Each VI step on the GP reaches the covariance op once forward and
    once backward, its ``obj_n_mc`` samples folded into the op's batch (on
    the card these are the kernels' launches)."""
    from pymc3_tpu_torch.ops import gp_cov
    calls = []
    fwd, bwd = gp_cov._cov_forward, gp_cov._cov_backward
    monkeypatch.setattr(gp_cov, "_cov_forward", lambda kind, X, Xs: (
        calls.append(("forward", X.shape[0])), fwd(kind, X, Xs))[1])
    monkeypatch.setattr(gp_cov, "_cov_backward", lambda kind, g, X, Xs: (
        calls.append(("backward", X.shape[0])), bwd(kind, g, X, Xs))[1])
    tv.fit(n=3, method=family, model=gp_model(pt, n=20), random_seed=1,
           progressbar=False, obj_n_mc=6)
    assert calls == [("forward", 6), ("backward", 6)] * 3
