"""The port's copy of the JAX package's bench suite
(``scripts/bench_suite.py``): the GP, BEST and mixture models with the same
data and seeds, and the moment gate that holds a posterior against
``BASELINE_CPU.json``. Beside them, three models whose posteriors are known
without a sampler: the exact posterior of the coal-mining switchpoint model
(``examples/disaster_model.py``), a binary-indicator regression with its
posterior by enumeration, a correlated normal for the population sampler,
a latent Gaussian process for the elliptical slice sampler (its posterior
in closed form), a labelling model for the categorical Gibbs scan (its
label marginals by enumeration), the minibatch logistic regression of the
JAX package's ADVI benchmark (``scripts/bench_advi_minibatch.py``), and a
conjugate normal for SVGD and the MAP start (its posterior in closed
form), the JAX package's SMC benchmark (``scripts/bench_smc.py``: a bimodal
target with a closed-form evidence) and SMC-ABC model
(``tests/test_smc.py``), the sparse, latent, Student-T and Kronecker
GPs at the widths of PyMC3's GP notebooks, the freefall ODE of the suite
and the SIR model of PyMC3's ODE notebook, and the pooled and unpooled
radon GLMs.

The suite's own file imports the JAX package, so the port keeps what it
needs here. The mixture model there writes its ordering ``Potential``
with ``jax.numpy``; :func:`mixture_model` is the same model with the
potential in ``torch.where``.
"""
import numpy as np
import torch


def mixture_data():
    """The bench suite's 1000 rows from 3 components (``RandomState(1234)``)."""
    rng = np.random.RandomState(1234)
    size = 1000
    w_true = np.array([0.35, 0.4, 0.25])
    mu_true = np.array([0.0, 2.0, 5.0])
    sigma = np.array([0.5, 0.5, 1.0])
    component = rng.choice(mu_true.size, size=size, p=w_true)
    x = rng.normal(mu_true[component], sigma[component], size=size)
    return x, w_true, mu_true, sigma


def mixture_model(pm):
    """3-component marginal NormalMixture with ordered means
    (``scripts/bench_suite.py:57-80``); returns the model and the gated
    variable names."""
    x, w_true, mu_true, sigma = mixture_data()
    with pm.Model() as model:
        w = pm.Dirichlet("w", a=np.ones_like(w_true))
        mu = pm.Normal("mu", mu=0.0, sigma=10.0, shape=3,
                       testval=mu_true.copy())
        pm.Potential("enforce_order", pm.node.apply(
            lambda m: torch.where(m[0] <= m[1], 0.0, -torch.inf)
            + torch.where(m[1] <= m[2], 0.0, -torch.inf), mu))
        tau = pm.Gamma("tau", alpha=1.0, beta=1.0, shape=3,
                       testval=1.0 / sigma ** 2)
        pm.NormalMixture("x_obs", w=w, mu=mu, tau=tau, observed=x)
    return model, ["mu"]


DRUG = np.array([101, 100, 102, 104, 102, 97, 105, 105, 98, 101,
                 100, 123, 105, 103, 100, 95, 102, 106, 109, 102, 82,
                 102, 100, 102, 102, 101, 102, 102, 103, 103, 97, 97,
                 103, 101, 97, 104, 96, 103, 124, 101, 101, 100, 101,
                 101, 104, 100, 101], dtype=np.float64)
PLACEBO = np.array([99, 101, 100, 101, 102, 100, 97, 101, 104, 101,
                    102, 102, 100, 105, 88, 101, 100, 104, 100, 100,
                    100, 101, 102, 103, 97, 101, 101, 100, 101, 99,
                    101, 100, 100, 101, 100, 99, 101, 100, 102, 99,
                    100, 99], dtype=np.float64)


def best_model(pm):
    """BEST two-group comparison (``scripts/bench_suite.py:35-54``)."""
    y = np.r_[DRUG, PLACEBO]
    y_mean, y_std = y.mean(), y.std() * 2
    with pm.Model() as model:
        g1_mean = pm.Normal("group1_mean", y_mean, sigma=y_std)
        g2_mean = pm.Normal("group2_mean", y_mean, sigma=y_std)
        g1_std = pm.Uniform("group1_std", lower=1, upper=10)
        g2_std = pm.Uniform("group2_std", lower=1, upper=10)
        nu = pm.Exponential("nu_minus_one", 1 / 29.0) + 1
        pm.StudentT("drug", nu=nu, mu=g1_mean, lam=g1_std ** -2,
                    observed=DRUG)
        pm.StudentT("placebo", nu=nu, mu=g2_mean, lam=g2_std ** -2,
                    observed=PLACEBO)
        diff = pm.Deterministic("difference_of_means", g1_mean - g2_mean)
        pm.Deterministic("difference_of_stds", g1_std - g2_std)
        pm.Deterministic(
            "effect_size",
            diff / pm.math.sqrt((g1_std ** 2 + g2_std ** 2) / 2))
    return model, ["difference_of_means"]


def gp_data(n=200):
    """The suite's GP regression data (``RandomState(21)``): sorted inputs
    on [0, 4] as an (n, 1) column, and noisy observations of a sum of two
    waves."""
    rng = np.random.RandomState(21)
    X = np.sort(rng.uniform(0, 4, n))[:, None].astype(np.float32)
    f_true = np.sin(2 * X[:, 0]) + 0.5 * np.cos(5 * X[:, 0])
    y = (f_true + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y


def gp_regression(pm):
    """Marginal GP regression on n = 200 observations with sampled
    lengthscale, amplitude and noise (``scripts/bench_suite.py:102-117``);
    returns the model, the gated names and the ``Marginal`` object, which
    predicts at new inputs once the model is sampled."""
    X, y = gp_data()
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=2)
        eta = pm.HalfNormal("eta", sigma=2)
        cov = (eta ** 2) * pm.gp.cov.ExpQuad(1, ls)
        gp = pm.gp.Marginal(cov_func=cov)
        sigma = pm.HalfNormal("sigma", sigma=1)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    return model, ["ls", "eta", "sigma"], gp


def ode_model_data():
    """The freefall's 20 observations (``benchmarks.py:225-229``)."""
    return np.array([-2.01, 9.49, 15.58, 16.57, 27.58, 32.26, 35.13, 38.07,
                     37.36, 38.83, 44.86, 43.58, 44.59, 42.75, 46.9, 49.32,
                     44.06, 49.86, 46.48, 48.18])


def freefall_ode(pm):
    """The freefall's ``DifferentialEquation``: dy/dt = 2 p[1] - p[0] y at
    20 times from t0 = times[0] = 0."""
    def freefall(y, t, p):
        return 2.0 * p[1] - p[0] * y[0]

    return pm.ode.DifferentialEquation(func=freefall,
                                       times=np.arange(0, 10, 0.5),
                                       n_states=1, n_theta=2, t0=0)


def ode_model(pm, ode=None):
    """1-state 2-param freefall ODE (``scripts/bench_suite.py:83-99``,
    from the reference's ``benchmarks.py:214-263``): ``gamma`` sampled and g
    fixed at 9.8; returns the model and the gated names. ``ode`` is a
    :func:`freefall_ode` to build on (a new one when None)."""
    ode = freefall_ode(pm) if ode is None else ode
    with pm.Model() as model:
        sigma = pm.HalfCauchy("sigma", 1)
        gamma = pm.Lognormal("gamma", 0, 1)
        sol = ode(y0=[0], theta=[gamma, 9.8])
        pm.Normal("Y", mu=sol, sigma=sigma,
                  observed=ode_model_data().reshape(-1, 1))
    return model, ["sigma", "gamma"]


SIR_TIMES = np.arange(0.25, 5, 0.25)


def sir_rhs(y, t, p):
    """SIR with beta = p[0] and recovery rate lambda = p[1] (PyMC3 3.8's
    ODE API notebook)."""
    si = p[0] * y[0] * y[1]
    return [-si, si - p[1] * y[1]]


def sir_data(seed=20):
    """The notebook's data: curves from ``scipy.integrate.odeint`` at beta
    = 4, lambda = 1 from (0.99, 0.01), observed with lognormal noise of sds
    (0.2, 0.3) at t = 0.25, ..., 4.75 (``RandomState(seed)``)."""
    from scipy.integrate import odeint
    curves = odeint(lambda y, t, p: sir_rhs(y, t, p),
                    [0.99, 0.01], np.arange(0, 5, 0.25),
                    args=((4.0, 1.0),), rtol=1e-8)
    rng = np.random.RandomState(seed)
    return rng.lognormal(mean=np.log(curves[1:]), sigma=[0.2, 0.3])


def sir_model(pm):
    """The SIR model of PyMC3 3.8's ODE API notebook: 2 states, 2
    parameters (beta = lambda R0, lambda), a lognormal likelihood of the
    19 observed pairs."""
    y_obs = sir_data()
    ode = pm.ode.DifferentialEquation(func=sir_rhs, times=SIR_TIMES,
                                      n_states=2, n_theta=2, t0=0)
    with pm.Model() as model:
        sigma = pm.HalfCauchy("sigma", 1, shape=2)
        R0 = pm.Bound(pm.Normal, lower=1)("R0", 2, 3)
        lam = pm.Lognormal("lambda", pm.math.log(2), 2)
        beta = pm.Deterministic("beta", lam * R0)
        curves = ode(y0=[0.99, 0.01], theta=[beta, lam])
        pm.Lognormal("Y", mu=pm.math.log(curves), sigma=sigma,
                     observed=y_obs)
    return model


def glm_radon_pooled(pm):
    """``GLM.from_formula("log_radon ~ floor", radon)``: one intercept and
    one floor effect for all 919 homes; returns the model and the gated
    names (the likelihood's ``sd`` with the two coefficients)."""
    from .radon import load_radon_columns
    with pm.Model() as model:
        pm.GLM.from_formula("log_radon ~ floor", load_radon_columns())
    return model, ["Intercept", "floor", "sd"]


def glm_radon_unpooled(pm):
    """``"log_radon ~ floor + C(county)"``: an intercept per county by
    treatment coding, 86 coefficients over 919 rows."""
    from .radon import load_radon_columns
    with pm.Model() as model:
        pm.GLM.from_formula("log_radon ~ floor + C(county)",
                            load_radon_columns())
    return model, ["Intercept", "floor", "sd"]


def gp_model(pm):
    """:func:`gp_regression` without the ``Marginal`` object, as the
    suite's ``gp_model`` returns it."""
    return gp_regression(pm)[:2]


def disaster_exact_posterior(y):
    """The switchpoint model's posterior in closed form, float64.

    With Exponential(1) priors the two rates are conjugate given the
    switchpoint ``s``: ``early | s ~ Gamma(1 + S1, 1 + n1)`` with ``n1 = s``
    years summing to ``S1``, likewise ``late`` over the other ``n2 = N - s``
    years. Integrating them out leaves the switchpoint's weights

        log w(s) = lgamma(1+S1) - (1+S1) log(1+n1)
                 + lgamma(1+S2) - (1+S2) log(1+n2),   s = 0..N-1.

    Returns the weights and, for ``switchpoint``, ``early_mean`` and
    ``late_mean``, the posterior mean and sd (the rates' as mixtures of
    their Gammas over ``w``)."""
    from math import lgamma
    y = np.asarray(y, dtype=np.float64)
    N = len(y)
    s = np.arange(N)
    S1 = np.concatenate([[0.0], np.cumsum(y)[:-1]])
    S2 = y.sum() - S1
    n1, n2 = s.astype(np.float64), (N - s).astype(np.float64)
    logw = np.array([lgamma(1 + a) - (1 + a) * np.log1p(m)
                     + lgamma(1 + b) - (1 + b) * np.log1p(n)
                     for a, m, b, n in zip(S1, n1, S2, n2)])
    w = np.exp(logw - logw.max())
    w /= w.sum()

    def mixed(mean, var):
        m = float(np.sum(w * mean))
        return {"mean": m, "sd": float(np.sqrt(
            np.sum(w * (var + mean ** 2)) - m ** 2))}
    return {"w": w,
            "switchpoint": mixed(s.astype(np.float64), np.zeros(N)),
            "early_mean": mixed((1 + S1) / (1 + n1), (1 + S1) / (1 + n1) ** 2),
            "late_mean": mixed((1 + S2) / (1 + n2), (1 + S2) / (1 + n2) ** 2)}


def indicator_data(rows=64, k=8, seed=7):
    """Design, fixed coefficients and observations of the binary-indicator
    regression: ``y = X @ (z_true * beta) + N(0, 1)``. The coefficients are
    small enough that several indicators stay uncertain."""
    rng = np.random.RandomState(seed)
    X = rng.randn(rows, k)
    beta = np.array([0.3, -0.25, 0.2, 0.3, -0.3, 0.25, 0.2, 0.15])[:k]
    z_true = (np.arange(k) % 2 == 0).astype(np.float64)
    y = X @ (z_true * beta) + rng.randn(rows)
    return X, beta, y


def indicator_model(pm):
    """``z ~ Bernoulli(0.5, shape=8)``, ``y ~ Normal(X @ (z * beta), 1)``
    observed: the free variables are the eight indicators."""
    X, beta, y = indicator_data()
    with pm.Model() as model:
        z = pm.Bernoulli("z", p=0.5, shape=len(beta))
        mu = pm.node.apply(lambda z, Xb: Xb @ z, z,
                           pm.node.as_node((X * beta).astype(np.float32)))
        pm.Normal("y", mu=mu, sigma=1.0, observed=y)
    return model, ["z"]


def indicator_exact_inclusion():
    """The eight inclusion probabilities by enumeration of all 256 states,
    float64 (the prior is uniform over the states)."""
    X, beta, y = indicator_data()
    k = len(beta)
    states = ((np.arange(2 ** k)[:, None] >> np.arange(k)) & 1).astype(
        np.float64)
    resid = y[None, :] - states @ (X * beta).T
    logw = -0.5 * np.sum(resid ** 2, axis=1)
    w = np.exp(logw - logw.max())
    w /= w.sum()
    return w @ states


def ar1_cov(n=10, rho=0.9):
    """The AR(1) covariance ``rho ** |i - j|`` (unit marginal variances)."""
    i = np.arange(n)
    return rho ** np.abs(i[:, None] - i[None, :])


def correlated_normal_model(pm, n=10, rho=0.9):
    """An ``n``-dimensional normal with mean ``arange(n) / 2`` and the
    AR(1) covariance, for the population sampler; returns the model, the
    variable's name, and the known mean and marginal sds."""
    mean = np.arange(n) / 2.0
    with pm.Model() as model:
        pm.MvNormal("x", mu=mean, cov=ar1_cov(n, rho), shape=n)
    return model, ["x"], mean, np.ones(n)


def es_data(n=100, seed=5):
    """``n`` inputs on [0, 1] as an (n, 1) column and noisy observations
    (sd 0.3) of one period of a sine."""
    rng = np.random.RandomState(seed)
    X = np.linspace(0.0, 1.0, n)[:, None].astype(np.float32)
    y = (np.sin(2.0 * np.pi * X[:, 0]) + 0.3 * rng.randn(n)).astype(
        np.float32)
    return X, y


ES_NOISE = 0.3


def es_model(pm):
    """A latent ``f ~ MvNormal(0, K)`` at 100 inputs and ``y ~ Normal(f,
    0.3)``; ``K`` is the port's ``ExpQuad(1, ls=0.2)`` at the inputs plus
    ``1e-5 I``, built once on the model's device (one launch of the
    covariance kernel). In float32 this ``K`` has an eigenvalue of about
    -3e-7, so ``1e-6 I`` leaves it indefinite; ``1e-5 I`` is the smallest
    power of ten that makes it positive definite. Returns the model and
    ``K``, the prior covariance an ``EllipticalSlice`` is given."""
    X, y = es_data()
    n = len(y)
    with pm.Model() as model:
        Xt = torch.as_tensor(X, device=model.device)
        K = pm.node.evaluate(pm.gp.cov.ExpQuad(1, ls=0.2)(Xt), {})
        K = K + 1e-5 * torch.eye(n, dtype=K.dtype, device=K.device)
        f = pm.MvNormal("f", mu=np.zeros(n), cov=K)
        pm.Normal("y", mu=f, sigma=ES_NOISE, observed=y)
    return model, K


def es_exact_posterior(K):
    """The latent's posterior mean and marginal sds in float64:
    ``K (K + s² I)^-1 y`` and the diagonal of ``K - K (K + s² I)^-1 K``."""
    _, y = es_data()
    K = np.asarray(K, dtype=np.float64)
    A = K + ES_NOISE ** 2 * np.eye(len(y))
    mean = K @ np.linalg.solve(A, y.astype(np.float64))
    cov = K - K @ np.linalg.solve(A, K)
    return mean, np.sqrt(np.diag(cov))


LABEL_MEANS = np.array([-1.5, 0.0, 1.5])
LABEL_Y = np.array([-1.9, -0.4, 0.2, 0.9, 1.6, -1.1])


def label_model(pm):
    """Six labels ``z_i ~ Categorical(w)`` with Dirichlet(1, 1, 1) weights;
    ``y_i ~ Normal(LABEL_MEANS[z_i], 1)`` observed. The means are evenly
    spaced, so ``LABEL_MEANS[z]`` is ``-1.5 + 1.5 z``, which either
    package's nodes express. Returns the model."""
    with pm.Model() as model:
        w = pm.Dirichlet("w", a=np.ones(3))
        z = pm.Categorical("z", p=w, shape=len(LABEL_Y))
        pm.Normal("y", mu=LABEL_MEANS[0] + 1.5 * z, sigma=1.0,
                  observed=LABEL_Y)
    return model


def label_exact_marginals():
    """``P(z_i = k | y)``, (6, 3), by enumeration of all 3^6 states with
    the weights integrated out: the labels' prior is Dirichlet-multinomial,
    ``Γ(3) / Γ(3 + 6) Π_k Γ(1 + n_k)``."""
    from math import lgamma
    n, k = len(LABEL_Y), len(LABEL_MEANS)
    states = (np.arange(k ** n)[:, None] // k ** np.arange(n)) % k
    counts = np.stack([(states == j).sum(1) for j in range(k)], 1)
    log_prior = lgamma(k) - lgamma(k + n) + np.sum(
        [[lgamma(1.0 + c) for c in row] for row in counts], axis=1)
    log_lik = -0.5 * np.sum((LABEL_Y[None, :] - LABEL_MEANS[states]) ** 2,
                            axis=1)
    logw = log_prior + log_lik
    w = np.exp(logw - logw.max())
    w /= w.sum()
    return np.stack([w @ (states == j) for j in range(k)], axis=1)


def posterior_moments(pm, trace, var_names):
    """Per-element posterior mean, sd and MCSE of the tracked variables,
    accumulated in float64 (a sequential float32 reduce over a million
    draws drifts by a fifth of a posterior sd)."""
    out = {}
    ess_tbl = pm.ess(trace, var_names=var_names)
    for v in var_names:
        vals = np.asarray(trace[v], dtype=np.float64).reshape(
            len(trace[v]), -1)
        mean = vals.mean(axis=0)
        sd = vals.std(axis=0)
        ess = np.atleast_1d(np.asarray(ess_tbl[v], dtype=np.float64)).ravel()
        mcse = sd / np.sqrt(np.maximum(ess, 1.0))
        out[v] = {"mean": mean.tolist(), "sd": sd.tolist(),
                  "mcse": mcse.tolist()}
    return out


def moment_check(bench_m, ref_m, z_max=4.0, sd_rtol=0.2):
    """|difference of means| / combined MCSE below ``z_max`` and the sds
    within ``sd_rtol``, over every element of every variable."""
    worst_z, worst_sd = 0.0, 0.0
    for v in bench_m:
        mb, mr = (np.asarray(bench_m[v]["mean"]),
                  np.asarray(ref_m[v]["mean"]))
        eb, er = (np.asarray(bench_m[v]["mcse"]),
                  np.asarray(ref_m[v]["mcse"]))
        z = np.abs(mb - mr) / np.sqrt(eb ** 2 + er ** 2 + 1e-300)
        worst_z = max(worst_z, float(np.max(z)))
        sb, sr = np.asarray(bench_m[v]["sd"]), np.asarray(ref_m[v]["sd"])
        rel = np.abs(sb - sr) / np.maximum(np.abs(sr), 1e-12)
        worst_sd = max(worst_sd, float(np.max(rel)))
    return {"pass": bool(worst_z < z_max and worst_sd < sd_rtol),
            "max_z": round(worst_z, 2), "max_sd_rel": round(worst_sd, 3)}


def chain_moments(pm, arrays):
    """Per-element mean, sd and MCSE, in float64, of draws given as
    ``{name: (chains, draws, ...)}`` arrays: for quantities derived from a
    trace (a covariance ``L Lᵀ`` from its factor), in the shape
    :func:`moment_check` compares."""
    out = {}
    for v, a in arrays.items():
        a = np.asarray(a, dtype=np.float64)
        flat = a.reshape(a.shape[0] * a.shape[1], -1)
        ess = np.atleast_1d(np.asarray(pm.ess(a)["x"],
                                       dtype=np.float64)).ravel()
        sd = flat.std(axis=0)
        out[v] = {"mean": flat.mean(axis=0).tolist(), "sd": sd.tolist(),
                  "mcse": (sd / np.sqrt(np.maximum(ess, 1.0))).tolist()}
    return out


def advi_logistic_data(N=50_000, d=100):
    """``scripts/bench_advi_minibatch.py``'s data: ``RandomState(0)``
    design ``X (N, d)``, weights ``w_true`` (sd 0.5) and Bernoulli labels
    ``y``, float32."""
    rng = np.random.RandomState(0)
    X = rng.randn(N, d).astype(np.float32)
    w_true = rng.randn(d).astype(np.float32) * 0.5
    logits = X @ w_true
    y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-logits))).astype(
        np.float32)
    return X, y, w_true


def advi_logistic_model(pm, X, y, batch):
    """The benchmark's model: ``w ~ N(0, 1)`` (d), ``b ~ N(0, 1)``,
    Bernoulli on ``invlogit(X_mb w + b)`` over minibatches of ``batch``
    rows (window sampling, X and y views paired by their seed) scaled to
    ``total_size = N``."""
    X_mb, y_mb = pm.Minibatch(X, batch), pm.Minibatch(y, batch)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 1.0, shape=X.shape[1])
        b = pm.Normal("b", 0.0, 1.0)
        p = pm.math.invlogit(pm.math.dot(X_mb, w) + b)
        pm.Bernoulli("obs", p=p, observed=y_mb, total_size=X.shape[0])
    return model


CONJ_PRIOR_SD = 2.0
CONJ_COV = np.array([[1.0, 0.6], [0.6, 2.0]])


def conjugate_data(n=40, seed=8):
    """``n`` draws of a bivariate normal with covariance ``CONJ_COV``."""
    rng = np.random.RandomState(seed)
    L = np.linalg.cholesky(CONJ_COV)
    return (np.array([1.0, -0.5]) + rng.randn(n, 2) @ L.T).astype(np.float32)


def conjugate_model(pm):
    """``mu ~ N(0, 2² I)`` (2) and ``y_i ~ MvNormal(mu, CONJ_COV)``: a
    posterior that is normal with a correlation, known in closed form
    (:func:`conjugate_posterior`)."""
    y = conjugate_data()
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, CONJ_PRIOR_SD, shape=2)
        pm.MvNormal("y", mu=mu, cov=CONJ_COV, observed=y)
    return model


def conjugate_posterior():
    """The posterior mean and covariance of ``mu`` in float64."""
    y = conjugate_data().astype(np.float64)
    prec = np.eye(2) / CONJ_PRIOR_SD ** 2 + len(y) * np.linalg.inv(CONJ_COV)
    cov = np.linalg.inv(prec)
    return cov @ np.linalg.inv(CONJ_COV) @ y.sum(axis=0), cov



def smc_bimodal_model(pm):
    """``scripts/bench_smc.py``'s target: ``Uniform(-8, 8, shape=2)`` and a
    ``Potential`` of two equal, unnormalised Gaussian bumps at (3, 3) and
    (-3, -3) with sd 0.5. Its evidence is log(pi / 512)
    (:data:`SMC_BIMODAL_LOG_EVIDENCE`), each coordinate's mean 0 and sd
    sqrt(9.25)."""
    def bimodal_logp(x):
        l1 = -0.5 * torch.sum(((x - 3.0) / 0.5) ** 2)
        l2 = -0.5 * torch.sum(((x + 3.0) / 0.5) ** 2)
        return torch.logaddexp(np.log(0.5) + l1, np.log(0.5) + l2)
    with pm.Model() as model:
        x = pm.Uniform("x", -8.0, 8.0, shape=2)
        pm.Potential("bimodal", pm.node.apply(bimodal_logp, x))
    return model


#: The bimodal target's log evidence: the bumps integrate to 2 pi 0.5^2 / 2
#: each, times the uniform density 1 / 256.
SMC_BIMODAL_LOG_EVIDENCE = float(np.log(np.pi / 512.0))


def abc_data():
    """``tests/test_smc.py::test_smc_abc``'s data: 200 draws of
    Normal(1.2, 1) from ``np.random.seed(3)``."""
    return np.random.RandomState(3).normal(loc=1.2, scale=1.0,
                                           size=200).astype(np.float32)


def abc_torch_simulator(a, b):
    """``tests/test_smc.py``'s simulator in torch: ``a + b * zeros(200)``
    on the parameters' device (it runs batched under ``vmap``)."""
    return a + b * torch.zeros(200, dtype=a.dtype, device=a.device)


def abc_model(pm, simulator):
    """SMC-ABC's model of ``tests/test_smc.py``: ``a ~ Normal(0, 5)``,
    ``b ~ HalfNormal(2)`` and a ``Simulator`` of ``simulator(a, b)``
    observed at :func:`abc_data`."""
    with pm.Model() as model:
        a = pm.Normal("a", mu=0, sigma=5)
        b = pm.HalfNormal("b", sigma=2)
        pm.Simulator("s", simulator, a, b, observed=abc_data())
    return model


def _matern52(x, ls, eta):
    """eta^2 Matern52 of 1-d inputs, in float64 (numpy)."""
    t = np.sqrt(5.0) * np.abs(x[:, None] - x[None, :]) / ls
    return eta ** 2 * (1.0 + t + t * t / 3.0) * np.exp(-t)


def sparse_data(n=2000, n_inducing=20, seed=1):
    """The data of PyMC3's sparse-approximation notebook at its width:
    ``n`` sorted inputs on [0, 10], f drawn from eta^2 Matern52(ls) with
    ls = 1 and eta = 3, plus noise of sd 1 (``RandomState(seed)``), and
    ``n_inducing`` inducing points by ``kmeans_inducing_points`` (scipy's
    k-means, seeded from the same state). Returns ``X (n, 1)``, ``y`` and
    ``Xu (n_inducing, 1)``, float32."""
    from ..gp.util import kmeans_inducing_points
    rng = np.random.RandomState(seed)
    x = 10.0 * np.sort(rng.rand(n))
    K = _matern52(x, 1.0, 3.0) + 1e-8 * np.eye(n)
    f = np.linalg.cholesky(K) @ rng.randn(n)
    y = f + 1.0 * rng.randn(n)
    state = np.random.get_state()
    np.random.seed(seed)
    Xu = kmeans_inducing_points(n_inducing, x[:, None])
    np.random.set_state(state)
    return (x[:, None].astype(np.float32), y.astype(np.float32),
            np.sort(Xu, axis=0).astype(np.float32))


def sparse_fitc_model(pm, approx="FITC"):
    """The notebook's model: ``ls ~ Gamma(2, 1)``, ``eta ~ HalfCauchy(5)``,
    ``sigma ~ HalfCauchy(5)``, ``MarginalSparse`` of eta^2 Matern52(ls)
    with :func:`sparse_data`'s inducing points. Returns the model, the
    gated names and the GP."""
    X, y, Xu = sparse_data()
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=1)
        eta = pm.HalfCauchy("eta", beta=5)
        cov = eta ** 2 * pm.gp.cov.Matern52(1, ls)
        gp = pm.gp.MarginalSparse(cov_func=cov, approx=approx)
        sigma = pm.HalfCauchy("sigma", beta=5)
        gp.marginal_likelihood("y", X=X, Xu=Xu, y=y, noise=sigma)
    return model, ["ls", "eta", "sigma"], gp


def latent_data(n=200, seed=2):
    """PyMC3's latent-GP notebook at its width: ``n`` inputs on [0, 10], f
    from 3^2 Matern52(1), observed through StudentT(nu = 3) noise of scale
    0.5."""
    rng = np.random.RandomState(seed)
    x = np.linspace(0.0, 10.0, n)
    f = np.linalg.cholesky(_matern52(x, 1.0, 3.0) + 1e-8 * np.eye(n)) @ \
        rng.randn(n)
    y = f + 0.5 * rng.standard_t(3.0, n)
    return x[:, None].astype(np.float32), y.astype(np.float32)


def latent_model(pm, process="latent"):
    """The notebook's model: ``ls ~ Gamma(2, 1)``, ``eta ~
    HalfCauchy(5)``, f from a ``Latent`` (or, with ``process="tp"``, a
    ``TP`` with nu = 3) GP of eta^2 Matern52(ls), and a StudentT
    likelihood with ``sigma ~ HalfCauchy(5)``, ``nu ~ Gamma(2, 0.1)``."""
    X, y = latent_data()
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=1)
        eta = pm.HalfCauchy("eta", beta=5)
        cov = eta ** 2 * pm.gp.cov.Matern52(1, ls)
        gp = (pm.gp.Latent(cov_func=cov) if process == "latent"
              else pm.gp.TP(cov_func=cov, nu=3.0))
        f = gp.prior("f", X=X)
        sigma = pm.HalfCauchy("sigma", beta=5)
        nu = pm.Gamma("nu", alpha=2, beta=0.1)
        pm.StudentT("y", mu=f, lam=1.0 / sigma, nu=nu, observed=y)
    return model


KRON_GRID = (50, 30)


def kron_data(seed=4):
    """A 50 x 30 grid on [0, 10] x [0, 6] and noisy observations (sd 0.3)
    of a smooth surface, rows in the Kronecker order."""
    rng = np.random.RandomState(seed)
    x1 = np.linspace(0.0, 10.0, KRON_GRID[0])
    x2 = np.linspace(0.0, 6.0, KRON_GRID[1])
    f = np.sin(x1)[:, None] * np.cos(0.8 * x2)[None, :]
    y = f.reshape(-1) + 0.3 * rng.randn(f.size)
    return (x1[:, None].astype(np.float32), x2[:, None].astype(np.float32),
            y.astype(np.float32))


def kron_model(pm, dense=False):
    """``MarginalKron`` over the grid with ExpQuad(ls1) x Matern52(ls2);
    with ``dense=True`` the same likelihood as a ``Marginal`` on the
    cartesian grid, the product of the two kernels over its two columns.
    ``ls1, ls2 ~ Gamma(2, 1)``, ``sigma ~ HalfNormal(1)``."""
    x1, x2, y = kron_data()
    with pm.Model() as model:
        ls1 = pm.Gamma("ls1", alpha=2, beta=1)
        ls2 = pm.Gamma("ls2", alpha=2, beta=1)
        sigma = pm.HalfNormal("sigma", sigma=1)
        if dense:
            X = pm.math.cartesian(x1[:, 0], x2[:, 0]).astype(np.float32)
            cov = pm.gp.cov.ExpQuad(2, ls1, active_dims=[0]) * \
                pm.gp.cov.Matern52(2, ls2, active_dims=[1])
            pm.gp.Marginal(cov_func=cov).marginal_likelihood(
                "y", X=X, y=y, noise=sigma)
        else:
            covs = [pm.gp.cov.ExpQuad(1, ls1), pm.gp.cov.Matern52(1, ls2)]
            pm.gp.MarginalKron(cov_funcs=covs).marginal_likelihood(
                "y", Xs=[x1, x2], y=y, sigma=sigma)
    return model
