"""Reference values of the JAX package on the CPU for ``chip_smoke.py``'s
gates: posterior moments of the LKJ, stochastic-volatility and GARCH
examples, ADVI fits of the minibatch logistic regression and of the GP,
the MAP and Hessian of radon, SMC on the GP at 4,096 particles, the
posterior of the sparse (FITC) GP of PyMC3's sparse-approximation
notebook, and the pooled and unpooled radon GLMs with their LOO and WAIC.

Not a test: it writes ``pymc3_tpu_torch/examples/reference_moments.json``
(for the sampled examples mean, sd and MCSE per element, in
``BASELINE_CPU.json``'s shape), which ``chip_smoke.py`` reads to gate the
port on the card. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference.py [config ...]

With names (``lkj``, ``stochastic_volatility``, ``garch``, ``advi_logistic``,
``advi_gp``, ``map_radon``, ``smc_gp``, ``sparse_fitc``, ``glm_radon``) it
runs those
configurations only and keeps the others already in the file; the file is
written after each configuration.

``smc_gp`` runs the JAX package's ``sample_smc`` on the suite's GP (n = 200)
at 4,096 particles with four seeds (a few minutes each): SMC's Monte-Carlo
error is not the i.i.d. one, so the port's gate is the spread of the four
runs' evidence and moments. ``sparse_fitc`` samples the FITC model with
NUTS, written as a ``Potential`` whose covariances are computed from the
random ``ls`` and ``eta``: the JAX package's own ``MarginalSparse``
evaluates them at their test values whatever the sampler proposes, so it
samples another model.

``glm_radon`` samples ``GLM.from_formula("log_radon ~ floor", radon)`` and
``"log_radon ~ floor + C(county)"`` (``examples/suite.py``) with two seeds
each, and writes the moments of ``Intercept``, ``floor`` and ``sd`` over
both seeds' chains, and each seed's WAIC (the JAX package's ``waic``) and
LOO. The JAX package's ``loo`` is NaN on these models: its ``_gpdfit``
takes the Pareto scale after the prior has moved k, so the scale turns
negative for some observations (``pymc3_tpu/stats/__init__.py:418-419``).
LOO here is the JAX package's ``loo`` with its ``_gpdfit`` replaced by
``arviz_gpdfit`` below, which takes the scale first, as ArviZ does: an
evaluation that calls nothing of the port.

The ADVI fits run at two seeds each: the port's fit on the card draws other
random numbers (Philox against threefry), so its gate is the spread of the
two JAX fits, not their value alone.

For stochastic volatility it also writes
``pymc3_tpu_torch/examples/sv_starts.npy``: 256 posterior draws of the
flat unconstrained vector (16 from each of the 16 chains, 150 draws
apart), where the GPU run starts its chains. Its ``sigma`` mixes so slowly
(0.003 effective draws per draw) that chains started anywhere else spend
far longer than the run has in burn-in.

The three models are the JAX package's own examples at their own widths;
only the chain and draw counts are larger than theirs, to make the
reference's Monte-Carlo error small beside the port's.
"""
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "pymc3_tpu_torch", "examples",
                   "reference_moments.json")
STARTS = os.path.join(ROOT, "pymc3_tpu_torch", "examples", "sv_starts.npy")
COMMAND = "JAX_PLATFORMS=cpu python tests/torch_reference.py"

# (chains, tune, draws, NUTS arguments) of each reference run
RUNS = {
    "lkj": (16, 1000, 2500, {"target_accept": 0.9}),
    "stochastic_volatility": (16, 1000, 2500, {"target_accept": 0.9}),
    "garch": (16, 1000, 2500, {}),
    # FITC's ridge between ls and eta makes NUTS build trees of depth 5-7:
    # this run took 85 minutes on an 8-core CPU
    "sparse_fitc": (16, 1000, 2500, {}),
}


def _per_chain(trace, name):
    return np.stack(trace.get_values(name, combine=False)).astype(np.float64)


def _arrays(config, trace):
    """The gated quantities of a run as ``{name: (chains, draws, ...)}``:
    for the LKJ model ``mu`` and the implied covariance ``L Lᵀ``."""
    if config == "lkj":
        L = _per_chain(trace, "L")
        return {"mu": _per_chain(trace, "mu"),
                "cov": np.einsum("cdij,cdkj->cdik", L, L)}
    names = {"stochastic_volatility": ["sigma", "nu"],
             "garch": ["alpha1", "beta1", "omega"],
             "sparse_fitc": ["ls", "eta", "sigma"]}[config]
    return {n: _per_chain(trace, n) for n in names}


def _starts(model, trace, chains, draws, per_chain=16):
    """``chains * per_chain`` posterior draws as flat float32 vectors in
    the model's ordering, evenly spaced within each chain."""
    idx = np.linspace(100, draws - 1, per_chain).astype(int)
    return np.stack([model.dict_to_array(trace.point(int(i), chain=c))
                     for c in range(chains) for i in idx]).astype(np.float32)


# (N, d, batch, steps) of the minibatch-ADVI fits: the JAX package's
# benchmark (scripts/bench_advi_minibatch.py) and its wide configuration
ADVI_LOGISTIC = {"d100": (50_000, 100, 500, 10_000),
                 "d512": (50_000, 512, 8192, 2_000)}
# the GP fits: Adam in two stages of (steps, rate), the second with a new
# optimizer, and the Monte-Carlo samples of a step. With one stage at rate
# 0.01 and one sample, two seeds' fits differed by 1.5x in an sd; fifty
# samples a step (one batch of the covariance kernel on the card) let the
# stages be short
ADVI_GP = {"stages": {"advi": [[1000, 0.01], [1000, 0.001]],
                      "fullrank_advi": [[1500, 0.01], [1000, 0.001]]},
           "obj_n_mc": 50}
SEEDS = (1, 2)


def _fit_record(approx, wall):
    return {"mean": np.asarray(approx.mean, np.float64).tolist(),
            "std": np.asarray(approx.std, np.float64).tolist(),
            "last100_loss": float(np.mean(approx.hist[-100:])),
            "wall_s": wall}


def advi_logistic(pm):
    """ADVI with the default optimizer (adagrad_window) from the test point,
    once per seed and configuration, as the benchmark's timed fit runs."""
    from pymc3_tpu_torch.examples.suite import (advi_logistic_data,
                                                 advi_logistic_model)
    out = {}
    for name, (N, d, batch, steps) in ADVI_LOGISTIC.items():
        X, y, w_true = advi_logistic_data(N, d)
        model = advi_logistic_model(pm, X, y, batch)
        fits = []
        for seed in SEEDS:
            with model:
                inference = pm.ADVI()
            t0 = time.time()
            approx = inference.fit(n=steps, random_seed=seed,
                                   progressbar=False)
            fits.append(_fit_record(approx, time.time() - t0))
            w = model.array_to_dict(np.asarray(approx.mean))["w"]
            fits[-1]["coef_rmse"] = float(np.sqrt(np.mean((w - w_true) ** 2)))
        out[name] = {"N": N, "d": d, "batch": batch, "steps": steps,
                     "fits": fits}
    return out


def advi_gp(pm):
    """ADVI and full-rank ADVI on the suite's GP (n = 200), Adam in two
    stages; the second stage's seed is the first's plus 10."""
    from pymc3_tpu_torch.examples.suite import gp_regression
    out = dict(ADVI_GP)
    for method in ("advi", "fullrank_advi"):
        fits = []
        for seed in SEEDS:
            inference = (pm.ADVI if method == "advi" else pm.FullRankADVI)(
                model=gp_regression(pm)[0])
            t0 = time.time()
            for k, (steps, rate) in enumerate(ADVI_GP["stages"][method]):
                approx = inference.fit(
                    n=steps, random_seed=seed + 10 * k, progressbar=False,
                    obj_n_mc=ADVI_GP["obj_n_mc"],
                    obj_optimizer=pm.adam(learning_rate=rate))
            fits.append(_fit_record(approx, time.time() - t0))
        out[method] = fits
    return out


def map_radon(pm):
    """``find_MAP`` on radon from the test point, and ``find_hessian`` at
    that point (its diagonal and log-determinant: the matrix itself is
    175 x 175)."""
    from pymc3_tpu_torch.examples.radon import build_model
    model = build_model(pm)
    t0 = time.time()
    with model:
        point, res = pm.find_MAP(progressbar=False, return_raw=True)
    wall = time.time() - t0
    H = np.asarray(pm.find_hessian(point, model=model), np.float64)
    sign, logdet = np.linalg.slogdet(H)
    return {"q": np.asarray(model.dict_to_array(point), np.float64).tolist(),
            "neg_logp": float(res.fun), "iterations": int(res.nit),
            "scalars": {k: float(point[k]) for k in
                        ("mu_a", "sigma_a", "mu_b", "sigma_b", "eps")},
            "hessian_diag": np.diag(H).tolist(),
            "hessian_logdet": float(logdet), "hessian_sign": float(sign),
            "wall_s": wall}


# SMC on the GP: particles and seeds
SMC_GP = {"draws": 4096, "seeds": (1, 2, 3, 4)}


def _gp_prior_population(n, seed):
    """``n`` draws of the suite GP's priors (``ls ~ Gamma(2, 2)``, ``eta ~
    HalfNormal(2)``, ``sigma ~ HalfNormal(1)``) as unconstrained points.
    The JAX package's ``sample_forward`` would draw the observed
    200-dimensional MvNormal too (16 draws took 30 s on an 8-core CPU), so
    the initial population, the priors alone, is drawn with numpy and
    handed in as ``start``."""
    rng = np.random.RandomState(1000 + seed)
    ls = rng.gamma(2.0, 0.5, n)
    eta = np.abs(rng.normal(0.0, 2.0, n))
    sigma = np.abs(rng.normal(0.0, 1.0, n))
    return [{"ls_log__": np.log(a), "eta_log__": np.log(b),
             "sigma_log__": np.log(c)} for a, b, c in zip(ls, eta, sigma)]


def smc_gp(pm):
    """``sample_smc`` on the suite's GP at 4,096 particles, once per seed,
    from a prior population drawn with numpy: each run's evidence, stages
    and moments of ``ls``, ``eta`` and ``sigma``, and over the runs the
    mean and sd of each."""
    from pymc3_tpu_torch.examples.suite import gp_regression
    runs = []
    for seed in SMC_GP["seeds"]:
        t0 = time.time()
        trace = pm.sample_smc(
            draws=SMC_GP["draws"], model=gp_regression(pm)[0],
            random_seed=seed,
            start=_gp_prior_population(SMC_GP["draws"], seed))
        runs.append({
            "seed": seed, "wall_s": time.time() - t0,
            "log_marginal_likelihood": float(
                trace.report.log_marginal_likelihood),
            "mean": {v: float(np.mean(trace[v], dtype=np.float64))
                     for v in ("ls", "eta", "sigma")},
            "sd": {v: float(np.std(np.asarray(trace[v], np.float64)))
                   for v in ("ls", "eta", "sigma")}})
        print("smc_gp seed", seed, json.dumps(runs[-1]), flush=True)

    def spread(values):
        return {"mean": float(np.mean(values)),
                "sd": float(np.std(values, ddof=1))}
    return {"draws": SMC_GP["draws"], "runs": runs,
            "log_marginal_likelihood": spread(
                [r["log_marginal_likelihood"] for r in runs]),
            "mean": {v: spread([r["mean"][v] for r in runs])
                     for v in ("ls", "eta", "sigma")},
            "sd": {v: spread([r["sd"][v] for r in runs])
                   for v in ("ls", "eta", "sigma")}}


def _fitc_potential(X, y, Xu, jitter=5e-4):
    """The FITC log marginal likelihood of ``gp.py:317-360`` with eta^2
    Matern52(ls) covariances computed from the arguments (float32, the
    port's kernel formula t = sqrt(5 d^2 + 1e-12)). The jitter is the JAX
    package's 5e-4; the port's grows above it only past eta = 14.5, beyond
    the 99.9% quantile of this posterior."""
    import jax.numpy as jnp
    import jax.scipy.linalg as jsl
    x, u = jnp.asarray(X[:, 0]), jnp.asarray(Xu[:, 0])
    yv = jnp.asarray(y)

    def k(a, b, ls, eta):
        t = jnp.sqrt(5.0 * ((a[:, None] - b[None, :]) / ls) ** 2 + 1e-12)
        return eta ** 2 * (1.0 + t + t * t / 3.0) * jnp.exp(-t)

    def logp(ls, eta, sigma):
        Kuu, Kuf = k(u, u, ls, eta), k(u, x, ls, eta)
        Luu = jnp.linalg.cholesky(Kuu + jitter * jnp.eye(u.shape[0]))
        A = jsl.solve_triangular(Luu, Kuf, lower=True)
        Lamd = jnp.clip(eta ** 2 - jnp.sum(A * A, 0), 0, jnp.inf) \
            + sigma ** 2
        L_B = jnp.linalg.cholesky(jnp.eye(u.shape[0]) + (A / Lamd) @ A.T)
        r_l = yv / Lamd
        c = jsl.solve_triangular(L_B, A @ r_l, lower=True)
        logdet = 0.5 * jnp.sum(jnp.log(Lamd)) + jnp.sum(jnp.log(
            jnp.diag(L_B)))
        quad = 0.5 * (jnp.dot(yv, r_l) - jnp.dot(c, c))
        return -(0.5 * x.shape[0] * jnp.log(2 * jnp.pi) + logdet + quad)
    return logp


def sparse_fitc_model(pm):
    """The sparse notebook's model (``examples/suite.py``
    ``sparse_fitc_model``) with its likelihood as a ``Potential`` over the
    random hyperparameters."""
    from pymc3_tpu_torch.examples.suite import sparse_data
    X, y, Xu = sparse_data()
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=1)
        eta = pm.HalfCauchy("eta", beta=5)
        sigma = pm.HalfCauchy("sigma", beta=5)
        pm.Potential("y", pm.node.apply(_fitc_potential(X, y, Xu), ls, eta,
                                        sigma))
    return model


# chains, tune, draws, seeds and init of each GLM's runs. The unpooled
# model's flat intercept is its baseline county's (4 homes), and every
# county's coefficient is a difference from it: with a diagonal mass matrix
# NUTS built trees of mean depth 4.8 and split R-hat of the intercept was
# 1.024 and 1.047 after 1000 + 2000 at 8 chains; a dense mass matrix
# adapts to that correlation
GLM_RADON = {"chains": 8, "tune": 1000, "draws": 2000, "seeds": (1, 2),
             "init": {"pooled": "jitter+adapt_diag",
                      "unpooled": "jitter+adapt_full"}}


def arviz_gpdfit(x):
    """Zhang and Stephens' estimate of a generalized Pareto fit to the
    sorted tail ``x``, in ArviZ's order (the scale from k before the
    weakly informative prior moves it), in float64: ``(k, sigma)``."""
    n = len(x)
    m = 30 + int(np.sqrt(n))
    b = 1 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    b = b / (3.0 * x[int(n / 4 + 0.5) - 1]) + 1 / x[-1]
    k = np.log1p(-b[:, None] * x).mean(axis=1)
    ll = n * (np.log(-(b / k)) - k - 1)
    w = 1 / np.exp(ll - ll[:, None]).sum(axis=1)
    bp = np.sum(b * w / w.sum())
    kp = np.log1p(-bp * x).mean()
    return (n * kp + 5.0) / (n + 10.0), -kp / bp


def _ic(trace, model):
    """WAIC and LOO by the JAX package, LOO with :func:`arviz_gpdfit` in
    place of its ``_gpdfit`` (see the module's docstring), on the deviance
    scale as ``loo``/``waic`` default."""
    from pymc3_tpu import stats as jstats
    w = jstats.waic(trace, model)
    jax_loo_is_nan = bool(np.isnan(jstats.loo(trace, model).loo))
    fit, jstats._gpdfit = jstats._gpdfit, arviz_gpdfit
    try:
        lo = jstats.loo(trace, model, pointwise=True)
        ll = jstats._log_likelihood_matrix(trace, model)
        e = jstats.ess(trace)
        S = ll.shape[0]
        reff = np.nanmean(np.concatenate([np.ravel(v)
                                          for v in e.values()])) / S
        ks = jstats._psislw(-ll, reff)[1]
    finally:
        jstats._gpdfit = fit
    return {"waic": float(w.waic), "waic_se": float(w.waic_se),
            "p_waic": float(w.p_waic),
            "loo": float(lo.loo), "loo_se": float(lo.loo_se),
            "p_loo": float(lo.p_loo),
            "k_over_0.7": int((ks > 0.7).sum()),
            "jax_loo_is_nan": jax_loo_is_nan}


def glm_radon(pm):
    """Both radon GLMs at two seeds: moments over all chains, per-seed
    information criteria, and per seed d_loo = LOO(unpooled) - LOO(pooled)
    (negative when the unpooled model predicts better)."""
    from pymc3_tpu_torch.examples.suite import (chain_moments,
                                                 glm_radon_pooled,
                                                 glm_radon_unpooled)
    c = GLM_RADON
    out = dict(c)
    for label, build in (("pooled", glm_radon_pooled),
                         ("unpooled", glm_radon_unpooled)):
        arrays, runs = {}, []
        for seed in c["seeds"]:
            model, names = build(pm)
            t0 = time.time()
            trace = pm.sample(draws=c["draws"], tune=c["tune"],
                              chains=c["chains"], model=model,
                              random_seed=seed, init=c["init"][label],
                              progressbar=False,
                              compute_convergence_checks=False)
            wall = time.time() - t0
            for n in names:
                arrays.setdefault(n, []).append(_per_chain(trace, n))
            depth = np.asarray(trace.get_sampler_stats("depth"))
            runs.append({"seed": seed, "wall_s": wall,
                         "mean_tree_depth": float(depth.mean()),
                         "rhat": {n: float(np.max(pm.rhat(
                             _per_chain(trace, n))["x"])) for n in names},
                         **_ic(trace, model)})
            print("glm_radon", label, json.dumps(runs[-1]), flush=True)
        out[label] = {"runs": runs, "moments": chain_moments(
            pm, {n: np.concatenate(a) for n, a in arrays.items()})}
    out["d_loo"] = [u["loo"] - p["loo"] for u, p in
                    zip(out["unpooled"]["runs"], out["pooled"]["runs"])]
    out["d_waic"] = [u["waic"] - p["waic"] for u, p in
                     zip(out["unpooled"]["runs"], out["pooled"]["runs"])]
    return out


FITS = {"advi_logistic": advi_logistic, "advi_gp": advi_gp,
        "map_radon": map_radon, "smc_gp": smc_gp, "glm_radon": glm_radon}


def main():
    sys.path.insert(0, ROOT)
    import pymc3_tpu as pm
    from pymc3_tpu.examples import (LKJ_correlation, garch_example,
                                    stochastic_volatility)
    from pymc3_tpu_torch.examples.suite import chain_moments

    builders = {"lkj": LKJ_correlation.build_model,
                "stochastic_volatility": stochastic_volatility.build_model,
                "garch": garch_example.build_model,
                "sparse_fitc": lambda: sparse_fitc_model(pm)}
    names = sys.argv[1:] or list(RUNS) + list(FITS)
    configs = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            configs = json.load(f)["configs"]
    for config in names:
        if config in FITS:
            configs[config] = FITS[config](pm)
            print(config, "done", flush=True)
            _write(configs)
            continue
        chains, tune, draws, nuts = RUNS[config]
        model = builders[config]()
        t0 = time.time()
        trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                          random_seed=11, progressbar=False, nuts=nuts,
                          compute_convergence_checks=False)
        wall = time.time() - t0
        arrays = _arrays(config, trace)
        rhat = {n: float(np.max(pm.rhat(a)["x"])) for n, a in arrays.items()}
        n_div = int(np.sum(trace.get_sampler_stats("diverging")))
        configs[config] = {
            "chains": chains, "tune": tune, "draws": draws, "wall_s": wall,
            "divergences": n_div, "rhat": rhat,
            "moments": chain_moments(pm, arrays)}
        print(config, json.dumps({k: v for k, v in configs[config].items()
                                  if k != "moments"}), flush=True)
        if config == "stochastic_volatility":
            np.save(STARTS, _starts(model, trace, chains, draws))
        _write(configs)


def _write(configs):
    with open(OUT, "w") as f:
        json.dump({"backend": "cpu (stock XLA:CPU jaxlib), the JAX "
                   "package", "made_by": COMMAND,
                   "configs": configs}, f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
