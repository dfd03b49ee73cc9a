"""Rank-side jobs of ``tests/test_torch_parallel.py``: each runs in every
rank of a gloo group on the CPU, started by ``parallel.launch``, and
saves what the test compares to ``<out>/rank<r>.pt``.

    python -m tests.torch_parallel_jobs pair OUT     (2 ranks)
    python -m tests.torch_parallel_jobs divide OUT   (4 ranks)

Imports the port only, never JAX.
"""
import os
import sys

import numpy as np
import torch

from . import torch_models  # noqa: F401  (asks the port for the CPU)
import pymc3_tpu_torch as pm
from pymc3_tpu_torch import parallel
from pymc3_tpu_torch.step_methods.arraystep import TuneContext
from pymc3_tpu_torch.step_methods.hmc import nuts as tnuts
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tqp

torch.set_num_threads(1)

#: global chains of the NUTS transitions, their seed and tuning draws
NUTS_CHAINS = 8
NUTS_SEED = 11
NUTS_TRANSITIONS = 30


def eight_schools(pm):
    y = np.array([28., 8., -3., 7., -1., 1., 18., 12.])
    s = np.array([15., 10., 16., 11., 9., 11., 10., 18.])
    with pm.Model() as m:
        mu = pm.Normal("mu", 0., 5.)
        tau = pm.HalfCauchy("tau", 5.)
        th = pm.Normal("th", 0., 1., shape=8)
        pm.Normal("obs", mu=mu + tau * th, sigma=s, observed=y)
    return m


def beta_bernoulli(pm):
    data = np.repeat([1, 0], [50, 50]).astype(np.int32)
    with pm.Model() as model:
        a = pm.Beta("a", 1.0, 1.0)
        pm.Bernoulli("y", a, observed=data)
    return model


def minibatch_model(pm, n=128):
    vi_data = np.random.default_rng(3).normal(1.5, 1.0, n).astype(np.float32)
    with pm.Model() as model:
        mu_v = pm.Normal("mu_v", 0.0, 10.0)
        pm.Normal("vi_obs", mu=mu_v, sigma=1.0,
                  observed=pm.Minibatch(vi_data, batch_size=16),
                  total_size=n)
    return model


def welford_data():
    """Per-chain draws of the merge cases: (8 chains, 50 draws, 3)."""
    return np.random.default_rng(0).normal(size=(8, 50, 3)).astype(
        np.float32)


def welford_states(data):
    """Each chain's diagonal and dense Welford accumulators over its
    draws."""
    chains, _, n = data.shape
    diag = tqp.welford_zeros(chains, n, "cpu")
    dense = tqp.welford_cov_zeros(chains, n, "cpu")
    for t in range(data.shape[1]):
        x = torch.from_numpy(data[:, t])
        diag = tqp.welford_add(diag, x)
        dense = tqp.welford_cov_add(dense, x)
    return diag, dense


def rescue_inputs():
    """A warmup window's end with chains 2 and 6 stuck and the best logp
    held by chains 5 and 7 (the donor is 5, the first by global index)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    grad = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    logp = torch.tensor([-5., -4., -9., -3., -np.inf, -1., -8., -1.])
    cnt = torch.tensor([0, 10, 95, 0, 50, 0, 92, 0], dtype=torch.int32)
    diverging = torch.zeros(8, dtype=torch.bool)
    return TuneContext(True, 99, 200), diverging, cnt, q, logp, grad


def nuts_transitions(mesh=None):
    """``NUTS_TRANSITIONS`` pooled tuning transitions of the small GP model
    over ``NUTS_CHAINS`` chains, this rank's rows of them, with the global
    chains' noise (``parallel.GlobalNoise``) and an adaptation window of
    10 draws (promotions at 10, 20 and 30); after the step-size probe.
    Returns the state after the first and after the last transition."""
    model = torch_models.gp_model(pm, n=20)
    n = model.ndim
    rng = np.random.RandomState(3)
    q0 = (model.dict_to_array(model.test_point)[None]
          + rng.uniform(-0.5, 0.5, (NUTS_CHAINS, n))).astype(np.float32)
    potential = tqp.QuadPotentialDiagAdapt(n, q0.mean(0), np.ones(n), 10,
                                           adaptation_window=10)
    step = pm.NUTS(model=model, max_treedepth=6, axis_name="chains",
                   potential=potential)
    step.mesh = mesh
    rows = slice(0, NUTS_CHAINS) if mesh is None \
        else mesh.local_rows(NUTS_CHAINS)
    gen = torch.Generator()
    gen.manual_seed(NUTS_SEED)
    noise = parallel.GlobalNoise(gen, NUTS_CHAINS, "cpu", rows)
    q = torch.from_numpy(q0[rows])
    step.step_size = tnuts.find_reasonable_eps(step, q, noise=noise)
    state = step.kernel_init(q)
    out = {}
    for i in range(NUTS_TRANSITIONS):
        q, state, stats = step.kernel_step(
            q, state, TuneContext(True, i, 100), noise)
        if i in (0, NUTS_TRANSITIONS - 1):
            out[i] = {"q": q.clone(), "eps": stats["step_size"].clone(),
                      "var": state.pot.var.clone(),
                      "log_step": state.da.log_step.clone(),
                      "depth": stats["depth"].clone()}
    out["probe_eps"] = step.step_size
    return out


def _values(trace, names):
    return {v: np.asarray(trace.get_values(v, combine=False)) for v in names}


def pair(mesh, where):
    out = {"calls_start": mesh.calls}
    diag, dense = welford_states(welford_data())
    rows = mesh.local_rows(8)
    out["diag"] = tqp.welford_merge_pooled(
        tqp.WelfordState(*[x[rows] for x in diag]), mesh)
    out["dense"] = tqp.welford_cov_merge_pooled(
        tqp.WelfordCovState(*[x[rows] for x in dense]), mesh)
    # the same through the JAX package's names: welford_init/_cov_init of
    # this rank's chains and the psum merges over pooled_axes(CHAIN_AXIS)
    local = welford_data()[rows]
    chains, draws, n = local.shape
    diag = tqp.welford_init(n, init_mean=torch.zeros(chains, n))
    dense = tqp.welford_cov_init(n, init_mean=torch.zeros(chains, n))
    for t in range(draws):
        x = torch.from_numpy(local[:, t])
        diag, dense = tqp.welford_add(diag, x), tqp.welford_cov_add(dense, x)
    axes = parallel.pooled_axes(parallel.CHAIN_AXIS)
    out["diag_psum"] = tqp.welford_merge_psum(diag, axes)
    out["dense_psum"] = tqp.welford_cov_merge_psum(dense, axes)
    tctx, diverging, cnt, q, logp, grad = rescue_inputs()
    out["rescue"] = tnuts._rescue(tctx, diverging[rows], cnt[rows], q[rows],
                                  logp[rows], grad[rows], mesh)
    out["nuts"] = nuts_transitions(mesh)

    model = eight_schools(pm)
    names = ["mu", "tau", "tau_log__"]
    trace = pm.sample(draws=300, tune=300, chains=8, model=model,
                      devices=mesh, axis_name="chains", progressbar=False,
                      random_seed=42, compute_convergence_checks=False)
    out["schools"] = _values(trace, names)
    out["schools_step_size"] = np.asarray(trace.get_sampler_stats(
        "step_size", combine=False))
    out["warm"] = [trace._straces[c].warmup_state for c in trace.chains]
    resumed = pm.sample(draws=5, tune=0, chains=8, model=model,
                        devices=mesh, axis_name="chains", progressbar=False,
                        random_seed=43, resume_from=trace,
                        compute_convergence_checks=False)
    out["resumed_step_size"] = np.asarray(resumed.get_sampler_stats(
        "step_size", combine=False))

    # a file backend, written by rank 0 alone, in a directory both share
    cwd = os.getcwd()
    os.chdir(where)
    try:
        written = pm.sample(draws=20, tune=20, chains=8, model=model,
                            devices=mesh, trace="text", progressbar=False,
                            random_seed=44, compute_convergence_checks=False)
        out["text"] = {"dir": os.path.join(os.path.abspath(where), "mcmc"),
                       "backend": type(written._straces[0]).__name__,
                       "values": _values(written, ["mu", "th"])}
    finally:
        os.chdir(cwd)

    smc = pm.sample_smc(2048, model=beta_bernoulli(pm), random_seed=2,
                        devices=mesh)
    out["smc_lml"] = smc.report.log_marginal_likelihood
    out["smc_a"] = np.asarray(smc.get_values("a"))

    approx = pm.MeanField(model=minibatch_model(pm))
    objective = pm.variational.operators.KL(approx)()
    step_fn, opt = objective.sharded_step_function(mesh=mesh, obj_n_mc=2)
    params = approx.params
    opt_state = opt.init(params)
    gen = torch.Generator()
    gen.manual_seed(7 + mesh.rank)
    noises, snapshots = [], [params]
    for _ in range(5):
        noises.append(objective.draw_noise(gen, 2))
        params, opt_state, loss = step_fn(params, opt_state, noises[-1])
        snapshots.append(params)
    out["advi"] = {"noise": noises, "params": snapshots,
                   "loss": float(loss)}
    out["calls"] = mesh.calls
    return out


def divide(mesh, where):
    """The chain and particle counts that do not divide among 4 ranks."""
    model = eight_schools(pm)
    out = {}
    try:
        pm.sample(draws=10, tune=10, chains=6, model=model, devices=mesh,
                  progressbar=False, compute_convergence_checks=False)
    except ValueError as e:
        out["sample"] = str(e)
    try:
        pm.sample_smc(1001, model=model, devices=mesh)
    except ValueError as e:
        out["smc"] = str(e)
    return out


if __name__ == "__main__":
    job, where = sys.argv[1], sys.argv[2]
    mesh = parallel.initialize_distributed()
    result = {"pair": pair, "divide": divide}[job](mesh, where)
    torch.save(result, os.path.join(where, f"rank{mesh.rank}.pt"))
    print(f"rank {mesh.rank}: {job} done", flush=True)
