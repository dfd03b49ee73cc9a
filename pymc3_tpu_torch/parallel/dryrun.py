"""Every sharded path of the port at tiny shapes over ``n`` ranks (cf. the
JAX package's ``__graft_entry__.py::dryrun_multichip``).

``dryrun_multichip(n)`` starts ``n`` ranks through :func:`parallel.launch`
(one per card by default; the tests pass ``devices=["cpu"] * n``). Each
rank runs, on a radon-shaped hierarchical model of 64 rows: a pooled NUTS
block through ``shard_chain_fn``, ``sample(devices=...)``,
``sample_smc(devices=...)``, five steps of sharded minibatch ADVI
(``sharded_step_function``) and ``fast_sample_posterior_predictive`` on the
sharded trace, checking shapes and finiteness. Run as a script it takes
``n`` from the first argument (default: every card).
"""
import sys

import numpy as np


def _flagship_model(pm):
    rng = np.random.default_rng(0)
    n_obs, n_counties = 64, 8
    county_idx = rng.integers(0, n_counties, n_obs).astype("int32")
    floor = rng.integers(0, 2, n_obs).astype(np.float32)
    y = rng.normal(size=n_obs).astype(np.float32)
    with pm.Model() as model:
        mu_a = pm.Normal("mu_a", 0.0, 10.0)
        sigma_a = pm.HalfCauchy("sigma_a", 5)
        a = pm.Normal("a", mu=mu_a, sigma=sigma_a, shape=n_counties)
        eps = pm.HalfCauchy("eps", 5)
        est = a[county_idx] + floor * 0.5
        pm.Normal("y", mu=est, sigma=eps, observed=y)
    return model


def _rank():
    import torch
    torch.set_num_threads(1)
    import pymc3_tpu_torch as pm
    from . import (CHAIN_AXIS, initialize_distributed, pooled_axes,
                    shard_chain_fn)
    from ..step_methods.arraystep import GeneratorNoise, TuneContext

    mesh = initialize_distributed()
    n = mesh.world_size
    model = _flagship_model(pm)
    step = pm.NUTS(model=model, axis_name=pooled_axes(CHAIN_AXIS))
    step.mesh = mesh
    chains, tune, draws = 2 * n, 3, 3
    gen = torch.Generator(device=mesh.device)
    gen.manual_seed(mesh.rank)
    noise = GeneratorNoise(gen, 2, mesh.device)

    def chain_fn(q0):
        q, st = q0, step.kernel_init(q0)
        qs, lps = [], []
        for idx in range(tune + draws):
            q, st, stats = step.kernel_step(
                q, st, TuneContext(idx < tune, idx, tune), noise)
            qs.append(q)
            lps.append(stats["model_logp"])
        return torch.stack(qs, 1), torch.stack(lps, 1)

    q0 = torch.as_tensor(model.dict_to_array(model.test_point),
                         device=mesh.device)
    qs, lps = shard_chain_fn(chain_fn, mesh=mesh)(q0.expand(chains, -1).clone())
    if qs.shape != (chains, tune + draws, q0.shape[0]):
        raise RuntimeError(f"shard_chain_fn gave {tuple(qs.shape)}")
    if not bool(torch.isfinite(lps).all()):
        raise RuntimeError("non-finite logp")

    trace = pm.sample(draws=4, tune=4, chains=chains, model=model,
                      devices=mesh, progressbar=False, random_seed=1,
                      block_size=4, compute_convergence_checks=False)
    if len(trace) != 4 or trace.nchains != chains:
        raise RuntimeError(f"sample gave {trace.nchains} x {len(trace)}")

    smc_trace = pm.sample_smc(draws=64 * n, n_steps=2, model=model,
                              random_seed=2, devices=mesh)
    if len(smc_trace) != 64 * n:
        raise RuntimeError(f"sample_smc gave {len(smc_trace)} draws")

    rng = np.random.default_rng(3)
    N = 64 * n
    vi_data = rng.normal(1.5, 1.0, N).astype(np.float32)
    with pm.Model() as vi_model:
        mu_v = pm.Normal("mu_v", 0.0, 10.0)
        pm.Normal("vi_obs", mu=mu_v, sigma=1.0,
                  observed=pm.Minibatch(vi_data, batch_size=16),
                  total_size=N)
    approx = pm.MeanField(model=vi_model)
    objective = pm.variational.operators.KL(approx)()
    step_fn, opt = objective.sharded_step_function(mesh=mesh, obj_n_mc=2)
    params = approx.params
    opt_state = opt.init(params)
    vi_gen = torch.Generator(device=mesh.device)
    vi_gen.manual_seed(7 + mesh.rank)
    for _ in range(5):
        params, opt_state, loss = step_fn(
            params, opt_state, objective.draw_noise(vi_gen, 2))
    if not np.isfinite(float(loss)):
        raise RuntimeError("sharded ADVI loss not finite")
    approx.params = params

    ppc = pm.fast_sample_posterior_predictive(trace, model=model,
                                              random_seed=5)
    if ppc["y"].shape[0] != len(trace) * trace.nchains \
            or not np.all(np.isfinite(ppc["y"])):
        raise RuntimeError("posterior predictive draws wrong")
    print(f"dryrun rank {mesh.rank} of {n} ok: {mesh.calls} collectives",
          flush=True)


def dryrun_multichip(n_devices, devices=None, backend=None, timeout=600):
    """Run the sharded paths over ``n_devices`` ranks (``cuda:0`` to
    ``cuda:n-1`` unless ``devices`` names others); raises
    ``parallel.RemoteWorkerError`` if a rank fails. Returns each rank's
    output."""
    from . import launch
    outs = launch(["-m", "pymc3_tpu_torch.parallel.dryrun", "--rank"],
                  n_devices, devices=devices, backend=backend,
                  timeout=timeout)
    for rank, out in enumerate(outs):
        if f"dryrun rank {rank} of {n_devices} ok" not in out:
            raise RuntimeError(f"rank {rank} did not finish:\n{out}")
    return outs


if __name__ == "__main__":
    if "--rank" in sys.argv[1:]:
        _rank()
    else:
        import torch
        n = int(sys.argv[1]) if len(sys.argv) > 1 \
            else torch.cuda.device_count()
        print("".join(dryrun_multichip(n)))
        print(f"dryrun_multichip({n}) ok")
