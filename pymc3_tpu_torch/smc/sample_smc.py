"""SMC driver (cf. ``pymc3_tpu/smc/sample_smc.py``)."""
from __future__ import annotations

import logging
import time

from .smc import SMC

_log = logging.getLogger("pymc3_tpu_torch")

__all__ = ["sample_smc"]


def sample_smc(draws=1000, kernel="metropolis", n_steps=25, parallel=False,
               start=None, cores=None, tune_steps=True, p_acc_rate=0.99,
               threshold=0.5, epsilon=1.0, dist_func="absolute_error",
               sum_stat=False, progressbar=False, model=None,
               random_seed=-1, devices=None, mesh=None):
    """Sequential Monte Carlo sampling (cf. ``sample_smc``,
    ``sample_smc.py:19``): stages while β < 1, every particle on the model's
    device. Returns a MultiTrace whose ``report`` carries the accumulated
    log marginal likelihood. ``devices``/``mesh`` shard the particles over
    the ranks of a process group, every rank calling ``sample_smc`` alike
    and returning the same trace of all particles (see :class:`SMC`).
    ``dist_func`` and ``sum_stat`` are ignored, as in the JAX package."""
    smc = SMC(draws=draws, kernel=kernel, n_steps=n_steps, parallel=parallel,
              start=start, cores=cores, tune_steps=tune_steps,
              p_acc_rate=p_acc_rate, threshold=threshold, epsilon=epsilon,
              dist_func=dist_func, sum_stat=sum_stat,
              progressbar=progressbar, model=model, random_seed=random_seed,
              devices=devices, mesh=mesh)

    t1 = time.time()
    _log.info("Sample initial stage: ...")
    stage = 0
    smc.initialize_population()
    smc.setup_kernel()
    smc.initialize_logp()

    while smc.beta < 1:
        smc.update_weights_beta()
        _log.info(f"Stage: {stage:3d} Beta: {smc.beta:.3f} "
                  f"Steps: {smc.n_steps:3d} Acce: {smc.acc_rate:.3f}")
        smc.resample()
        smc.update_proposal()
        if stage > 0:
            smc.tune()
        smc.mutate()
        stage += 1

    trace = smc.posterior_to_trace()
    trace.report._n_draws = smc.draws
    trace.report._n_tune = 0
    trace.report._t_sampling = time.time() - t1
    trace.report.log_marginal_likelihood = smc.log_marginal_likelihood
    return trace
