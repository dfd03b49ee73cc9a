"""Reference posterior moments of the LKJ, stochastic-volatility and GARCH
examples, sampled by the JAX package on the CPU.

Not a test: it writes ``pymc3_tpu_torch/examples/reference_moments.json``
(mean, sd and MCSE per element, in ``BASELINE_CPU.json``'s shape), which
``chip_smoke.py`` reads through ``moment_check`` to gate the port's
posteriors on the card. Run from the repository root:

    JAX_PLATFORMS=cpu python tests/torch_reference.py [config ...]

With names (``lkj``, ``stochastic_volatility``, ``garch``) it runs those
configurations only and keeps the others already in the file; the file is
written after each configuration.

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
             "garch": ["alpha1", "beta1", "omega"]}[config]
    return {n: _per_chain(trace, n) for n in names}


def _starts(model, trace, chains, draws, per_chain=16):
    """``chains * per_chain`` posterior draws as flat float32 vectors in
    the model's ordering, evenly spaced within each chain."""
    idx = np.linspace(100, draws - 1, per_chain).astype(int)
    return np.stack([model.dict_to_array(trace.point(int(i), chain=c))
                     for c in range(chains) for i in idx]).astype(np.float32)


def main():
    sys.path.insert(0, ROOT)
    import pymc3_tpu as pm
    from pymc3_tpu.examples import (LKJ_correlation, garch_example,
                                    stochastic_volatility)
    from pymc3_tpu_torch.examples.suite import chain_moments

    builders = {"lkj": LKJ_correlation.build_model,
                "stochastic_volatility": stochastic_volatility.build_model,
                "garch": garch_example.build_model}
    names = sys.argv[1:] or list(RUNS)
    configs = {}
    if os.path.exists(OUT):
        with open(OUT) as f:
            configs = json.load(f)["configs"]
    for config in names:
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
        with open(OUT, "w") as f:
            json.dump({"backend": "cpu (stock XLA:CPU jaxlib), the JAX "
                       "package", "made_by": COMMAND,
                       "configs": configs}, f, indent=1)
            f.write("\n")


if __name__ == "__main__":
    main()
