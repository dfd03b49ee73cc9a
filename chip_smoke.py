#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own line; the first that fails ends the run with
a non-zero exit and no result line:

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the hand-written GP covariance kernel from ``pymc3_tpu_torch/csrc``
   (into ``build/kernels/``) and print the build time;
3. hold the kernel against its plain PyTorch version on the card (forward
   and gradients, five kinds, ragged and large shapes, d = 40 against a
   float64 truth) and time both;
4. GP marginal regression (``scripts/bench_suite.py::gp_model``, n = 200,
   500 tune + 500 draws, 4 chains) sampled by NUTS through the kernel;
   moment check against ``BASELINE_CPU.json`` and R-hat < 1.01;
5. the radon model of ``bench.py`` at 2048 chains with pooled adaptation,
   600 tune + 400 draws (tune cut from 1000 and draws from 500, to keep the
   whole run under 1000 s; ``PERF.md``); moment check of ``mu_a`` and
   R-hat < 1.01;
6. BEST (``scripts/bench_suite.py::best_model``, 47 + 42 rows, StudentT
   likelihoods) at 256 chains, pooled, 500 tune + 200 draws; moment check
   of ``difference_of_means`` and R-hat < 1.01; then the posterior
   predictive of both groups at all 51,200 draws on the card: shapes,
   finiteness, and the median of the ``drug`` draws against the posterior
   median of ``group1_mean`` within four Monte-Carlo standard errors;
7. the 3-component mixture (``pymc3_tpu_torch/examples/suite.py``, 1000
   rows, Dirichlet weights, ordered means, Gamma precisions) at 512
   chains, pooled, 500 tune + 200 draws; moment check of ``mu`` and R-hat
   < 1.01; the posterior predictive of ``x_obs`` at all 102,400 draws
   (mean and sd against the data's) and 100,000 prior predictive draws
   (weights on the simplex, means of ``mu`` and ``tau`` against their
   priors);
8. a JSON line describing every kernel, then the result line
   ``{"ok": true, "device": {...}}``.

Imports nothing of JAX or of the JAX package.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# forward / gradient tolerances of tests/test_pallas_ops.py:39-40, 62-65:
# the kernel and the plain version sum the same float32 terms in another
# order, and take expf/sqrtf where torch takes its own exp/sqrt
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_close(what, got, want, tol):
    err = (got.double() - want.double()).abs()
    bound = tol["atol"] + tol["rtol"] * want.double().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        fail(f"{what}: max |err| {float(err.max()):.3e} exceeds "
             f"rtol {tol['rtol']}, atol {tol['atol']}")
    return float(err.max())


def cuda_ms(fn, iters=50, warmup=3):
    """Median CUDA-event time of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_device():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    if not card:
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(f"card: {card}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return card


def phase_build(gp_cov):
    path, seconds, log = gp_cov.build()
    ptxas = " | ".join(line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line)
    print(f"build: {path.name} in {seconds:.1f} s; ptxas: {ptxas}",
          flush=True)


def _inputs(B, n, m, d, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, n, d, generator=g) * scale
    Xs = torch.randn(B, m, d, generator=g) * scale
    return X.cuda(), Xs.cuda()


def _apart(B, n, m, d, seed):
    """Inputs in disjoint boxes, every pair at distance >= 0.5: the
    closed-form backward (rowsum(w) X - w Xs) cancels where dK/dd2 is
    singular (matern12, exponential at r -> 0), as in the JAX package,
    whose own test keeps its points apart for the same reason."""
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(B, n, d, generator=g)
    Xs = torch.rand(B, m, d, generator=g) + 1.5
    return X.cuda(), Xs.cuda()


def phase_kernel(gp_cov, card):
    """Kernel against plain version: forward and d sum(sin K) / d(X, Xs)."""
    cases = [(kind, (4, 200, 200, 1)) for kind in gp_cov.STATIONARY_KINDS]
    cases += [("expquad", (1, 130, 5, 2)), ("matern52", (1, 4096, 4096, 4))]
    max_err = 0.0
    for i, (kind, (B, n, m, d)) in enumerate(cases):
        X, Xs = _inputs(B, n, m, d, seed=i)
        K = gp_cov.stationary_cov(X, Xs, kind)
        K_ref = gp_cov.stationary_cov_reference(X, Xs, kind)
        torch.cuda.synchronize()
        err = check_close(f"{kind} {B}x{n}x{m}x{d} forward", K, K_ref,
                          FWD_TOL)
        max_err = max(max_err, err)
        X, Xs = _apart(B, n, m, d, seed=i)
        grads = []
        for fn in (gp_cov.stationary_cov, gp_cov.stationary_cov_reference):
            Xg, Xsg = X.clone().requires_grad_(), Xs.clone().requires_grad_()
            torch.sin(fn(Xg, Xsg, kind=kind)).sum().backward()
            grads.append((Xg.grad, Xsg.grad))
        for name, a, b in zip(("dX", "dXs"), grads[0], grads[1]):
            check_close(f"{kind} {B}x{n}x{m}x{d} {name}", a, b, GRAD_TOL)
        print(f"kernel ok: {kind} B={B} n={n} m={m} d={d} "
              f"max|err| {err:.2e}", flush=True)

    # d = 40 against a float64 truth (the kernel keeps exact differences
    # where the JAX fallback switched to the matmul form above d = 32)
    X, Xs = _inputs(1, 64, 48, 40, seed=99, scale=0.2)
    for kind in gp_cov.STATIONARY_KINDS:
        K = gp_cov.stationary_cov(X, Xs, kind)
        truth = gp_cov.stationary_cov_reference(X.double(), Xs.double(), kind)
        max_err = max(max_err, check_close(f"{kind} d=40 vs float64", K,
                                           truth, FWD_TOL))
    print("kernel ok: d=40 against float64 truth, all kinds", flush=True)

    timings = {}
    for shape in ((4, 200, 200, 1), (1, 4096, 4096, 4)):
        X, Xs = _inputs(*shape, seed=7)
        ms = cuda_ms(lambda: gp_cov._launch("expquad", X, Xs))
        plain = cuda_ms(lambda: gp_cov.stationary_cov_reference(
            X, Xs, "expquad"))
        timings[shape] = (ms, plain)
        print(f"timing expquad B,n,m,d={shape}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms ({card})", flush=True)
    return max_err, timings


def _baseline():
    with open(os.path.join(ROOT, "BASELINE_CPU.json")) as f:
        return json.load(f)["configs"]


def _gate(pm, trace, names, ref, wall, label):
    from bench_suite import moment_check, posterior_moments
    check = moment_check(posterior_moments(pm, trace, names), ref)
    rhat = pm.rhat(trace, var_names=names)
    ess = pm.ess(trace, var_names=names)
    rhat_max = max(float(np.max(rhat[v])) for v in names)
    ess_min = min(float(np.min(ess[v])) for v in names)
    n_div = int(np.sum(trace.get_sampler_stats("diverging")))
    depth = ""
    if "depth" in trace.stat_names:
        # (chains, draws): a batched NUTS step lasts as long as its
        # deepest lane's tree
        d = np.stack(trace.get_sampler_stats("depth", combine=False,
                                             squeeze=False))
        depth = (f", mean tree depth {d.mean():.2f}, deepest lane "
                 f"{d.max(axis=0).mean():.2f}")
    print(f"{label}: wall {wall:.2f} s, min ESS {ess_min:.1f}, ESS/s "
          f"{ess_min / wall:.2f}, max R-hat {rhat_max:.4f}, divergences "
          f"{n_div}{depth}, moment check {check}", flush=True)
    if not check["pass"]:
        fail(f"{label} posterior moments disagree with BASELINE_CPU.json")
    if not rhat_max < 1.01:
        fail(f"{label} R-hat {rhat_max:.4f} >= 1.01")


def phase_gp(pm, gp_cov, draws=500, tune=500, chains=4):
    from bench_suite import gp_model
    with torch.device("cuda"):
        model, names = gp_model(pm)
    gp_cov.LAUNCHES = 0
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gp_cov.LAUNCHES
    print(f"gp: {launches} kernel launches during sample()", flush=True)
    if launches <= 0:
        fail("the GP main path never launched the gp_cov kernel")
    _gate(pm, trace, names, _baseline()["gp"]["moments"], wall, "gp")
    return launches


def phase_radon(pm, draws=400, tune=600, chains=2048):
    from pymc3_tpu_torch.examples.radon import build_model
    with torch.device("cuda"):
        model = build_model(pm)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2, target_accept=0.9,
                      axis_name="chains_local", trace=["mu_a"],
                      record_stats=["diverging"],
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    _gate(pm, trace, ["mu_a"], _baseline()["radon"]["moments"], wall,
          f"radon chains={chains} tune={tune} draws={draws}")


def _median_se(x, n_eff):
    """Standard error of a sample median: sqrt(pi/2) sd / sqrt(n_eff), with
    the sd read robustly from the interquartile range."""
    q1, q3 = np.quantile(x, [0.25, 0.75])
    return np.sqrt(np.pi / 2.0) * (q3 - q1) / 1.349 / np.sqrt(n_eff)


def phase_best(pm, draws=200, tune=500, chains=256):
    from bench_suite import best_model
    with torch.device("cuda"):
        model, names = best_model(pm)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      axis_name="chains_local",
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    _gate(pm, trace, names, _baseline()["best"]["moments"], wall,
          f"best chains={chains} tune={tune} draws={draws}")

    n = chains * draws
    t0 = time.time()
    ppc = pm.sample_posterior_predictive(trace, model=model, random_seed=3)
    pwall = time.time() - t0
    # the JAX package returns (samples, *observed shape) per observed var
    want = {"drug": (n, 47), "placebo": (n, 42)}
    got = {k: v.shape for k, v in ppc.items()}
    if got != want:
        fail(f"best predictive shapes {got}, expected {want}")
    if not all(np.isfinite(v).all() for v in ppc.values()):
        fail("best predictive draws are not all finite")
    # the median, not the mean: the StudentT has no variance where nu <= 2.
    # Each draw sits on its own posterior draw of group1_mean, so both
    # medians carry that variable's Monte-Carlo error (its ESS)
    g1 = trace.get_values("group1_mean", combine=True)
    ess = float(np.min(pm.ess(trace, var_names=["group1_mean"])
                       ["group1_mean"]))
    drug = ppc["drug"].ravel()
    tol = 4.0 * np.hypot(_median_se(drug, ess), _median_se(g1, ess))
    diff = abs(float(np.median(drug)) - float(np.median(g1)))
    print(f"best predictive: {n} draws x (47 + 42) in {pwall:.2f} s, all "
          f"finite; median drug {np.median(drug):.4f} against median "
          f"group1_mean {np.median(g1):.4f}, |diff| {diff:.4f} < tol "
          f"{tol:.4f}", flush=True)
    if not diff < tol:
        fail("best predictive median disagrees with the posterior")


def phase_mixture(pm, draws=200, tune=500, chains=512,
                  prior_samples=100_000):
    from pymc3_tpu_torch.examples.suite import mixture_model
    with torch.device("cuda"):
        model, names = mixture_model(pm)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      axis_name="chains_local",
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    _gate(pm, trace, names, _baseline()["mixture"]["moments"], wall,
          f"mixture chains={chains} tune={tune} draws={draws}")

    n = chains * draws
    x = model["x_obs"].data.astype(np.float64)
    t0 = time.time()
    ppc = pm.sample_posterior_predictive(trace, model=model, random_seed=3)
    pwall = time.time() - t0
    draws_x = ppc["x_obs"]
    if draws_x.shape != (n, x.size) or not np.isfinite(draws_x).all():
        fail(f"mixture predictive: shape {draws_x.shape}, expected "
             f"{(n, x.size)}, or draws not finite")
    mean = float(np.mean(draws_x, dtype=np.float64))
    sd = float(np.std(draws_x, dtype=np.float64))
    mean_tol = 4.0 * x.std() / np.sqrt(x.size)
    print(f"mixture predictive: {draws_x.size} values in {pwall:.2f} s; "
          f"mean {mean:.4f} against data {x.mean():.4f} (tol {mean_tol:.4f})"
          f", sd {sd:.4f} against data {x.std():.4f} (tol 5%)", flush=True)
    if not abs(mean - x.mean()) < mean_tol:
        fail("mixture predictive mean disagrees with the data")
    if not abs(sd / x.std() - 1.0) < 0.05:
        fail("mixture predictive sd disagrees with the data")

    t0 = time.time()
    prior = pm.sample_prior_predictive(samples=prior_samples, model=model,
                                       random_seed=4)
    prwall = time.time() - t0
    simplex = float(np.abs(prior["w"].sum(-1) - 1.0).max())
    # priors: mu ~ N(0, 10), tau ~ Gamma(1, 1) (mean 1, sd 1)
    z_mu = np.abs(prior["mu"].mean(0)) / (10.0 / np.sqrt(prior_samples))
    z_tau = np.abs(prior["tau"].mean(0) - 1.0) / (1.0 / np.sqrt(prior_samples))
    print(f"mixture prior predictive: {prior_samples} samples in "
          f"{prwall:.2f} s; max |sum(w) - 1| {simplex:.2e}; z of mean mu "
          f"{np.round(z_mu, 2).tolist()}, of mean tau "
          f"{np.round(z_tau, 2).tolist()}", flush=True)
    if not simplex < 1e-5:
        fail("mixture prior weights leave the simplex")
    if not (np.all(z_mu < 4.0) and np.all(z_tau < 4.0)):
        fail("mixture prior means disagree with the priors")


def main():
    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch.ops import gp_cov

    card = phase_device()
    phase_build(gp_cov)
    max_err, timings = phase_kernel(gp_cov, card)
    launches = phase_gp(pm, gp_cov)
    phase_radon(pm)
    phase_best(pm)
    phase_mixture(pm)
    print(f"phases 1-7: {time.time() - t_start:.1f} s", flush=True)

    ms, plain_ms = timings[(4, 200, 200, 1)]
    print(json.dumps({"kernels": [{
        "name": "stationary_cov",
        "route": "cuda",
        "source": "pymc3_tpu_torch/csrc/gp_cov.cu",
        "replaces": "pymc3_tpu/ops/pallas/gp_cov.py:110",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
