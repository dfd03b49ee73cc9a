#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on the GPU.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, each printing its own line; the first that fails ends the run with
a non-zero exit and no result line:

1. the card's name and power limit (nvidia-smi); TF32 off;
2. build the hand-written GP covariance kernels (forward and backward) from
   ``pymc3_tpu_torch/csrc`` into ``build/kernels/`` and print the build time;
3. hold each kernel against its plain PyTorch version on the card (five
   kinds, ragged, misaligned and large shapes, a stride-0 cotangent, d = 40
   against a float64 truth, close points against a float64 truth), then time
   both at the shapes the GP paths use: device time per launch (many
   launches between one pair of events, queued behind a sleeping stream so
   that they run back to back), the host's issue time per call, the plain
   version's device time, and the bound from the bytes moved; then the
   shapes of phases 21-22, FITC's (64, 20, 2000, 1) and (64, 20, 20, 1)
   matern52 both ways, SMC's (4096, 200, 200, 1), (4096, 20, 2000, 1) and
   (4096, 20, 20, 1) forward, the conditional's (500, 200, 200, 1) forward
   (phase 5's ``plot_gp_dist`` data), ``gp_example``'s (256, 60, 60, 1)
   both ways (phase 25), and a batch of 70,000 that the wrappers cut into two
   launches, each checked the same way; then phase 31's kernel part: the
   float64 builds of both kernels against their plain float64 versions at
   the GP's shapes and ragged ones, the backward twice bit for bit, and
   both timed twice with both bounds (``phase_kernel_f64``); the build
   lines also print each kernel's registers and spills (``-Xptxas -v``)
   and the static count of FP64 instructions in each float64 kernel's
   SASS;
4. GP marginal regression (``pymc3_tpu_torch/examples/suite.py``, n = 200,
   200 tune + 500 draws, 4 chains; tune cut from 500, then 300) sampled by NUTS
   through both kernels; moment check against ``BASELINE_CPU.json`` and
   R-hat < 1.02 (the phase's docstring says why);
5. GP prediction on the sampled model at the posterior mean:
   ``predict(diag=True, pred_noise=True)`` at 16,384 new inputs (a 200 x
   16,384 launch) and ``predict(diag=False)`` at 4,096 (200 x 4,096 and
   4,096 x 4,096 launches); launch counts, finiteness, positive variance,
   symmetry, the two calls' variances against each other, the same calls
   through the plain version, and the fit at the training inputs; then
   ``plot_gp_dist``'s data: 500 draws of ``gp.conditional("f_pred",
   Xnew)`` at 200 new inputs through ``sample_posterior_predictive`` over
   phase 4's trace (forward launches > 0, backward 0), and the 40 pairs of
   percentile ribbons computed on the card against ``np.percentile``;
6. the radon model of ``bench.py`` at 2048 chains with pooled adaptation,
   150 tune + 60 draws (tune cut from 1000 and draws from 500, then 120
   and 90, to keep the whole run inside its limit as phases were added;
   at 110 tune, 9 draws after the first adaptation window closes, R-hat
   was 1.0251;
   split R-hat - 1 grows as 1 / draws whatever the chain count: 1.0019 at
   200 draws, 1.0027 at 120, 1.0038 at 90, so about 1.0057 at 60;
   ``PERF.md``); moment check of ``mu_a`` and R-hat < 1.01. Since phase
   26 came, this run is that phase's: its 60 draws are drawn in two runs
   of 30 joined by a saved, loaded and resumed trace;
7. BEST (47 + 42 rows, StudentT likelihoods) at 256 chains, pooled, 100
   tune (cut from 150 with phase 25's logp+grad timings) + 150 draws; moment check of ``difference_of_means`` and R-hat <
   1.01; then the posterior predictive of both groups at all 38,400 draws
   on the card: shapes, finiteness, and the median of the ``drug`` draws
   against the posterior median of ``group1_mean`` within four Monte-Carlo
   standard errors;
8. the 3-component mixture (1000 rows, Dirichlet weights, ordered means,
   Gamma precisions) at 512 chains, pooled, 100 tune (cut from 150 with
   phase 25's logp+grad timings) + 70 draws (120 until
   the SMC phases came: R-hat 1.0043 there and 1.0051 at 90, so about
   1.0066 at 70); moment
   check of ``mu`` and R-hat < 1.01; the posterior predictive of ``x_obs``
   at all 35,840 draws (mean and sd against the data's) and 100,000 prior
   predictive draws (weights on the simplex, means of ``mu`` and ``tau``
   against their priors);
9. the coal-mining switchpoint model (``examples/disaster_model.py``, 111
   years) at 256 chains, 300 tune + 400 draws, with no ``step`` argument:
   ``sample()`` must compound a NUTS over the two rates with a Metropolis
   over the discrete switchpoint and record both steppers' statistics;
   posterior means and sds of all three variables against the model's exact
   posterior (closed form, float64), the switchpoint's mode exactly, R-hat <
   1.01 for the rates and < 1.05 for the switchpoint (a random walk); ms per
   logp-only and per logp+grad call at 256 chains;
10. eight binary indicators of a regression (``examples/suite.py``) at 1024
   chains, 200 draws, no tuning, no ``step``: ``BinaryGibbsMetropolis`` must
   be assigned; the inclusion probabilities against the enumeration of all
   256 states, each within four Monte-Carlo standard errors;
11. a 10-dimensional normal with an AR(1) covariance sampled by
   ``DEMetropolis`` as a population of 2048 chains, 500 tune + 1000 draws:
   ``sample()`` must step the population as one; means within four
   standard errors, marginal sds within 10%, R-hat < 1.05 (a random-walk
   population, not NUTS, so the looser limit);
12. the LKJ example (``examples/LKJ_correlation.py``: 200 rows, 3
   variables, ``LKJCholeskyCov`` with eta = 2, ``MvNormal(chol=...)``) under
   NUTS with ``init="jitter+adapt_full"`` pooled over 1024 chains, 100 tune
   + 150 draws: the dense mass matrix must have adapted; ``mu`` and ``L
   Lᵀ`` against the JAX package's reference run
   (``examples/reference_moments.json``, made by
   ``tests/torch_reference.py``), R-hat < 1.01, then the posterior
   predictive of ``obs`` against the data's mean and covariance;
13. stochastic volatility (``examples/stochastic_volatility.py``, 400
   steps) at 256 chains started at the reference run's posterior draws,
   depth cap 8, 20 tune (cut from 30 with phase 25's logp+grad timings)
   + 40 draws: ``sigma`` and ``nu`` against the
   reference, R-hat of ``nu`` < 1.15;
14. GARCH(1,1) (``examples/garch_example.py``) at 256 chains, depth cap 5,
   100 tune + 60 draws (cut from 200, then 100): the three parameters against the
   reference, R-hat < 1.25 (two of them trade off and mix slowly); then
   GARCH11's block length: logp+grad ms and peak device memory at 5,000
   returns, 256 and 2048 chains, for each length of ``GARCH_SWEEP``;
15. a latent GP of 100 inputs (``examples/suite.py::es_model``: its prior
   covariance is one launch of the forward kernel) under
   ``EllipticalSlice`` at 256 chains, 300 tune (cut from 1000) + 1300
   draws, against the
   exact Gaussian posterior; R-hat < 1.25;
16. six labels of known component means with Dirichlet weights under
   ``[ElemwiseCategorical, NUTS]`` at 1024 chains, 30 tune + 170 draws,
   against the enumeration of all 729 states; R-hat < 1.02;
17. minibatch ADVI on the JAX package's benchmark
   (``scripts/bench_advi_minibatch.py``) at half the benchmark's steps at
   d = 100: logistic regression on 50,000 rows at d = 100 with batches of
   500 (5,000 steps: the benchmark runs 10,000, as this phase did until
   phases 25-26 came, so its steps/s is not that script's run) and at d =
   512 with batches of 8192 (2,000 steps), each after a short warm fit; steps/s,
   host ms per step, the device's busy share over 20 steps, the ELBO and
   the coefficient RMSE; means and sds against two JAX fits
   (``examples/reference_moments.json``);
18. ADVI and full-rank ADVI on the GP (n = 200) through both covariance
   kernels, one forward and one backward launch per step, against two JAX
   fits; then ``sample(init="advi+adapt_diag")`` on BEST at 256 chains
   (ADVI for at most 500 steps, cut from 1000 with phase 25's logp+grad
   timings), gated as phase 7;
19. SVGD with 256 particles on a conjugate normal against its closed form;
   ``find_MAP`` and ``find_hessian`` on radon against the JAX package's;
   ``sample(init="map")`` on the conjugate normal against its closed form;
20. SMC on the JAX package's benchmark target (``scripts/bench_smc.py``:
   two bumps on a uniform square, 25 steps) at 65,536 and 1,048,576
   particles: the evidence against its closed form, the mode balance and
   each mode's moments, particle updates/s and host reads per stage;
21. ``sample_smc`` on the GP (n = 200) at 4,096 particles, one forward
   launch at (4096, 200, 200, 1) per mutation step, against
   ``BASELINE_CPU.json`` and the JAX package's SMC evidence; then SMC-ABC
   with a torch simulator against its pseudo-posterior;
22. FITC at the sparse notebook's width (2,000 inputs, 20 inducing points)
   sampled by ``sample_smc`` at 4,096 particles with six seeds, the
   forward kernel at (4096, 20, 2000, 1) and (4096, 20, 20, 1) each step,
   against the JAX package's NUTS run of the same model, within the
   spread of the six runs; then the FITC, latent, Student-T
   and Kronecker GPs' logp+grad at 64 points on the card against the CPU
   (FITC through both kernels at (64, 20, 2000, 1) and (64, 20, 20, 1);
   ``MarginalKron`` also against the dense ``Marginal``), and 10,000 prior
   draws of a latent f against K;
23. the bench suite's freefall ODE sampled by NUTS through the adaptive
   DOPRI5 solve (64 chains from jittered test points, tune 150 + draws
   150) against ``BASELINE_CPU.json``, R-hat < 1.01; logp+grad at
   2, 16 and 256 chains through the solve's CUDA graphs, and at 64 chains
   eagerly (the same numbers); the posterior predictive of ``Y``; the SIR
   model's logp+grad at 64 points against the CPU;
24. the pooled and unpooled radon GLMs (``GLM.from_formula``, 256 chains
   from jittered test points, each adapting its own mass matrix, the
   unpooled one a dense one; tune 100 and 150 + draws 150) against the JAX
   package's runs, R-hat < 1.01; ``loo`` and ``waic`` of
   both on the card (the pointwise log likelihood against the CPU's, the
   unpooled model ranked first, d_loo within the reference runs' noise);
   ``rhat_device``/``ess_device`` against float64 numpy, timed beside the
   host's; in an eighth worker process started before phase 19 and read
   here (in the main process under ``--only glm``), so its wall runs
   beside phases 19-23 instead of after them (for the time limit: the
   script took 1220.7 s with phase 24 in the main process on the slowest
   host seen);
25. the fifteen examples of ``tests/test_examples.py``
   (``pymc3_tpu_torch/examples/``), each at its own data width through its
   own entry point (``sample()`` at 256 chains, tune 100 + draws 50, or
   ``pm.fit``), in three worker processes started after phase 5, beside
   phases 7-24: against their closed
   forms (``factor_potential``,
   ``samplers_mvnormal``), the JAX package's reference runs or two JAX
   fits (``minibatch_advi_logistic``); ``gp_example`` runs both covariance
   kernels at (256, 60, 60, 1); each example's wall (beside the other
   processes) and, once the workers have exited, its ms per logp+grad in
   the main process;
26. the trace backends: phase 6's radon run, its 2048 chains sampled for
   tune 150 + draws 30 with every free variable recorded, saved by
   ``save_trace``, read by ``load_trace`` and continued by
   ``sample(tune=0, draws=30, resume_from=...)``: the step sizes and the
   mass matrix carried exactly, the 60 draws (their energies recorded
   for phase 29) gated as phase 6, the save and load walls and bytes; then ``gelman_schools`` at 256 chains by
   ``Metropolis`` into NDArray, ``trace="text"`` and ``trace="sqlite"``,
   read back equal; all in a fourth worker process started with phase
   25's (in the main process under ``--only``);
27. several ranks on the card (``pymc3_tpu_torch.parallel``), started by
   ``parallel.launch`` from a fifth worker process (in the main process
   under ``--only``): two gloo ranks on ``cuda:0`` first check that gloo
   sums, maximises, minimises and broadcasts CUDA tensors; then 30 pooled
   tuning transitions of radon at 2048 chains, two ranks of 1024 with the
   global chains' noise against one process over all 2048, equal within
   the phase's stated tolerance; radon sharded over the two ranks
   (``sample(devices=..., axis_name=...)``, tune 150 + draws 60) gated as
   phase 26, its step size and mass matrix bit-equal on both ranks and its
   trace the same on both; SMC on the GP at 4,096 particles over the two
   ranks, one forward launch at (2048, 200, 200, 1) per rank and mutation
   step, gated as phase 21; phase 17's d = 100 minibatch ADVI for 5,000
   steps through ``sharded_step_function``, batches of 500 per rank,
   parameters bit-equal on both ranks, gated by phase 17's gate against
   the JAX package's sharded fits of the same setting; then
   ``gelman_schools`` through a one-rank NCCL group at phase 25's settings
   and gate. A rank that fails ends the script with its traceback;
28. AEVB and the model-core surface, in a sixth worker process (in the
   main process under ``--only aevb``): the amortized fit of
   ``tests/test_aevb.py::test_vae`` at ``scripts/bench_advi_minibatch.py``'s
   width (50,000 rows, batches of 500, an encoder ``mu = w x + b`` on the
   rows ``Minibatch.indices`` gives each sample's draw, Adam at 0.02 for
   3,000 steps, two samples a step), its steps/s and its ``w``, ``b`` and
   ``sigma`` against the closed-form optimum (100/101, 0, sqrt(1/101))
   within a tolerance from five JAX fits of the same settings; trainable
   local groups through ADVI and full-rank ADVI; a rowwise full-rank group
   at (4, 3) against N(0, s^2) and its covariance block diagonal; radon
   with ``coords``/``dims`` and ``Deterministic("a_range", a.max() -
   a.min())`` at 256 chains (tune 150 + draws 60) into InferenceData,
   dims and the 85 county names checked, ``mu_a`` gated as phase 6, the
   factors' ``logp`` summed against the model's, and a ``grad_vars``
   subset at 2048 chains against the full gradient's columns; 100,000
   prior draws of a ``DensityDist`` through a host generator
   (``generate_samples(stats.norm.rvs, ...)``), on the card, against
   their closed form;
29. the plots and the model graph, in phase 26's worker right after it
   (after it in the main process under ``--only plots``), on its radon
   trace (2048 chains, 60 draws, 175 scalars), no new sampling: the data
   function of ``traceplot`` (a KDE for each of 358,400 chains and
   scalars), ``plot_posterior``, ``forestplot``, ``densityplot`` and
   ``autocorrplot`` over every scalar, ``energyplot``'s over the chains'
   energies and ``pairplot``'s over the five hyper-parameters, each timed
   (wall, series per second) and run again on 64 chains on the card and
   on the CPU, equal within the CPU tests' tolerance; ``ModelGraph`` of the
   model built on the card, its parents and plates against a literal.
   Nothing is drawn: the card's machine has no matplotlib;
30. the JAX package's call forms, in the main process after phase 19
   (``phase_api``): ``random()`` as numpy float64 at 1,000,000 draws, radon's
   ``logp_dlogp_function()`` at one numpy point against row 0 of the batched
   call, scipy's L-BFGS-B through ``f(q, grad_out=g)`` against the JAX
   package's optimum, ``make_logp_fn(jacobian=False)``, the dtypes of
   ``sample_prior_predictive`` and ``draw_values`` with a distribution; its
   wall within 10 s; then the forms repaired after them: ``pm.math.eye``
   in a logp on the card (dtype and device), ``outer`` and ``full_like`` of
   card tensors, a per-axis ``Minibatch`` through one ADVI step, and a
   model that factors a covariance of its parameter with
   ``pm.math.cholesky`` sampled with its non-positive-definite region
   counted as divergences (``_api_repaired``), within
   ``API_REPAIRED_WALL_S``;
31. float64 (``phase_float64``), in a worker process started before phase
   14 with ``PYMC3_TPU_FLOATX=float64`` in its environment (in the main
   process under ``--only float64``): the GP of phase 4 through both
   float64 kernels (launches counted, both above 0), radon at 2048 chains
   and phase 20's SMC at 65,536 particles, gated as phases 4, 26 and 20
   but R-hat < 1.01 for the GP (its draws doubled to 1,000 for that); the
   GP's and radon's ESS/s and logp+grad ms at float64 beside phase 4's
   and 26's float32 numbers and float32 logp+grad ms timed in the same
   worker; then the families the GP, radon and SMC leave out, each with its
   float32 phase's gate and float64 draws: phase 17's d = 100 minibatch
   ADVI with adam, adamax, adagrad_window and sgd (1,000 steps each,
   against JAX fits of the same settings), the freefall ODE's logp+grad
   through its CUDA graphs at 2 and 64 chains against the eager path,
   phase 24's pooled GLM (100 draws), phase 9's switchpoint model (tune
   600 + draws 300), phase 11's population and phase 10's indicators; each
   wall and logp(+grad) ms beside the float32 phase's wall and the float32
   ms timed in the worker;
32. a JSON line describing every kernel (the float64 entry points beside
   the float32 ones), then the result line ``{"ok": true, "device":
   {...}}``.

Phases 9-31 each print a JSON line of their own (each with the card's name
and power limit, and its ms per logp+grad or logp-only call or per VI
step). Every model is built with no device argument and must come out on
the card: that is the port's default.

Three shorter runs serve measurement; none prints the result line:

    python3 chip_smoke.py --quick [--against DIR]
    python3 chip_smoke.py --gp-wall DIR
    python3 chip_smoke.py --only lkj,sv,garch,es,labels

``--quick`` runs phases 1-3 and phase 5 at the model's test point (no
sampling). With ``--against DIR``, a checkout of another commit, it also
times that commit's kernels in the same call, both directions in float32
and (from a checkout with float64 kernels) in float64, in turns (other,
this, this, other). ``--gp-wall DIR`` runs phase 4 alone in four fresh processes
(DIR, this, this, DIR) and prints each wall. ``--only NAMES`` runs phases
1-3 and then the named ones of phases 6-31 (radon, best, mixture, disaster,
binary, population, lkj, sv, garch, es, labels, advi_minibatch, advi_gp,
svgd_map, api, smc_bimodal, smc_gp, gp_sparse, ode, glm, examples, traces,
multirank, aevb, float64, plots; ``radon`` runs phase 26, which holds phase
6's run; ``plots`` runs phase 26, then phase 29; ``float64`` prints phase
4's float32 ESS/s as null, and phase 26's too unless ``radon`` ran
first).

Imports nothing of JAX or of the JAX package.
"""
import argparse
import importlib.util
import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

# forward / gradient tolerances of tests/test_pallas_ops.py:39-40, 62-65:
# a kernel and its plain version sum the same float32 terms in another
# order, and take expf/sqrtf where torch takes its own exp/sqrt
FWD_TOL = dict(rtol=2e-5, atol=2e-6)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)

# NVIDIA H100 SXM data sheet: device memory rate, float32 and float64 rates
# outside the tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
PEAK_F64_FLOPS = 34e12
# FP64 instructions a float64 expquad element costs beyond d2, forward
# (f = exp(-d2 / 2): a multiply and exp) and backward (w = g f'(d2): two
# multiplies and exp). CUDA's double exp runs on the FP64 pipes (the SFU
# has no double path): a reduction by rint(x log2 e) and two fused
# multiply-adds against a split ln 2, a degree-11 polynomial by Horner's
# rule and a scale, about 16 instructions (a lower count than the 20-25 the
# compiled kernels' SASS holds, so the bound stays a bound). The build line
# prints the static FP64 count of each float64 kernel's SASS beside it.
F64_EXP_OPS = 16
F64_EXPQUAD_OPS = {"forward": 1 + F64_EXP_OPS, "backward": 2 + F64_EXP_OPS}

SOURCE = "pymc3_tpu_torch/csrc/gp_cov.cu"
LATER_PHASES = ("best", "mixture", "disaster", "binary",
                "population", "lkj", "sv", "garch", "es", "labels",
                "advi_minibatch", "advi_gp", "svgd_map", "api",
                "smc_bimodal", "smc_gp", "gp_sparse", "ode", "glm",
                "examples", "traces", "multirank", "aevb", "float64")
MAIN_SHAPE = (4, 200, 200, 1)
# the GP's sample(), predict's two widths, ADVI's fifty Monte-Carlo samples
# a step (phase 18), SMC's 4,096 particles on the GP (phase 21), and FITC's
# cross-covariance and inducing covariance (matern52) over 64 chains and
# over 4,096 particles (phase 22)
VI_SHAPE = (50, 200, 200, 1)
FITC_SHAPE = (64, 20, 2000, 1)
SMC_SHAPE = (4096, 200, 200, 1)
# gp_example's sample() at phase 25's 256 chains over its 60 inputs
EXAMPLE_SHAPE = (256, 60, 60, 1)
# phase 27: each of two ranks holds half of SMC's 4,096 particles
MULTIRANK_SHAPE = (2048, 200, 200, 1)
# phase 5's plot_gp_dist data: the conditional's covariances over 500
# posterior draws at the 200 training and 200 new inputs
GP_DIST_SHAPE = (500, 200, 200, 1)
FITC_SHAPES = (FITC_SHAPE, (64, 20, 20, 1), (4096, 20, 2000, 1),
               (4096, 20, 20, 1))
TIMED_SHAPES = (MAIN_SHAPE, (1, 4096, 4096, 4), (1, 200, 16384, 1),
                (1, 200, 4096, 1), VI_SHAPE, SMC_SHAPE,
                EXAMPLE_SHAPE, MULTIRANK_SHAPE, GP_DIST_SHAPE) + FITC_SHAPES
TIMED_KIND = {shape: "matern52" for shape in FITC_SHAPES}
# a batch above the 65,535 blocks of gridDim.z: the wrappers cut it
CHUNKED_SHAPE = (70_000, 8, 8, 1)
# phase 31: the float64 kernels' checked and timed shapes and tolerances
# (max |Δ| over max |want|, see phase_kernel_f64)
F64_SHAPES = (MAIN_SHAPE, VI_SHAPE, (1, 4096, 4096, 4), FITC_SHAPE,
              CHUNKED_SHAPE)
F64_TIMED = (MAIN_SHAPE, VI_SHAPE, (1, 4096, 4096, 4))
# the backward's two runs compared bit for bit: the launcher's plans with
# one and with two column tiles a block
F64_REPEAT = (MAIN_SHAPE, (1, 4096, 4096, 4))
F64_FWD_REL = 1e-12
F64_BWD_REL = 1e-10


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check_close(what, got, want, tol, scale=1.0):
    """|got - want| <= atol * scale + rtol * |want| everywhere; returns the
    largest absolute error."""
    err = (got.double() - want.double()).abs()
    bound = tol["atol"] * scale + tol["rtol"] * want.double().abs()
    if not bool(torch.isfinite(got).all()) or bool((err > bound).any()):
        fail(f"{what}: max |err| {float(err.max()):.3e} exceeds "
             f"rtol {tol['rtol']}, atol {tol['atol'] * scale:.1e}")
    return float(err.max())


def device_ms(fn, launches=200, warmup=5):
    """Device time of one call of ``fn`` in milliseconds: ``launches`` calls
    between one pair of events, queued while the stream sleeps so that they
    run back to back, one synchronise at the end. Two results are kept
    alive in turn, so successive calls write alternating buffers and a large
    output does not stay in the 50 MB L2."""
    keep = [None, None]
    for i in range(warmup):
        keep[i % 2] = fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(60_000_000)       # about 30 ms of device time
    start.record()
    for i in range(launches):
        keep[i % 2] = fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def issue_ms(fn, calls=200, warmup=5):
    """Host clock per un-synchronised call of ``fn`` in milliseconds."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * dt / calls


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


def _sass_fp64_counts(path, kinds):
    """FP64 instructions (DADD, DMUL, DFMA, the 64-bit MUFU seeds) in the
    SASS of each float64 kernel by kind, vector stores, d = 1 for the
    backward: a static count over a thread's outputs and its unrolled
    loops, to set beside ``F64_EXPQUAD_OPS``. The name ends in the flat
    forward's stores (2: vector) and the backward's features (1).
    None where ``cuobjdump`` is missing."""
    import re
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True).stdout
    counts = {}
    for body in sass.split("Function : ")[1:]:
        name = body.split("\n", 1)[0]
        # the shared kernels in double (d = 1 for the backward), the flat
        # forward (vector stores) and the float64 backward (d = 1)
        hit = re.search(r"cov_(forward_small|forward_tiled|backward_regs)"
                        r"_kernelILi(\d)E(?:Lb1E|Li1E)dE()", name) or \
            re.search(r"cov_(forward_flat_f64)ILi(\d)ELi(2)E", name) or \
            re.search(r"cov_(backward_f64)_kernelILi(\d)ELi(1)E", name)
        if hit:
            kind = f"{hit.group(1)}{hit.group(3)}_{kinds[int(hit.group(2))]}"
            counts[kind] = len(re.findall(
                r"\b(?:DADD|DMUL|DFMA|MUFU\.(?:RSQ64H|RCP64H))\b", body))
    return counts


def _ptxas_table(log):
    """Registers and spill bytes of each kernel in ``nvcc -Xptxas -v``'s
    output, by demangled name (``c++filt`` where the toolkit has it):
    ``{name: [registers, spill stores, spill loads]}``."""
    import re
    table, name = {}, None
    for line in log.splitlines():
        hit = re.search(r"Compiling entry function '(\S+)'", line)
        if hit:
            name = hit.group(1)
            table[name] = [None, 0, 0]
            continue
        hit = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        line)
        if hit and name:
            table[name][1:] = [int(hit.group(1)), int(hit.group(2))]
        hit = re.search(r"Used (\d+) registers", line)
        if hit and name:
            table[name][0] = int(hit.group(1))
    tool = shutil.which("c++filt")
    if tool and table:
        names = subprocess.run([tool], input="\n".join(table),
                               capture_output=True, text=True).stdout.split(
                                   "\n")
        table = {re.sub(r"\(anonymous namespace\)::|\(.*$", "", pretty):
                 row for pretty, row in zip(names, table.values())}
    return table


def phase_build(gp_cov):
    paths, seconds, log = gp_cov.build()
    print(f"build: {', '.join(p.name for p in paths.values())} in "
          f"{seconds:.1f} s (two nvcc runs at once)", flush=True)
    table = _ptxas_table(log)
    for label, keep in (("float32", lambda k: "double" not in k),
                        ("float64", lambda k: "double" in k
                         or "_f64" in k)):
        print(f"ptxas {label} [registers, spill stores, spill loads]: "
              + json.dumps({k: v for k, v in table.items() if keep(k)}),
              flush=True)
    print("sass fp64 instructions (static, float64 kernels): "
          + json.dumps(_sass_fp64_counts(paths[torch.float64],
                                         gp_cov.STATIONARY_KINDS)),
          flush=True)


def _inputs(B, n, m, d, seed, scale=1.0):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(B, n, d, generator=g) * scale
    Xs = torch.randn(B, m, d, generator=g) * scale
    return X.cuda(), Xs.cuda()


def _apart(B, n, m, d, seed):
    """Inputs in disjoint boxes, every pair at distance >= 0.5: the plain
    backward (rowsum(w) X - w Xs) cancels where dK/dd2 is singular
    (matern12, exponential at r -> 0), as in the JAX package, whose own
    test keeps its points apart for the same reason."""
    g = torch.Generator().manual_seed(seed)
    X = torch.rand(B, n, d, generator=g)
    Xs = torch.rand(B, m, d, generator=g) + 1.5
    return X.cuda(), Xs.cuda()


def _cotangent(B, n, m, seed):
    g = torch.Generator().manual_seed(1000 + seed)
    return torch.randn(B, n, m, generator=g).cuda()


def _check_forward(gp_cov, kind, shape, seed):
    X, Xs = _inputs(*shape, seed=seed)
    K = gp_cov.stationary_cov(X, Xs, kind)
    K_ref = gp_cov.stationary_cov_reference(X, Xs, kind)
    torch.cuda.synchronize()
    return check_close(f"{kind} {shape} forward", K, K_ref, FWD_TOL)


def _check_backward(gp_cov, kind, shape, seed):
    """The backward kernel against its plain version on one cotangent, and
    the whole op's gradients through autograd against the plain op's."""
    B, n, m, d = shape
    X, Xs = _apart(B, n, m, d, seed=seed)
    g = _cotangent(B, n, m, seed)
    got = gp_cov._launch_backward(kind, g, X, Xs)
    want = gp_cov.stationary_cov_backward_reference(g, X, Xs, kind)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, b in zip(("dX", "dXs"), got, want):
        err = max(err, check_close(f"{kind} {shape} backward {name}", a, b,
                                   GRAD_TOL))
    grads = []
    for fn in (gp_cov.stationary_cov, gp_cov.stationary_cov_reference):
        Xg, Xsg = X.clone().requires_grad_(), Xs.clone().requires_grad_()
        torch.sin(fn(Xg, Xsg, kind=kind)).sum().backward()
        grads.append((Xg.grad, Xsg.grad))
    for name, a, b in zip(("dX", "dXs"), grads[0], grads[1]):
        check_close(f"{kind} {shape} autograd {name}", a, b, GRAD_TOL)
    return err


def _bounds(direction, shape, dtype=torch.float32):
    """The two least times the card could take, in ms: each input read once
    and each output written once at the memory rate, and the operations at
    their peak for the element type. In float32, FLOPs against the float32
    rate (expf on the SFU, outside it); in float64, the expquad kernel's
    FP64 instructions (each takes the slot of a fused multiply-add, two
    FLOPs of the FP64 rate; exp among them, ``F64_EXPQUAD_OPS``)."""
    B, n, m, d = shape
    small = B * (n + m) * d
    size = torch.empty((), dtype=dtype).element_size()
    if direction == "forward":
        nbytes = size * (B * n * m + small)     # K out; X, Xs in
    else:
        nbytes = size * (B * n * m + 2 * small)  # g, X, Xs in; dX, dXs out
    if dtype == torch.float64:
        # a difference and a fused multiply-add a feature for d2; in the
        # backward also two fused multiply-adds a feature for the sums
        per = (2 if direction == "forward" else 4) * d \
            + F64_EXPQUAD_OPS[direction]
        by_ops = 1e3 * 2 * B * n * m * per / PEAK_F64_FLOPS
    else:
        flops = B * n * m * ((3 * d + 4) if direction == "forward"
                             else (7 * d + 6))  # d2, f or f', the sums
        by_ops = 1e3 * flops / PEAK_F32_FLOPS
    return 1e3 * nbytes / PEAK_BYTES_PER_S, by_ops


def _bound_ms(direction, shape, dtype=torch.float32):
    """The larger of :func:`_bounds`: (ms, "bytes" | "operations")."""
    by_bytes, by_ops = _bounds(direction, shape, dtype)
    return ((by_bytes, "bytes") if by_bytes >= by_ops
            else (by_ops, "operations"))


def _load_other(path):
    """The ``ops/gp_cov.py`` of another checkout, as a module of its own
    (it builds its kernel under that checkout)."""
    file = os.path.join(path, "pymc3_tpu_torch", "ops", "gp_cov.py")
    spec = importlib.util.spec_from_file_location("other_gp_cov", file)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.build()
    return mod


def _time_kernels(gp_cov, card, other=None):
    """Device, issue and plain times of both kernels at the timed shapes."""
    rows = {"forward": {}, "backward": {}}
    for shape in TIMED_SHAPES:
        B, n, m, d = shape
        kind = TIMED_KIND.get(shape, "expquad")
        X, Xs = _inputs(*shape, seed=7)
        g = _cotangent(B, n, m, 7)
        # the plain backward holds a (B, n, m, d) difference tensor: fewer
        # launches where that is hundreds of MB
        plain_n = 20 if n * m > 1_000_000 or B * n * m > 10_000_000 else 100
        calls = {
            "forward": (lambda: gp_cov._launch(kind, X, Xs),
                        lambda: gp_cov.stationary_cov_reference(
                            X, Xs, kind)),
            "backward": (lambda: gp_cov._launch_backward(kind, g, X, Xs),
                         lambda: gp_cov.stationary_cov_backward_reference(
                             g, X, Xs, kind)),
        }
        for direction, (kernel, plain) in calls.items():
            bound, by = _bound_ms(direction, shape)
            row = dict(device_ms=device_ms(kernel), issue_ms=issue_ms(kernel),
                       plain_ms=device_ms(plain, launches=plain_n),
                       plain_issue_ms=issue_ms(plain, calls=plain_n),
                       bound_ms=bound, bound_by=by)
            if other is not None:
                old = ((lambda: other._launch(kind, X, Xs))
                       if direction == "forward" else
                       (lambda: other._launch_backward(kind, g, X, Xs)))
                turns = [(device_ms(f), issue_ms(f))
                         for f in (old, kernel, kernel, old)]
                for key, (a, b) in (("other", (0, 3)), ("this", (1, 2))):
                    row[f"{key}_device_ms"] = [turns[a][0], turns[b][0]]
                    row[f"{key}_issue_ms"] = [turns[a][1], turns[b][1]]
            rows[direction][shape] = row
            share = row["bound_ms"] / row["device_ms"]
            print(f"timing {kind} {direction} B,n,m,d={shape}: "
                  + json.dumps(row) + f" share_of_bound {share:.3f} "
                  f"({card})", flush=True)
    return rows


def phase_kernel(gp_cov, card, other=None):
    """Each kernel against its plain version, then the timings. Returns the
    largest absolute error per direction and the timing rows."""
    # MAIN_SHAPE runs the small forward; VI_SHAPE the tiled forward and the
    # backward's two-subtile plan with a ragged last row block at d = 1
    cases = [(kind, shape) for shape in (MAIN_SHAPE, VI_SHAPE)
             for kind in gp_cov.STATIONARY_KINDS]
    cases += [("expquad", (1, 130, 5, 2)), ("matern52", (1, 4096, 4096, 4)),
              # m and n * m odd: every row and every batch entry starts at
              # another alignment, so the scalar store variant runs
              ("matern32", (3, 201, 203, 1)), ("exponential", (2, 65, 131, 3)),
              # 4 < d <= 16: the staged backward kernel in one chunk
              ("matern12", (2, 70, 300, 7))]
    max_err = {"forward": 0.0, "backward": 0.0}
    for i, (kind, shape) in enumerate(cases):
        fwd = _check_forward(gp_cov, kind, shape, seed=i)
        bwd = _check_backward(gp_cov, kind, shape, seed=i)
        max_err["forward"] = max(max_err["forward"], fwd)
        max_err["backward"] = max(max_err["backward"], bwd)
        print(f"kernels ok: {kind} B,n,m,d={shape} forward max|err| "
              f"{fwd:.2e}, backward max|err| {bwd:.2e}", flush=True)

    # the shapes of phases 21-22 and 27 (SMC's particles run the forward
    # only): FITC's Kuf and Kuu at 64 points both ways and at 4,096
    # particles forward (Kuu there takes the tiled kernel); the GP's at
    # 4,096 particles and at 2,048 a rank forward; the conditional's of
    # phase 5's plot_gp_dist data forward; gp_example's of phase 25
    # both ways; and a batch above 65,535, cut into two launches that count
    # as one call
    for i, (kind, shape, backward) in enumerate((
            ("matern52", FITC_SHAPES[0], True),
            ("matern52", FITC_SHAPES[1], True),
            ("expquad", SMC_SHAPE, False),
            ("expquad", MULTIRANK_SHAPE, False),
            ("expquad", GP_DIST_SHAPE, False),
            ("matern52", FITC_SHAPES[2], False),
            ("matern52", FITC_SHAPES[3], False),
            ("expquad", EXAMPLE_SHAPE, True),
            ("expquad", CHUNKED_SHAPE, True))):
        calls = gp_cov.LAUNCHES, gp_cov.BACKWARD_LAUNCHES
        fwd = _check_forward(gp_cov, kind, shape, seed=60 + i)
        max_err["forward"] = max(max_err["forward"], fwd)
        bwd = (_check_backward(gp_cov, kind, shape, seed=60 + i)
               if backward else None)
        if bwd is not None:
            max_err["backward"] = max(max_err["backward"], bwd)
        counted = (gp_cov.LAUNCHES - calls[0],
                   gp_cov.BACKWARD_LAUNCHES - calls[1])
        # forward: the check and the autograd check; backward: the launch
        # and the autograd's backward
        if counted != ((2, 2) if backward else (1, 0)):
            fail(f"{kind} {shape}: {counted} calls counted, expected one "
                 "per call whatever its chunks")
        print(f"kernels ok: {kind} B,n,m,d={shape} forward max|err| "
              f"{fwd:.2e}" + (f", backward max|err| {bwd:.2e}"
                              if bwd is not None else ""), flush=True)

    # a stride-0 cotangent: K.sum().backward() hands the op an expanded one
    X, Xs = _apart(2, 77, 130, 2, seed=50)
    grads = []
    for fn in (gp_cov.stationary_cov, gp_cov.stationary_cov_reference):
        Xg, Xsg = X.clone().requires_grad_(), Xs.clone().requires_grad_()
        fn(Xg, Xsg, kind="matern52").sum().backward()
        grads.append((Xg.grad, Xsg.grad))
    for name, a, b in zip(("dX", "dXs"), grads[0], grads[1]):
        check_close(f"stride-0 cotangent {name}", a, b, GRAD_TOL)
    ones = torch.ones(1, 1, 1).cuda().expand(2, 77, 130)
    got = gp_cov._launch_backward("matern52", ones, X, Xs)
    for name, a, b in zip(("dX", "dXs"), got, grads[1]):
        check_close(f"stride-0 launch {name}", a, b, GRAD_TOL)
    print("kernels ok: stride-0 cotangent (expanded, read in place)",
          flush=True)

    # d = 40 against a float64 truth (the kernels keep exact differences
    # where the JAX fallback switched to the matmul form above d = 32)
    X, Xs = _inputs(1, 64, 48, 40, seed=99, scale=0.2)
    g = _cotangent(1, 64, 48, 99)
    for kind in gp_cov.STATIONARY_KINDS:
        K = gp_cov.stationary_cov(X, Xs, kind)
        truth = gp_cov.stationary_cov_reference(X.double(), Xs.double(), kind)
        max_err["forward"] = max(max_err["forward"], check_close(
            f"{kind} d=40 forward vs float64", K, truth, FWD_TOL))
        got = gp_cov._launch_backward(kind, g, X, Xs)
        want = gp_cov.stationary_cov_backward_reference(
            g.double(), X.double(), Xs.double(), kind)
        for name, a, b in zip(("dX", "dXs"), got, want):
            max_err["backward"] = max(max_err["backward"], check_close(
                f"{kind} d=40 backward {name} vs float64", a, b, GRAD_TOL))
    print("kernels ok: d=40 against float64 truth, all kinds, both "
          "directions", flush=True)

    # close points, where dK/dd2 of matern12 and exponential is singular:
    # the kernel sums w (x - x'), the plain version rowsum(w) x - w x'
    gen = torch.Generator().manual_seed(123)
    X = torch.rand(1, 300, 2, generator=gen).cuda()
    Xs = (X[:, :257] + 1e-3 * torch.randn(1, 257, 2, generator=gen).cuda())
    g = _cotangent(1, 300, 257, 123)
    for kind in ("matern12", "exponential"):
        truth = gp_cov.stationary_cov_backward_reference(
            g.double(), X.double(), Xs.double(), kind)
        got = gp_cov._launch_backward(kind, g, X, Xs)
        plain = gp_cov.stationary_cov_backward_reference(g, X, Xs, kind)
        scale = max(float(t.abs().max()) for t in truth)
        errs = [max(float((a.double() - t).abs().max())
                    for a, t in zip(pair, truth)) for pair in (got, plain)]
        print(f"close points {kind}: max |gradient| {scale:.3e}; against "
              f"float64 the kernel errs by {errs[0]:.3e}, the plain version "
              f"by {errs[1]:.3e}", flush=True)
        for name, a, t in zip(("dX", "dXs"), got, truth):
            check_close(f"{kind} close points {name} vs float64", a, t,
                        GRAD_TOL, scale)

    return max_err, _time_kernels(gp_cov, card, other)


def _check_rel(what, got, want, rel):
    """max |got - want| <= rel * max |want| and every value finite;
    returns max |got - want| and that over max |want|."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    if not bool(torch.isfinite(got).all()) or not err <= rel * scale:
        fail(f"{what}: max |err| {err:.3e} exceeds {rel:g} x max |want| "
             f"{scale:.3e}")
    return err, err / scale


def _double(*tensors):
    return tuple(t.double() for t in tensors)


def phase_kernel_f64(gp_cov, card, other=None):
    """Phase 31's kernel part, in the main process right after phase 3
    (before any worker starts, so its device times are the card's alone):
    the float64 builds of both kernels (``gp_cov_forward_f64``,
    ``gp_cov_backward_f64``), through the wrappers the program calls,
    against their plain float64 versions, all five kinds at ``F64_SHAPES``
    (the GP's, GP ADVI's, predict's 4,096 x 4,096 at d = 4, FITC's
    cross-covariance and a batch cut into two launches) and at ragged
    shapes (odd m; n and m off the 32-row and 64-column tiles at d = 2 and
    3; two column tiles a block with odd m at d = 3; the staged backward at
    d = 7 and 20); a stride-0 cotangent, read in place; the whole op's
    gradients through autograd; and two runs of the backward, bit for bit,
    at (4, 200, 200, 1) and (1, 4096, 4096, 4).
    Tolerances: max |Δ| <= 1e-12 x max |K| forward and <= 1e-10 x max |dX|
    backward (both in double; the kernel and the plain version sum the same
    terms in another order, and the plain backward's rowsum(w) X - w Xs
    cancels where the kernel sums w (x - x'), so the inputs of the backward
    lie apart as in phase 3). Then times both at ``F64_TIMED`` with both
    bounds, beside the float32 rows of phase 3: two readings there and back
    (``device_ms`` their mean, ``device_ms_runs`` both), or with ``other``
    (``--against``) that checkout's kernels in turns (other, this, this,
    other). Returns (max absolute error per direction, timing rows)."""
    cases = [(kind, shape) for shape in F64_SHAPES
             for kind in gp_cov.STATIONARY_KINDS]
    cases += [("matern32", (3, 201, 203, 1)), ("expquad", (5, 77, 130, 2)),
              ("exponential", (2, 33, 65, 3)),
              ("matern52", (1, 2049, 1999, 3)),
              ("matern12", (2, 70, 300, 7)), ("exponential", (1, 64, 48, 20))]
    max_err = {"forward": 0.0, "backward": 0.0}
    for i, (kind, shape) in enumerate(cases):
        B, n, m, d = shape
        X, Xs = _double(*_inputs(*shape, seed=200 + i))
        want = gp_cov.stationary_cov_reference(X, Xs, kind)
        calls = gp_cov.LAUNCHES
        got = gp_cov._launch(kind, X, Xs)
        fwd = _check_rel(f"float64 {kind} {shape} forward", got, want,
                         F64_FWD_REL)
        if gp_cov.LAUNCHES - calls != 1:
            fail(f"float64 {kind} {shape}: the forward was not counted "
                 "once")
        del want
        X, Xs = _double(*_apart(*shape, seed=200 + i))
        g = _cotangent(B, n, m, 200 + i).double()
        want = gp_cov.stationary_cov_backward_reference(g, X, Xs, kind)
        calls = gp_cov.BACKWARD_LAUNCHES
        got = gp_cov._launch_backward(kind, g, X, Xs)
        bwd = max(_check_rel(f"float64 {kind} {shape} backward {name}", a, b,
                             F64_BWD_REL)
                  for name, a, b in zip(("dX", "dXs"), got, want))
        if gp_cov.BACKWARD_LAUNCHES - calls != 1:
            fail(f"float64 {kind} {shape}: the backward was not counted "
                 "once")
        del want, got
        max_err["forward"] = max(max_err["forward"], fwd[0])
        max_err["backward"] = max(max_err["backward"], bwd[0])
        print(f"float64 kernels ok: {kind} B,n,m,d={shape} forward "
              f"max|err|/max|K| {fwd[1]:.2e}, backward max|err|/max|dX| "
              f"{bwd[1]:.2e}", flush=True)

    # a stride-0 cotangent: K.sum().backward() hands the op an expanded one
    X, Xs = _double(*_apart(2, 77, 130, 2, seed=251))
    want = gp_cov.stationary_cov_backward_reference(
        torch.ones(2, 77, 130, dtype=torch.float64, device=X.device), X, Xs,
        "matern52")
    ones = torch.ones(1, 1, 1, dtype=torch.float64).cuda().expand(2, 77, 130)
    got = gp_cov._launch_backward("matern52", ones, X, Xs)
    for name, a, b in zip(("dX", "dXs"), got, want):
        _check_rel(f"float64 stride-0 cotangent {name}", a, b, F64_BWD_REL)
    print("float64 kernels ok: stride-0 cotangent (expanded, read in "
          "place)", flush=True)

    X, Xs = _double(*_apart(*MAIN_SHAPE, seed=250))
    grads = []
    for fn in (gp_cov.stationary_cov, gp_cov.stationary_cov_reference):
        Xg, Xsg = X.clone().requires_grad_(), Xs.clone().requires_grad_()
        torch.sin(fn(Xg, Xsg, kind="expquad")).sum().backward()
        grads.append((Xg.grad, Xsg.grad))
    for name, a, b in zip(("dX", "dXs"), grads[0], grads[1]):
        if a.dtype != torch.float64:
            fail(f"float64 autograd {name} came back as {a.dtype}")
        _check_rel(f"float64 autograd {name}", a, b, F64_BWD_REL)
    print("float64 kernels ok: autograd through the op, float64 gradients",
          flush=True)

    # bit for bit from run to run: no atomics, every sum in a fixed order
    for shape in F64_REPEAT:
        B, n, m, d = shape
        X, Xs = _double(*_apart(*shape, seed=260))
        g = _cotangent(B, n, m, 260).double()
        runs = [gp_cov._launch_backward("matern52", g, X, Xs)
                for _ in range(2)]
        if not all(torch.equal(a, b) for a, b in zip(*runs)):
            fail(f"float64 backward {shape}: two runs differ")
        print(f"float64 kernels ok: backward B,n,m,d={shape} bit-identical "
              "over two runs", flush=True)

    rows = {"forward": {}, "backward": {}}
    for shape in F64_TIMED:
        B, n, m, d = shape
        X, Xs = _double(*_inputs(*shape, seed=7))
        g = _cotangent(B, n, m, 7).double()
        plain_n = 20 if n * m > 1_000_000 else 100
        calls = {
            "forward": (lambda mod: lambda: mod._launch("expquad", X, Xs),
                        lambda: gp_cov.stationary_cov_reference(
                            X, Xs, "expquad")),
            "backward": (lambda mod: lambda: mod._launch_backward(
                "expquad", g, X, Xs),
                         lambda: gp_cov.stationary_cov_backward_reference(
                             g, X, Xs, "expquad")),
        }
        for direction, (of, plain) in calls.items():
            kernel = of(gp_cov)
            bound, by = _bound_ms(direction, shape, torch.float64)
            by_bytes, by_ops = _bounds(direction, shape, torch.float64)
            if other is None:
                runs = [device_ms(kernel), device_ms(kernel)]
            else:
                old = of(other)
                turns = [device_ms(f) for f in (old, kernel, kernel, old)]
                runs = turns[1:3]
            row = dict(device_ms=sum(runs) / 2, device_ms_runs=runs,
                       issue_ms=issue_ms(kernel),
                       plain_ms=device_ms(plain, launches=plain_n),
                       bound_ms=bound, bound_by=by, bound_bytes_ms=by_bytes,
                       bound_ops_ms=by_ops)
            if other is not None:
                row["other_device_ms"] = [turns[0], turns[3]]
            rows[direction][shape] = row
            print(f"timing float64 expquad {direction} B,n,m,d={shape}: "
                  + json.dumps(row) + " share_of_bound "
                  f"{row['bound_ms'] / row['device_ms']:.3f} ({card})",
                  flush=True)
    return max_err, rows


def _baseline():
    with open(os.path.join(ROOT, "BASELINE_CPU.json")) as f:
        return json.load(f)["configs"]


def _on_card(model, label):
    if model.device.type != "cuda":
        fail(f"{label}: the model was built on {model.device}, not on the "
             "card, with no device asked for")


def _gate(pm, trace, names, ref, wall, label, against="BASELINE_CPU.json",
          rhat_limit=1.01):
    """Moment check against ``ref`` and R-hat below its limit (one number,
    or one per variable); prints the phase's line and returns its
    numbers."""
    from pymc3_tpu_torch.examples.suite import (moment_check,
                                                 posterior_moments)
    check = moment_check(posterior_moments(pm, trace, names), ref)
    rhat = pm.rhat(trace, var_names=names)
    ess = pm.ess(trace, var_names=names)
    rhat_by = {v: float(np.max(rhat[v])) for v in names}
    rhat_max = max(rhat_by.values())
    ess_min = min(float(np.min(ess[v])) for v in names)
    n_div = (int(np.sum(trace.get_sampler_stats("diverging")))
             if "diverging" in trace.stat_names else 0)
    depth = ""
    mean_depth, deepest = _depths(trace)
    if deepest is not None:
        depth = (f", mean tree depth {mean_depth:.2f}, deepest lane "
                 f"{deepest:.2f}")
    print(f"{label}: wall {wall:.2f} s, min ESS {ess_min:.1f}, ESS/s "
          f"{ess_min / wall:.2f}, max R-hat {rhat_max:.4f}, divergences "
          f"{n_div}{depth}, moment check {check}", flush=True)
    if not check["pass"]:
        fail(f"{label} posterior moments disagree with {against}")
    limits = (rhat_limit if isinstance(rhat_limit, dict)
              else dict.fromkeys(names, rhat_limit))
    for v in names:
        if not rhat_by[v] < limits[v]:
            fail(f"{label} R-hat of {v} {rhat_by[v]:.4f} >= {limits[v]}")
    return {"wall_s": wall, "min_ess": ess_min, "ess_per_s": ess_min / wall,
            "rhat": rhat_by, "divergences": n_div,
            "mean_tree_depth": mean_depth, "deepest_lane_depth": deepest,
            "moment_check": check}


def _depths(trace):
    """Mean NUTS tree depth, and the mean over draws of the deepest lane's
    depth: a batched NUTS step lasts as long as its deepest lane's tree.
    ``(None, None)`` where no NUTS ran."""
    if "depth" not in trace.stat_names:
        return None, None
    d = np.stack(trace.get_sampler_stats("depth", combine=False,
                                         squeeze=False))
    d = d.reshape(d.shape[0], d.shape[1], -1)[..., 0]  # (chains, draws)
    return float(d.mean()), float(d.max(axis=0).mean())


def phase_gp(pm, gp_cov, draws=500, tune=200, chains=4):
    """Returns the launch counts of ``sample()`` and what the prediction
    phase needs: the model, its ``Marginal`` and the trace.

    R-hat < 1.02, from the formula: split R-hat is about sqrt(1 + 1 / ESS
    of half a chain) (``PERF.md``). Runs of this phase at 500 draws held a
    least ESS of 400-935 over the 4 chains, 50-117 in each of the 8 half
    chains, so R-hat is expected at 1.004-1.010 and 1.01 sits on the
    expectation itself; it scattered as far again (1.0021, 1.0025, 1.0057,
    1.0146 at 500 draws). The limit is the expected excess at the least
    ESS plus that much scatter. Tune is 200 (cut from 500, then 300) to
    keep the script inside its time limit on a slow host: the
    first diagonal window closes at 101 tuning draws (R-hat 1.0030 on the
    card at 200)."""
    from pymc3_tpu_torch.examples.suite import gp_regression
    model, names, gp = gp_regression(pm)
    _on_card(model, "gp")
    gp_cov.LAUNCHES = 0
    gp_cov.BACKWARD_LAUNCHES = 0
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"forward": gp_cov.LAUNCHES,
                "backward": gp_cov.BACKWARD_LAUNCHES}
    print(f"gp: {launches['forward']} forward and {launches['backward']} "
          f"backward kernel launches during sample()", flush=True)
    if launches["forward"] <= 0:
        fail("the GP main path never launched the forward gp_cov kernel")
    if launches["backward"] <= 0:
        fail("the GP main path never launched the backward gp_cov kernel")
    RESULTS["gp"] = _gate(pm, trace, names, _baseline()["gp"]["moments"],
                          wall, "gp", rhat_limit=1.02)
    return launches, (model, gp, trace)


def _timed_predict(gp_cov, model, gp, Xnew, point, expect, label, **kwargs):
    """One ``predict`` call on the card: its results, and a failure unless
    the forward kernel was launched ``expect`` times and the backward
    never."""
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with model:
        mu, cov = gp.predict(Xnew, point=point, **kwargs)
    wall = time.time() - t0
    if gp_cov.LAUNCHES != expect or gp_cov.BACKWARD_LAUNCHES != 0:
        fail(f"{label}: {gp_cov.LAUNCHES} forward and "
             f"{gp_cov.BACKWARD_LAUNCHES} backward launches, expected "
             f"{expect} and 0")
    if not (np.isfinite(mu).all() and np.isfinite(cov).all()):
        fail(f"{label}: mean or covariance not finite")
    print(f"{label}: wall {wall:.3f} s, {expect} forward launches, mean "
          f"{mu.shape}, covariance {cov.shape}", flush=True)
    return mu, cov


def phase_predict(gp_cov, model, gp, point, label="predict"):
    """GP prediction at ``point`` through the forward kernel at full width.
    Returns the forward launches of the two wide calls."""
    from pymc3_tpu_torch.examples.suite import gp_data
    from pymc3_tpu_torch.gp.util import _default_jitter
    X, y = gp_data()
    wide = np.linspace(-0.5, 4.5, 16384, dtype=np.float32)[:, None]
    grid = np.linspace(X.min(), X.max(), 4096, dtype=np.float32)[:, None]

    def calls():
        # K(X) and K(X, Xnew); K(Xnew) too for the full covariance
        return (_timed_predict(gp_cov, model, gp, wide, point, 2,
                               f"{label} 16384 diag+noise", diag=True,
                               pred_noise=True),
                _timed_predict(gp_cov, model, gp, grid, point, 3,
                               f"{label} 4096 full", diag=False))
    (mu_w, var_w), (mu_g, cov_g) = calls()
    if not var_w.min() > 0.0:
        fail(f"{label}: predictive variance {var_w.min():.3e} <= 0")
    asym = float(np.abs(cov_g - cov_g.T).max())
    if not asym <= 1e-5:
        fail(f"{label}: covariance asymmetric by {asym:.3e}")

    # the diagonal of the full covariance against the diag=True variance at
    # the same points; the full noise-free covariance carries the jitter.
    # rtol 1e-4 with atol 2e-5: both subtract sum(A^2) of about eta^2 from
    # eta^2 in float32, one by a matmul, one by a sum of squares
    _, var_g = _timed_predict(gp_cov, model, gp, grid, point, 2,
                              f"{label} 4096 diag", diag=True)
    if not var_g.min() > 0.0:
        fail(f"{label}: latent variance {var_g.min():.3e} <= 0")
    diag = np.diagonal(cov_g) - _default_jitter()
    err = np.abs(diag - var_g)
    if not np.all(err <= 2e-5 + 1e-4 * np.abs(var_g)):
        fail(f"{label}: diagonal of the covariance off the variance by "
             f"{err.max():.3e}")

    # the same two calls with the kernel swapped for its plain version
    kernel_forward = gp_cov._cov_forward
    gp_cov._cov_forward = lambda kind, A, B: gp_cov.stationary_cov_reference(
        A, B, kind)
    try:
        with model:
            ref_w = gp.predict(wide, point=point, diag=True, pred_noise=True)
            ref_g = gp.predict(grid, point=point, diag=False)
    finally:
        gp_cov._cov_forward = kernel_forward
    worst = 0.0
    for name, got, want in (("mean 16384", mu_w, ref_w[0]),
                            ("variance 16384", var_w, ref_w[1]),
                            ("mean 4096", mu_g, ref_g[0]),
                            ("covariance 4096", cov_g, ref_g[1])):
        err = np.abs(got.astype(np.float64) - want)
        worst = max(worst, float(err.max()))
        if not np.all(err <= 1e-5 + 1e-4 * np.abs(want)):
            fail(f"{label}: {name} differs from the plain version's by "
                 f"{err.max():.3e} (rtol 1e-4, atol 1e-5)")

    # the fit: the predictive mean at the training inputs against y
    mu_x, _ = _timed_predict(gp_cov, model, gp, X, point, 2,
                             f"{label} at the 200 training inputs",
                             diag=True)
    env = model._point_to_env(point)
    sigma = float(env["sigma"]) if "sigma" in env else float(
        np.exp(point["sigma_log__"]))
    inside = float(np.mean(np.abs(mu_x - y) < 3.0 * sigma))
    print(f"{label}: variance min {var_w.min():.3e}, asymmetry {asym:.2e}, "
          f"max |kernel - plain| {worst:.2e}, {100 * inside:.1f}% of y "
          f"within 3 sd (sigma {sigma:.4f}) of the mean", flush=True)
    if not inside >= 0.95:
        fail(f"{label}: only {100 * inside:.1f}% of y within 3 noise sd")
    return 5


def phase_gp_dist(pm, gp_cov, model, gp, trace, samples=500, points=200):
    """``plot_gp_dist``'s data, the rest of phase 5: ``samples`` draws of
    ``gp.conditional("f_pred", Xnew)`` at ``points`` new inputs through
    ``sample_posterior_predictive`` over phase 4's trace, which launches the
    forward kernel and never the backward; then the 40 pairs of percentile
    ribbons computed on the card from them (``gp.util._gp_dist_data``, one
    sort), held against ``np.percentile`` on the same samples (rtol 1e-10:
    the same sorted values and float64 interpolation). Returns the forward
    launches and the samples' shape."""
    from pymc3_tpu_torch.examples.suite import gp_data
    from pymc3_tpu_torch.gp.util import GP_DIST_PERCENTILES, _gp_dist_data
    X, _ = gp_data()
    Xnew = np.linspace(X.min(), X.max(), points, dtype=np.float32)[:, None]
    with model:
        gp.conditional("f_pred", Xnew)
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    t0 = time.time()
    draws = pm.sample_posterior_predictive(
        trace, samples=samples, model=model, var_names=["f_pred"],
        random_seed=4, progressbar=False)["f_pred"]
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = gp_cov.LAUNCHES
    if launches <= 0 or gp_cov.BACKWARD_LAUNCHES != 0:
        fail(f"gp_dist: {launches} forward and {gp_cov.BACKWARD_LAUNCHES} "
             "backward launches, expected some and 0")
    if draws.shape != (samples, points) or not np.isfinite(draws).all():
        fail(f"gp_dist: draws of shape {draws.shape}, expected "
             f"{(samples, points)}, or not finite")
    t0 = time.time()
    upper, lower = _gp_dist_data(draws)
    ribbon_wall = time.time() - t0
    worst = 0.0
    for i, p in enumerate(GP_DIST_PERCENTILES[::-1]):
        for got, q in ((upper[i], p), (lower[i], 100 - p)):
            want = np.percentile(draws.T, q, axis=1)
            worst = max(worst, float(np.max(np.abs(got - want))))
            if not np.allclose(got, want, rtol=1e-10, atol=0.0):
                fail(f"gp_dist: the {q:g}th percentile ribbon differs from "
                     f"np.percentile's by {worst:.3e}")
    print(f"gp_dist: {samples} draws of f_pred at {points} inputs in "
          f"{wall:.3f} s, {launches} forward launches and 0 backward; 40 "
          f"ribbon pairs on the card in {ribbon_wall:.4f} s, max |card - "
          f"np.percentile| {worst:.1e}", flush=True)
    return launches, list(draws.shape)


def _posterior_mean_point(model, trace):
    """The mean of every free variable's draws, in the sampler's
    (transformed) space."""
    return {rv.name: np.asarray(trace.get_values(rv.name, combine=True),
                                dtype=np.float64).mean(0)
            for rv in model.free_RVs}


def _median_se(x, n_eff):
    """Standard error of a sample median: sqrt(pi/2) sd / sqrt(n_eff), with
    the sd read robustly from the interquartile range."""
    q1, q3 = np.quantile(x, [0.25, 0.75])
    return np.sqrt(np.pi / 2.0) * (q3 - q1) / 1.349 / np.sqrt(n_eff)


def phase_best(pm, draws=150, tune=100, chains=256):
    from pymc3_tpu_torch.examples.suite import best_model
    model, names = best_model(pm)
    _on_card(model, "best")
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


def phase_mixture(pm, draws=70, tune=100, chains=512,
                  prior_samples=100_000):
    from pymc3_tpu_torch.examples.suite import mixture_model
    model, names = mixture_model(pm)
    _on_card(model, "mixture")
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


def _synced_ms(fn, calls=50, warmup=5):
    """Host clock per call of ``fn`` in milliseconds, each call waited for."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
        torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / calls


def _exact_ref(moments):
    """A known mean and sd in the shape ``moment_check`` compares with (no
    Monte-Carlo error of its own)."""
    return {name: {"mean": np.atleast_1d(m["mean"]).tolist(),
                   "sd": np.atleast_1d(m["sd"]).tolist(),
                   "mcse": np.zeros_like(np.atleast_1d(m["mean"])).tolist()}
            for name, m in moments.items()}


def _trace_dtypes(trace, names):
    """The numpy dtype of each variable's draws in ``trace``."""
    return {v: str(np.asarray(trace.get_values(v)).dtype) for v in names}


def phase_disaster(pm, card, draws=400, tune=300, chains=256):
    """The slice's main path at full width: NUTS + Metropolis, assigned and
    compounded by ``sample()`` itself, against the exact posterior.

    R-hat: below 1.01 for the two rates (NUTS) and below 1.05 for the
    switchpoint. Its Metropolis walk starts at scale 1 against a posterior
    sd of 2.45 and is tuned three times in 300 draws, so a chain of 600
    draws holds about 60 effective ones, and split R-hat is about
    sqrt(1 + 1 / ESS of half a chain) however many chains there are: 1.016
    (1.0208 on the card); at 450 draws, cut from 600 for the run's budget,
    about 1.022 (1.0313 on the card), and at 400, cut again when the SMC
    phases came, about 1.025 by the formula. (Tuned once, in 150 tuning draws, the walk
    failed the gate on the card: R-hat 1.0955, the switchpoint's sd 48%
    off.)"""
    from pymc3_tpu_torch.examples import disaster_model
    from pymc3_tpu_torch.examples.suite import disaster_exact_posterior
    model = disaster_model.build_model()
    _on_card(model, "disaster")
    names = ["switchpoint", "early_mean", "late_mean"]

    # what sample() will pick when it is given no step
    picked = pm.assign_step_methods(model)
    kinds = sorted((type(m).__name__, [v.name for v in m.vars])
                   for m in (picked if isinstance(picked, list) else [picked]))
    want = [("Metropolis", ["switchpoint"]),
            ("NUTS", ["early_mean_log__", "late_mean_log__"])]
    if kinds != want:
        fail(f"disaster: steppers assigned {kinds}, expected {want}")
    nuts = next(m for m in picked if isinstance(m, pm.NUTS))
    if not nuts.is_partial or nuts.dim != 2:
        fail("disaster: the NUTS is not over the two rates only")

    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    need = {"depth", "diverging", "accept", "scaling"}
    if not need <= trace.stat_names:
        fail(f"disaster: the trace lacks statistics "
             f"{sorted(need - trace.stat_names)} of its two steppers")
    if len(trace._straces[0].sampler_vars) != 2:
        fail("disaster: expected one block of statistics per stepper")

    exact = disaster_exact_posterior(disaster_model.disasters_data)
    out = _gate(pm, trace, names, _exact_ref({n: exact[n] for n in names}),
                wall, f"disaster chains={chains} tune={tune} draws={draws}",
                against="the exact posterior",
                rhat_limit={"switchpoint": 1.05, "early_mean": 1.01,
                            "late_mean": 1.01})
    s = np.asarray(trace["switchpoint"])
    if not np.all(s == np.round(s)):
        fail("disaster: switchpoint draws are not integers")
    mode = int(np.bincount(s.astype(np.int64), minlength=111).argmax())
    if mode != int(exact["w"].argmax()):
        fail(f"disaster: switchpoint mode {mode}, exact "
             f"{int(exact['w'].argmax())}")

    out.update(phase="disaster", chains=chains, tune=tune, draws=draws,
               switchpoint_mode=mode,
               switchpoint_dtype=str(s.dtype),
               dtypes=_trace_dtypes(trace, names),
               metropolis_accept=float(np.mean(
                   trace.get_sampler_stats("accept"))),
               logp_ms=_logp_ms(model, chains),
               logp_grad_ms=_logp_grad_ms(model, chains), card=card)
    print(json.dumps(out), flush=True)
    return out


def phase_binary(pm, card, draws=200, tune=0, chains=1024):
    """Eight Bernoulli indicators through the Gibbs scan ``sample()``
    assigns, against the enumeration of all 256 states."""
    from pymc3_tpu_torch.examples.suite import (indicator_exact_inclusion,
                                                 indicator_model)
    model, names = indicator_model(pm)
    _on_card(model, "binary")
    picked = pm.assign_step_methods(model)
    if type(picked).__name__ != "BinaryGibbsMetropolis":
        fail(f"binary: {picked!r} assigned, expected BinaryGibbsMetropolis")
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    z = np.asarray(trace["z"], dtype=np.float64)
    exact = indicator_exact_inclusion()
    ess = np.asarray(pm.ess(trace, var_names=names)["z"], dtype=np.float64)
    se = z.std(axis=0) / np.sqrt(ess)
    zscore = np.abs(z.mean(axis=0) - exact) / se
    out = {"phase": "binary", "wall_s": wall, "chains": chains, "tune": tune,
           "draws": draws, "logp_calls_per_draw": z.shape[1],
           "inclusion": z.mean(axis=0).tolist(), "exact": exact.tolist(),
           "max_z": float(zscore.max()), "min_ess": float(ess.min()),
           "dtypes": _trace_dtypes(trace, names), "card": card}
    print(json.dumps(out), flush=True)
    if not zscore.max() < 4.0:
        fail(f"binary: an inclusion probability is {zscore.max():.2f} "
             "standard errors off the enumeration")
    return out


def phase_population(pm, card, draws=1000, tune=500, chains=2048):
    """``DEMetropolis`` over a population of 2048 chains on a correlated
    normal whose moments are known."""
    from pymc3_tpu_torch.examples.suite import correlated_normal_model
    model, names, mean, sd = correlated_normal_model(pm)
    _on_card(model, "population")
    step = pm.DEMetropolis(model=model)
    calls = [0]
    stepped = step.population_kernel_step

    def counted(*args):
        calls[0] += 1
        return stepped(*args)
    step.population_kernel_step = counted
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      step=step, progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if calls[0] != draws + tune:
        fail(f"population: sample() stepped the population {calls[0]} "
             f"times, expected {draws + tune}")
    # R-hat < 1.05: a random-walk population, not NUTS
    out = _gate(pm, trace, names,
                _exact_ref({"x": {"mean": mean, "sd": sd}}), wall,
                f"population chains={chains} tune={tune} draws={draws}",
                against="the known normal", rhat_limit=1.05)
    x = np.asarray(trace["x"], dtype=np.float64)
    sd_rel = float(np.max(np.abs(x.std(axis=0) / sd - 1.0)))
    out.update(phase="population", chains=chains, tune=tune, draws=draws,
               max_sd_rel=sd_rel,
               accept=float(np.mean(trace.get_sampler_stats("accepted"))),
               dtypes=_trace_dtypes(trace, names), card=card)
    print(json.dumps(out), flush=True)
    if not sd_rel < 0.10:
        fail(f"population: a marginal sd is {100 * sd_rel:.1f}% off")
    return out


def _reference(config):
    """The JAX package's CPU reference run of ``config`` (mean, sd and MCSE
    per element), made by ``tests/torch_reference.py``."""
    path = os.path.join(ROOT, "pymc3_tpu_torch", "examples",
                        "reference_moments.json")
    with open(path) as f:
        return json.load(f)["configs"][config]["moments"]


def _logp_grad_ms(model, chains, calls=50):
    """Host ms per synced logp+grad call at the test point, ``chains``
    rows."""
    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains), device=model.device)
    vag = model.logp_dlogp_function()
    return _synced_ms(lambda: vag(q), calls=calls)


def _logp_ms(model, chains, calls=50):
    """Host ms per synced logp-only call at the test point, ``chains``
    rows."""
    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains), device=model.device)
    fn = model.make_logp_fn()
    return _synced_ms(lambda: fn(q), calls=calls)


def _spy_final_state(step):
    """Wrap ``step.kernel_step`` so that the kernel state after the last
    draw can be read back (``box[0]``)."""
    box = [None]
    inner = step.kernel_step

    def spy(q, state, tctx, noise):
        out = inner(q, state, tctx, noise)
        box[0] = out[1]
        return out
    step.kernel_step = spy
    return box


def phase_lkj(pm, card, draws=150, tune=100, chains=1024):
    """``examples/LKJ_correlation.py`` at its width (200 rows, 3 variables,
    LKJCholeskyCov with eta = 2 and HalfCauchy(2.5) sds, ``MvNormal(chol=)``)
    under NUTS with ``init="jitter+adapt_full"``, pooled over 1024 chains,
    target_accept 0.9. The potential must be the dense adaptive one and its
    covariance must have left the identity by the end of tuning. ``mu`` and
    the implied covariance ``L Lᵀ`` against the JAX package's reference run;
    then the posterior predictive of ``obs`` (one row per draw, through
    ``MvNormal.random`` with ``chol``) against the data's mean (4 standard
    errors) and covariance (10% of sqrt(S_ii S_jj): the predictive adds the
    posterior spread of ``mu`` and of the covariance, about 2.5%).

    R-hat < 1.01: the reference run's chains hold 1.3-1.7 effective draws
    per draw, so 200 draws give a half chain about 150, and split R-hat about
    sqrt(1 + 1/150) = 1.0033 (on the card 300 + 300 drew 1.0035-1.0039 and
    200 + 150 drew 1.0068-1.0075; cut to 100 + 200 and then to 100 + 150
    (1.0072) for the run's budget; 100 + 130 drew 1.0084, too near the
    limit)."""
    from pymc3_tpu_torch.examples import LKJ_correlation as lkj
    from pymc3_tpu_torch.examples.suite import chain_moments, moment_check
    from pymc3_tpu_torch.step_methods.hmc.quadpotential import (
        DenseAdaptState, QuadPotentialFullAdapt)
    model = lkj.build_model()
    _on_card(model, "lkj")
    start, step = pm.init_nuts(init="jitter+adapt_full", chains=chains,
                               model=model, random_seed=3,
                               axis_name="chains_local", target_accept=0.9)
    if not isinstance(step.potential, QuadPotentialFullAdapt):
        fail(f"lkj: potential {type(step.potential).__name__}, expected "
             "QuadPotentialFullAdapt")
    final = _spy_final_state(step)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      step=step, start=start, progressbar=False,
                      random_seed=3, compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    pot = final[0].pot
    eye = torch.eye(pot.cov.shape[-1], device=pot.cov.device)
    moved = float((pot.cov - eye).abs().max())
    if not isinstance(pot, DenseAdaptState) or not moved > 0.1 \
            or not bool(torch.isfinite(pot.chol).all()):
        fail(f"lkj: the dense mass matrix did not adapt (max |cov - I| "
             f"{moved:.3g})")

    L = np.stack(trace.get_values("L", combine=False)).astype(np.float64)
    arrays = {"mu": np.stack(trace.get_values("mu", combine=False)),
              "cov": np.einsum("cdij,cdkj->cdik", L, L)}
    bench = chain_moments(pm, arrays)
    check = moment_check(bench, _reference("lkj"))
    rhat = {n: float(np.max(pm.rhat(a)["x"])) for n, a in arrays.items()}
    mean_depth, deepest = _depths(trace)
    n_div = int(np.sum(trace.get_sampler_stats("diverging")))
    ess_min = min(float(np.min(np.asarray(m["sd"]) ** 2
                               / np.asarray(m["mcse"]) ** 2))
                  for m in bench.values())

    data = lkj.dataset.astype(np.float64)
    t1 = time.time()
    ppc = pm.sample_posterior_predictive(trace, model=model,
                                         var_names=["obs"], random_seed=4)
    pwall = time.time() - t1
    obs = ppc["obs"].astype(np.float64)
    S = np.cov(data.T)
    se = np.sqrt(np.diag(obs.T @ obs / len(obs) - np.outer(
        obs.mean(0), obs.mean(0))) / len(obs))
    z_mean = float(np.max(np.abs(obs.mean(0) - data.mean(0)) / se))
    cov_rel = float(np.max(np.abs(np.cov(obs.T) - S)
                           / np.sqrt(np.outer(np.diag(S), np.diag(S)))))
    out = {"phase": "lkj", "chains": chains, "tune": tune, "draws": draws,
           "wall_s": wall, "min_ess": ess_min, "ess_per_s": ess_min / wall,
           "rhat": rhat, "divergences": n_div, "mean_tree_depth": mean_depth,
           "deepest_lane_depth": deepest, "moment_check": check,
           "max_abs_cov_minus_identity": moved,
           "logp_grad_ms": _logp_grad_ms(model, chains),
           "predictive": {"draws": list(obs.shape), "wall_s": pwall,
                          "max_z_mean": z_mean, "max_cov_rel": cov_rel},
           "card": card}
    print(json.dumps(out), flush=True)
    if not check["pass"]:
        fail("lkj posterior moments disagree with the reference")
    if not max(rhat.values()) < 1.01:
        fail(f"lkj R-hat {rhat} >= 1.01")
    if obs.shape != (chains * draws, 3) or not np.isfinite(obs).all():
        fail(f"lkj predictive: shape {obs.shape} or draws not finite")
    if not (z_mean < 4.0 and cov_rel < 0.10):
        fail("lkj predictive disagrees with the data")


def _nuts_phase(pm, card, label, model, names, draws, tune, chains,
                rhat_limit, start=None, **nuts):
    """NUTS with diagonal adaptation pooled over ``chains``, gated against
    the JAX package's reference run; returns the phase's numbers."""
    _on_card(model, label)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      start=start, progressbar=False, random_seed=2,
                      axis_name="chains_local", trace=names,
                      compute_convergence_checks=False, nuts=nuts)
    torch.cuda.synchronize()
    wall = time.time() - t0
    out = _gate(pm, trace, names, _reference(label), wall,
                f"{label} chains={chains} tune={tune} draws={draws}",
                against="the JAX package's reference run",
                rhat_limit=rhat_limit)
    out.update(phase=label, chains=chains, tune=tune, draws=draws,
               logp_grad_ms=_logp_grad_ms(model, chains), card=card)
    return out, trace


def phase_sv(pm, card, draws=40, tune=20, chains=256):
    """``examples/stochastic_volatility.py`` at its width: a Gaussian random
    walk of 400 latent log-volatilities (402 free values) under StudentT
    returns, NUTS with target_accept 0.9 and diagonal adaptation pooled
    over 256 chains, ``sigma`` and ``nu`` against the JAX package's
    reference run.

    The chains start at 256 posterior draws of that reference run
    (``examples/sv_starts.npy``), and the tree depth is capped at 8 (255
    leapfrogs). From the model's own start, ``sigma`` (the walk's step, a
    funnel with the 400 latent values) needs far more draws than a phase
    can hold: the reference's chains hold 0.003 effective draws of it per
    draw, and a first run on the card spent 233 s on 150 tune + 40 draws at
    a mean depth of 8.68, every draw's deepest lane at the cap of 10, and
    missed the reference by 9.47 standard errors. Started in the posterior,
    the gate asks whether the port's NUTS keeps it there, and ``nu`` mixes
    (0.54 effective draws per draw in the reference).

    R-hat < 1.15 for ``nu``: 60 + 80 on the card drew 1.0630, 30 + 50
    drew 1.0729 and 30 + 40 1.0751, about 0.2 effective draws per draw
    with the capped trees (tune is 20, cut from 30 when phase 25 came: the
    chains start in the posterior, and nearly every iteration reaches the
    depth cap, so each one cut saves a 70th of the phase),
    so a half chain of 20 draws holds about 4 and split R-hat is about
    sqrt(1 + 1/4) = 1.12.
    ``sigma``'s R-hat is printed, not gated: its chains start apart, at the
    posterior's spread, and move 0.003 effective draws per draw, so split
    R-hat compares the start points with themselves.

    ``sigma`` is gated by its pooled draws instead: chains that start in
    the posterior must stay there. The starts are 16 draws from each of
    the reference's 16 chains, and draws of one reference chain are
    correlated, so the standard error of the pooled mean comes from the 16
    groups of 16 chains: the sd of the group means over sqrt(16). The
    pooled mean must lie within 4 of those errors (combined with the
    reference's MCSE) of the reference's mean, and the pooled sd within
    20% of its sd."""
    from pymc3_tpu_torch.examples import stochastic_volatility as sv
    model = sv.build_model()
    starts = np.load(os.path.join(ROOT, "pymc3_tpu_torch", "examples",
                                  "sv_starts.npy"))[:chains]
    out, trace = _nuts_phase(pm, card, "stochastic_volatility", model,
                             ["sigma", "nu"], draws, tune, chains,
                             {"sigma": float("inf"), "nu": 1.15},
                             start=[model.array_to_dict(q) for q in starts],
                             target_accept=0.9, max_treedepth=8)
    ref = _reference("stochastic_volatility")["sigma"]
    sigma = np.stack(trace.get_values("sigma", combine=False)).astype(
        np.float64)                                 # (chains, draws)
    groups = sigma.mean(axis=1).reshape(-1, 16).mean(axis=1)
    se = groups.std(ddof=1) / np.sqrt(len(groups))
    z = abs(sigma.mean() - ref["mean"][0]) / np.hypot(se, ref["mcse"][0])
    sd_rel = abs(sigma.std() / ref["sd"][0] - 1.0)
    out["sigma_pooled"] = {"mean": float(sigma.mean()), "sd": float(
        sigma.std()), "se": float(se), "z": float(z), "sd_rel": float(sd_rel),
        "reference_mean": ref["mean"][0], "reference_sd": ref["sd"][0]}
    print(json.dumps(out), flush=True)
    if not (z < 4.0 and sd_rel < 0.2):
        fail(f"stochastic_volatility: pooled sigma off the reference (z "
             f"{z:.2f}, sd {100 * sd_rel:.1f}% off)")


def phase_garch(pm, card, draws=60, tune=100, chains=256):
    """``examples/garch_example.py``: 100 returns, three ``Uniform``
    priors, ``GARCH11`` (its volatility a blocked linear recursion, one
    Toeplitz product with powers of beta at 100 returns, not a loop), NUTS pooled over 256 chains at the example's
    target_accept 0.8, the tree depth capped at 5 (31 leapfrogs). A first
    run on the card (tune 200, no cap) took 279.72 s: mean depth 3.39, but
    every draw waited for a lane at depth 6 (most lanes need 3-4 and the
    lanes that diverged during tuning run at a halved step).

    R-hat < 1.25: the reference's chains hold 0.019-0.020 effective draws
    of ``beta1`` and ``omega`` per draw (the two trade off against each
    other), so a half chain of 100 draws holds about 2 and split R-hat is
    about sqrt(1 + 1/2) = 1.22; the port's chains do better (1.0398 on the
    card with 300 draws, 1.0719 without the depth cap); ``alpha1`` (0.16
    per draw) is near 1.03. Draws are 60 (cut from 200, then 100) for the
    run's budget: R-hat 1.0698 on the card at 150 draws and 1.0830 at 100,
    so about 1.14 at 60 (R-hat - 1 grows as 1 / draws). Then the block
    length's timings (:func:`_garch_blocks`)."""
    from pymc3_tpu_torch.examples import garch_example
    out, _ = _nuts_phase(pm, card, "garch", garch_example.build_model(),
                         ["alpha1", "beta1", "omega"], draws, tune, chains,
                         1.25, max_treedepth=5)
    out["blocks"] = _garch_blocks(pm, card)
    print(json.dumps(out), flush=True)


# the block lengths timed for GARCH11's volatility (timeseries.GARCH_BLOCK)
# on a series of 5,000 returns at 256 and 2048 chains
GARCH_SWEEP = {"returns": 5000, "chains": (256, 2048),
               "blocks": (16, 32, 64, 128, 256)}


def _garch_blocks(pm, card):
    """GARCH11's block length on the card: for each of
    ``GARCH_SWEEP["blocks"]``, logp+grad ms and the peak device memory
    above what was allocated before, on phase 14's model over 5,000 seeded
    returns at 256 and 2048 chains, and its logp at 4 points against the
    chosen length's (float32, rtol 1e-5: the same terms summed in other
    blocks). The whole series' Toeplitz product would take 25.6 GB of
    powers at 256 chains and 205 GB at 2048."""
    from pymc3_tpu_torch.distributions import timeseries
    n = GARCH_SWEEP["returns"]
    returns = np.random.default_rng(5).normal(0, 1, n).astype(np.float32)
    with pm.Model() as model:
        alpha1 = pm.Uniform("alpha1", 0.0, 1.0)
        beta1 = pm.Uniform("beta1", 0.0, 1.0 - 0.01)
        omega = pm.Uniform("omega", 0.0, 10.0)
        pm.GARCH11("r", omega=omega, alpha_1=alpha1, beta_1=beta1,
                   initial_vol=1.0, shape=n, observed=returns)
    _on_card(model, "garch blocks")
    q = torch.as_tensor(np.random.default_rng(6).normal(
        0, 1, (4, len(model.dict_to_array(model.test_point)))),
        dtype=torch.float32, device=model.device)
    chosen = timeseries.GARCH_BLOCK
    rows, logps = {}, {}
    try:
        for L in GARCH_SWEEP["blocks"] + (chosen,):
            timeseries.GARCH_BLOCK = L
            logps[L] = model.logp_dlogp_function()(q)[0]
            for chains in GARCH_SWEEP["chains"]:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                base = torch.cuda.memory_allocated()
                ms = _logp_grad_ms(model, chains, calls=20)
                rows[f"L={L} chains={chains}"] = {
                    "logp_grad_ms": ms,
                    "peak_bytes": torch.cuda.max_memory_allocated() - base}
    finally:
        timeseries.GARCH_BLOCK = chosen
    for L, lp in logps.items():
        check_close(f"garch logp at L={L} against L={chosen}", lp,
                    logps[chosen], dict(rtol=1e-5, atol=0.0))
    print(f"garch blocks (n={n}, chosen L={chosen}): " + json.dumps(rows)
          + f" ({card})", flush=True)
    return {"chosen": chosen, "rows": rows}


def phase_es(pm, gp_cov, card, draws=1300, tune=300, chains=256):
    """A latent ``f ~ MvNormal(0, K)`` at 100 inputs on [0, 1] and ``y ~
    Normal(f, 0.3)`` (``examples/suite.py::es_model``), ``K`` built on the
    card by the port's ``ExpQuad(1, ls=0.2)``: one launch of the covariance
    kernel at (1, 100, 100, 1). ``EllipticalSlice(prior_cov=K)`` over 256
    chains, against the exact Gaussian posterior in float64: every mean
    within 4 standard errors (ESS-based), every sd within 10%. At 1024
    chains the phase took 127.7 s on the card, 27.7 s of it sampling: the
    rest was the host's rank-normalised ESS and R-hat over 100 coordinates
    of every draw, so the chains were cut to 256 (the sampling wall hardly
    moves with the chain count; the ESS falls by 4, to about 1,200, which
    holds an sd to 2%).

    R-hat < 1.25: the slowest coordinate holds 0.0033 effective draws per
    draw (1024 chains, 2000 draws on the card: R-hat 1.0973; 1300 draws:
    1.1357), so a half chain of 650 draws holds about 2 and split R-hat is
    about sqrt(1 + 1/2) = 1.22 by the formula, nearer 1.14 on the card.
    Tune is 300 (cut from 1000): the sampler has nothing to tune, and
    the chains start at the prior mean; at 500 the card read R-hat 1.1331,
    the means within 1.42 standard errors."""
    from pymc3_tpu_torch.examples.suite import es_exact_posterior, es_model
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    model, K = es_model(pm)
    launches = gp_cov.LAUNCHES
    _on_card(model, "es")
    if launches != 1 or gp_cov.BACKWARD_LAUNCHES != 0:
        fail(f"es: {launches} forward and {gp_cov.BACKWARD_LAUNCHES} "
             "backward launches building K, expected 1 and 0")
    step = pm.EllipticalSlice(vars=[model["f"]], prior_cov=K, model=model)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      step=step, progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    mean, sd = es_exact_posterior(K.cpu().numpy())
    f = np.asarray(trace["f"], dtype=np.float64)
    ess = np.asarray(pm.ess(trace, var_names=["f"])["f"], dtype=np.float64)
    rhat = float(np.max(pm.rhat(trace, var_names=["f"])["f"]))
    z = np.abs(f.mean(0) - mean) / (f.std(0) / np.sqrt(ess))
    sd_rel = float(np.max(np.abs(f.std(0) / sd - 1.0)))
    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains), device=model.device)
    loglik = model.datalogpt_fn()
    out = {"phase": "es", "chains": chains, "tune": tune, "draws": draws,
           "wall_s": wall, "min_ess": float(ess.min()),
           "ess_per_s": float(ess.min()) / wall, "rhat": rhat,
           "max_z": float(z.max()), "max_sd_rel": sd_rel,
           "forward_launches": launches,
           "loglik_ms": _synced_ms(lambda: loglik(q)),
           "logp_grad_ms": _logp_grad_ms(model, chains), "card": card}
    print(json.dumps(out), flush=True)
    if not (z.max() < 4.0 and sd_rel < 0.10):
        fail("es: the draws disagree with the exact posterior")
    if not rhat < 1.25:
        fail(f"es: R-hat {rhat:.4f} >= 1.25")
    return launches


def phase_labels(pm, card, draws=170, tune=30, chains=1024):
    """Six labels ``z_i ~ Categorical(w)`` of known component means with
    Dirichlet weights (``examples/suite.py::label_model``), sampled by
    ``[ElemwiseCategorical([z]), NUTS([w])]`` at 1024 chains; each label's
    marginal against the enumeration of all 729 states with the weights
    integrated out (Dirichlet-multinomial), within 4 standard errors.

    R-hat < 1.02 for ``z``: each label is redrawn from its full conditional
    every draw and holds 0.4 effective draws per draw (1024 chains, 400
    draws on the card: R-hat 1.0040; 200 draws: 1.0092; 170: 1.0108; 150:
    1.0127, too near the limit), so a half chain of 85 draws (170 kept for
    the run's budget) holds about 34 and split R-hat is about
    sqrt(1 + 1/34) = 1.015, the largest of six labels a little above."""
    from pymc3_tpu_torch.examples.suite import (label_exact_marginals,
                                                 label_model)
    model = label_model(pm)
    _on_card(model, "labels")
    step = [pm.ElemwiseCategorical([model["z"]], model=model),
            pm.NUTS([model["w"]], model=model)]
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      step=step, progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    if len(trace._straces[0].sampler_vars) != 1:
        fail("labels: expected one block of statistics (the NUTS)")
    z = np.asarray(trace["z"], dtype=np.int64)
    exact = label_exact_marginals()
    ess = np.asarray(pm.ess(trace, var_names=["z"])["z"], dtype=np.float64)
    rhat = float(np.max(pm.rhat(trace, var_names=["z"])["z"]))
    got = np.stack([(z == k).mean(0) for k in range(exact.shape[1])], 1)
    se = np.sqrt(exact * (1 - exact) / ess[:, None])
    zscore = float(np.max(np.abs(got - exact) / se))
    mean_depth, deepest = _depths(trace)
    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains), device=model.device)
    logp_fn = model.make_logp_fn()
    out = {"phase": "labels", "chains": chains, "tune": tune,
           "draws": draws, "wall_s": wall, "min_ess": float(ess.min()),
           "ess_per_s": float(ess.min()) / wall, "rhat": rhat,
           "max_z": zscore, "marginals": got.round(4).tolist(),
           "mean_tree_depth": mean_depth, "deepest_lane_depth": deepest,
           "logp_ms": _synced_ms(lambda: logp_fn(q)),
           "logp_grad_ms": _logp_grad_ms(model, chains), "card": card}
    print(json.dumps(out), flush=True)
    if not zscore < 4.0:
        fail(f"labels: a label marginal is {zscore:.2f} standard errors "
             "off the enumeration")
    if not rhat < 1.02:
        fail(f"labels: R-hat {rhat:.4f} >= 1.02")


def _reference_fits(config):
    """The JAX package's CPU fits or MAP of ``config`` (made by
    ``tests/torch_reference.py``)."""
    path = os.path.join(ROOT, "pymc3_tpu_torch", "examples",
                        "reference_moments.json")
    with open(path) as f:
        return json.load(f)["configs"][config]


def _device_busy(fn, steps):
    """The card's busy share and device operations per step over ``fn()``
    (``steps`` VI steps), from ``torch.profiler``: the device time of every
    kernel, copy and fill over the host clock of the window. Only the
    device's own events count; the host op that launched a kernel carries
    its time too. ``(None, None)`` where the profiler records no device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    device_us, ops = 0.0, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = getattr(e, "self_cuda_time_total", 0.0)
        device_us += t
        ops += e.count
    if device_us <= 0:
        return None, None
    return device_us / 1e6 / wall, ops / steps


def phase_advi_minibatch(pm, card, warm=50, profiled=20):
    """The JAX package's minibatch-ADVI benchmark at its widths
    (``scripts/bench_advi_minibatch.py``, ``examples/suite.py``): 50,000
    rows of ``RandomState(0)`` data, ``w ~ N(0, 1)`` and ``b ~ N(0, 1)``,
    Bernoulli on ``invlogit(X_mb w + b)`` with ``total_size = N``, ADVI
    with the default ``adagrad_window`` from the test point; at d = 100
    with batches of 500 for 5,000 steps, half the benchmark's 10,000 (which
    this phase ran until phases 25-26 came; the JAX fits of the gate are
    made at the same 5,000 steps), and at d = 512 with batches of 8192 for
    2,000 steps. Each timed fit follows a warm fit of ``warm``
    steps (the JAX benchmark's warm fit is a whole fit: it compiles; the
    port has nothing to compile, so the warm fit only brings the allocator
    and the host's caches to steady state); the timed fit is a new
    ``ADVI`` on the same model. Each timed fit is followed by ``profiled``
    steps under ``torch.profiler`` for the device's busy share.

    Gate: the fitted means and sds against two JAX fits of the same
    settings at seeds 1 and 2. Their difference estimates the optimizer's
    noise: with ``s`` the root mean square over the elements of (seed 1 -
    seed 2) / sqrt(2), the port's fit differs from the two fits' average by
    noise of sd ``s * sqrt(1.5)``; every element must lie within 5 of that
    (the largest of 100-500 standard normals is near 3.3)."""
    from pymc3_tpu_torch.examples.suite import (advi_logistic_data,
                                                 advi_logistic_model)
    ref = _reference_fits("advi_logistic")
    rows = {}
    for name in ("d100", "d512"):
        cfg = ref[name]
        N, d, batch, steps = cfg["N"], cfg["d"], cfg["batch"], cfg["steps"]
        X, y, w_true = advi_logistic_data(N, d)
        model = advi_logistic_model(pm, X, y, batch)
        _on_card(model, f"advi_minibatch {name}")
        with model:
            pm.ADVI().fit(n=warm, random_seed=1, progressbar=False)
            inference = pm.ADVI()
        torch.cuda.synchronize()
        t0 = time.time()
        approx = inference.fit(n=steps, random_seed=2, progressbar=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        mean, std = approx.mean, approx.std
        w = model.array_to_dict(mean)["w"]
        rmse = float(np.sqrt(np.mean((w - w_true) ** 2)))
        gate = _fit_gate(mean, std, cfg["fits"])
        busy, ops = _device_busy(
            lambda: inference.fit(n=profiled, random_seed=3,
                                  progressbar=False), profiled)
        rows[name] = {
            "N": N, "d": d, "batch": batch, "steps": steps, "wall_s": wall,
            "steps_per_s": steps / wall, "host_ms_per_step": 1e3 * wall / steps,
            "last100_loss": float(np.mean(approx.hist[-100:])),
            "jax_last100_loss": [f["last100_loss"] for f in cfg["fits"]],
            "coef_rmse": rmse,
            "jax_coef_rmse": [f["coef_rmse"] for f in cfg["fits"]],
            "device_busy_share": busy, "device_ops_per_step": ops,
            "gate": gate}
        print(f"advi_minibatch {name}: " + json.dumps(rows[name]),
              flush=True)
        if not gate["pass"]:
            fail(f"advi_minibatch {name}: the fit is {gate['max_z']:.2f} "
                 "noise sds from the JAX fits")
        del model, inference, approx
    print(json.dumps({"phase": "advi_minibatch", **rows, "card": card}),
          flush=True)
    return rows


def _fit_gate(mean, std, fits, z_max=5.0):
    """``mean`` and ``std`` against two fits on other random streams: the
    largest |difference from their average| in units of the noise the two
    fits show (see :func:`phase_advi_minibatch`), for the means and the sds
    each on its own."""
    worst = 0.0
    for got, key in ((mean, "mean"), (std, "std")):
        a, b = (np.asarray(f[key]) for f in fits)
        s = np.sqrt(np.mean((a - b) ** 2) / 2.0)
        z = np.abs(np.asarray(got, np.float64) - 0.5 * (a + b)) / (
            s * np.sqrt(1.5) + 1e-12)
        worst = max(worst, float(z.max()))
    return {"pass": bool(worst < z_max), "max_z": round(worst, 2),
            "z_max": z_max}


def phase_advi_gp(pm, gp_cov, card, tune=50, draws=150, chains=256,
                  n_init=500, warm=20):
    """ADVI and full-rank ADVI on the GP (``examples/suite.py``, n = 200)
    after a warm fit of ``warm`` steps: Adam at rate 0.01 for 1000 steps
    (full-rank: 1500), then a new Adam at rate 0.001 for 1000, fifty
    Monte-Carlo samples a step, as ``tests/torch_reference.py`` ran the JAX
    package. Each step evaluates the marginal likelihood once under
    ``vmap`` over the samples: one forward and one backward launch of the
    covariance kernels at a batch of 50, so the launches must equal the
    steps taken. The timed fit is a new inference on the same model.

    Gate: each family's means and sds within 5 noise sds of the two JAX
    fits' average, the noise measured by the two fits' difference
    (:func:`_fit_gate`, as phase 17). The JAX fits at seeds 1 and 2 differ
    by root mean squares of 0.0021 (means) and 0.0076 (sds) for ADVI and
    0.011 and 0.044 for full-rank ADVI, whose sd of ``sigma`` is the
    noisiest (0.089 against 0.165 after stages of 1500 and 1000 steps).

    Then BEST at 256 chains with ``init="advi+adapt_diag"`` (ADVI for at
    most ``n_init`` steps, stopped early by the convergence callbacks; 1000
    until phase 25's logp+grad timings came), 50 tune + 150 draws (the
    ADVI fit gives the mass matrix its start), gated as phase 7 against
    ``BASELINE_CPU.json`` (R-hat 1.0046 at 200 draws on the card, so about
    1.006 at 150).
    Returns the forward and backward launches of the two fits."""
    from pymc3_tpu_torch.examples.suite import best_model, gp_regression
    ref = _reference_fits("advi_gp")
    out = {"phase": "advi_gp", "card": card}
    launches = {"forward": 0, "backward": 0}
    for method in ("advi", "fullrank_advi"):
        steps = sum(n for n, _ in ref["stages"][method])
        model = gp_regression(pm)[0]
        _on_card(model, "advi_gp")
        family = pm.ADVI if method == "advi" else pm.FullRankADVI
        gp_cov.LAUNCHES = 0
        gp_cov.BACKWARD_LAUNCHES = 0
        family(model=model).fit(n=warm, random_seed=1, progressbar=False,
                                obj_n_mc=ref["obj_n_mc"])
        inference = family(model=model)
        torch.cuda.synchronize()
        t0 = time.time()
        for k, (n, rate) in enumerate(ref["stages"][method]):
            approx = inference.fit(n=n, random_seed=2 + 10 * k,
                                   progressbar=False,
                                   obj_optimizer=pm.adam(learning_rate=rate),
                                   obj_n_mc=ref["obj_n_mc"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        got = {"forward": gp_cov.LAUNCHES, "backward": gp_cov.BACKWARD_LAUNCHES}
        for k in launches:
            launches[k] += got[k]
        fits = ref[method]
        jmean, jsd = (0.5 * (np.asarray(fits[0][k]) + np.asarray(fits[1][k]))
                      for k in ("mean", "std"))
        gate = _fit_gate(approx.mean, approx.std, fits)
        out[method] = {"steps": steps, "wall_s": wall,
                       "steps_per_s": steps / wall,
                       "host_ms_per_step": 1e3 * wall / steps,
                       "launches": got, "mean": approx.mean.tolist(),
                       "std": approx.std.tolist(),
                       "jax_mean": jmean.tolist(), "jax_std": jsd.tolist(),
                       "max_mean_over_sd": float(np.max(
                           np.abs(approx.mean - jmean) / jsd)),
                       "max_sd_rel": float(np.max(np.abs(approx.std / jsd
                                                         - 1.0))),
                       "gate": gate}
        print(f"advi_gp {method}: " + json.dumps(out[method]), flush=True)
        if got["forward"] != steps + warm or got["backward"] != steps + warm:
            fail(f"advi_gp {method}: {got} launches for {steps + warm} "
                 "steps, expected one forward and one backward a step")
        if not gate["pass"]:
            fail(f"advi_gp {method}: the fit is {gate['max_z']:.2f} noise "
                 "sds from the JAX fits")

    model, names = best_model(pm)
    _on_card(model, "best advi init")
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      init="advi+adapt_diag", n_init=n_init,
                      progressbar=False, random_seed=2,
                      axis_name="chains_local",
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    out["best_advi_init"] = _gate(
        pm, trace, names, _baseline()["best"]["moments"], wall,
        f"best init=advi+adapt_diag chains={chains} tune={tune} "
        f"draws={draws}")
    print(json.dumps(out), flush=True)
    return launches


def phase_svgd_map(pm, card, particles=256, svgd_steps=500, chains=64,
                   tune=50, draws=150):
    """SVGD with ``particles`` particles (Adam at rate 0.1) on a bivariate
    conjugate normal (``examples/suite.py::conjugate_model``): the
    particles' means within 0.1 posterior sd of the closed form, their sds
    within 10% and their correlation within 0.05 (256 particles of SVGD
    with the median bandwidth come within 2% in sd on the CPU).

    ``find_MAP`` on radon from the test point: -logp at the optimum within
    1e-4 (relative) of the JAX package's and the flat point within 0.02
    (L-BFGS-B stops on a flat ridge of ``sigma_a`` against the county
    offsets: the two packages' optima differ by 0.2% in ``sigma_a`` on the
    CPU). ``find_hessian`` at the JAX package's optimum: its diagonal within
    1e-3 (relative) and its log-determinant within 0.01.

    ``sample(init="map")`` on the conjugate normal (a dense mass matrix
    from the inverse Hessian, so a short tune only sets the step size),
    ``chains`` chains, against the closed form through ``moment_check``
    (R-hat 1.0059 at 200 draws on the card, about 1.008 at 150)."""
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.examples.suite import (conjugate_model,
                                                 conjugate_posterior)
    mean, cov = conjugate_posterior()
    sd = np.sqrt(np.diag(cov))
    corr = cov[0, 1] / (sd[0] * sd[1])
    model = conjugate_model(pm)
    _on_card(model, "svgd")
    t0 = time.time()
    approx = pm.fit(n=svgd_steps, method="svgd", model=model, random_seed=3,
                    progressbar=False, inf_kwargs={"n_particles": particles},
                    obj_optimizer=pm.adam(learning_rate=0.1))
    torch.cuda.synchronize()
    svgd_wall = time.time() - t0
    h = approx.histogram.astype(np.float64)
    svgd = {"wall_s": svgd_wall, "ms_per_step": 1e3 * svgd_wall / svgd_steps,
            "mean": h.mean(0).tolist(), "sd": h.std(0).tolist(),
            "corr": float(np.corrcoef(h.T)[0, 1]), "exact_mean": mean.tolist(),
            "exact_sd": sd.tolist(), "exact_corr": float(corr)}
    print("svgd: " + json.dumps(svgd), flush=True)
    if not (np.all(np.abs(h.mean(0) - mean) < 0.1 * sd)
            and np.all(np.abs(h.std(0) / sd - 1) < 0.1)
            and abs(svgd["corr"] - corr) < 0.05):
        fail("svgd: the particles disagree with the closed form")

    ref = _reference_fits("map_radon")
    radon = build_model(pm)
    _on_card(radon, "map radon")
    t0 = time.time()
    with radon:
        point, res = pm.find_MAP(progressbar=False, return_raw=True)
    map_wall = time.time() - t0
    q = radon.dict_to_array(point).astype(np.float64)
    q_err = float(np.abs(q - np.asarray(ref["q"])).max())
    f_rel = abs(float(res.fun) - ref["neg_logp"]) / abs(ref["neg_logp"])
    t0 = time.time()
    H = np.asarray(pm.find_hessian(radon.array_to_dict(np.asarray(
        ref["q"], np.float32)), model=radon), np.float64)
    torch.cuda.synchronize()
    hess_wall = time.time() - t0
    diag_rel = float(np.max(np.abs(np.diag(H) / np.asarray(
        ref["hessian_diag"]) - 1)))
    sign, logdet = np.linalg.slogdet(H)
    radon_out = {"map_wall_s": map_wall, "iterations": int(res.nit),
                 "jax_iterations": ref["iterations"],
                 "neg_logp": float(res.fun), "jax_neg_logp": ref["neg_logp"],
                 "max_abs_q_err": q_err, "hessian_wall_s": hess_wall,
                 "hessian_max_diag_rel": diag_rel,
                 "hessian_logdet": float(logdet),
                 "jax_hessian_logdet": ref["hessian_logdet"]}
    print("map radon: " + json.dumps(radon_out), flush=True)
    if not (f_rel < 1e-4 and q_err < 0.02):
        fail("map radon: find_MAP disagrees with the JAX package's")
    if not (sign > 0 and diag_rel < 1e-3
            and abs(logdet - ref["hessian_logdet"]) < 0.01):
        fail("map radon: find_hessian disagrees with the JAX package's")

    model = conjugate_model(pm)
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      init="map", progressbar=False, random_seed=2,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    gate = _gate(pm, trace, ["mu"], _exact_ref({"mu": {"mean": mean,
                                                       "sd": sd}}), wall,
                 f"conjugate init=map chains={chains} tune={tune} "
                 f"draws={draws}", against="the closed form")
    print(json.dumps({"phase": "svgd_map", "svgd": svgd, "radon": radon_out,
                      "init_map": gate, "card": card}), flush=True)


#: ``sample_prior_predictive``'s dtypes on radon: the JAX package's, which
#: ``tests/test_torch_call_parity.py`` holds both packages to on the CPU
RADON_PRIOR_DTYPES = {
    "mu_a": "float64", "sigma_a": "float64", "sigma_a_log__": "float32",
    "mu_b": "float64", "sigma_b": "float64", "sigma_b_log__": "float32",
    "a": "float64", "b": "float64", "eps": "float64", "eps_log__": "float32",
    "radon_like": "float64"}


def _median_ms(fn, reps):
    """The median host wall of ``reps`` calls of ``fn``, in ms."""
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        walls.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(walls))


def phase_api(pm, card, draws=1_000_000, reps=20):
    """30. The JAX package's call forms on the card (each is held against
    the JAX package on the CPU by ``tests/test_torch_call_parity.py``):

    (a) ``Normal.dist(0, 1).random(size=1_000_000)`` is a numpy float64
        array whose mean and sd are within 5 Monte-Carlo standard errors
        of 0 and 1 (1/sqrt(n) and 1/sqrt(2n)); its host ms beside the same
        draws left on the card (``_random`` and a synchronize): the
        difference is the one copy back and the cast;
    (b) radon's ``logp_dlogp_function()`` at one flat numpy point gives
        ``(float, numpy array)`` equal bit for bit to row 0 of the batched
        call on the same point; the host ms of each (the batched call with
        a synchronize);
    (c) scipy's L-BFGS-B driven through ``f(q, grad_out=g)``
        (``examples.suite.lbfgs_through_grad_out``) takes the same
        iterates as the same run through the batched call at one chain,
        and reaches the JAX package's optimum of the same function
        (``reference_moments.json``'s ``lbfgs_radon``): -logp within 1e-3
        of the port's -logp at the JAX package's optimum, and the point
        within 0.02 (the flat ridge of phase 19). ``find_MAP`` maximizes
        the logp without the jacobians, so its point is another one;
    (d) ``make_logp_fn(jacobian=False)`` at one point equals the logp with
        the jacobians less the log-jacobians of ``sigma_a``, ``sigma_b``
        and ``eps``, to 1e-6 relative (two float32 sums of about 1e3 in
        different orders);
    (e) ``sample_prior_predictive`` on radon gives ``RADON_PRIOR_DTYPES``;
    (f) ``draw_values`` with a distribution among the parameters draws
        from it at ``size`` on the card;
    (g)-(j) the call forms repaired after these (:func:`_api_repaired`).

    The phase fails if the wall of (a)-(f) passes 10 s, or that of
    (g)-(j) passes ``API_REPAIRED_WALL_S``."""
    from scipy.optimize import minimize
    from pymc3_tpu_torch.distributions import draw_values
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.examples.suite import lbfgs_through_grad_out
    t_phase = time.time()
    out = {"phase": "api", "card": card}

    dist = pm.Normal.dist(0.0, 1.0)
    device = dist.device
    gen = torch.Generator(device=device).manual_seed(30)
    x = dist.random(size=draws, gen=gen)
    ok = isinstance(x, np.ndarray) and x.dtype == np.float64 \
        and x.shape == (draws,)
    mean, sd = float(x.mean()), float(x.std())

    def drawn_on_card():
        dist._random(size=draws, gen=gen)
        torch.cuda.synchronize()
    random_ms = _median_ms(lambda: dist.random(size=draws, gen=gen), 5)
    card_ms = _median_ms(drawn_on_card, 5)
    out["random"] = {"draws": draws, "type": type(x).__name__,
                     "dtype": str(x.dtype), "mean": mean, "sd": sd,
                     "host_ms": random_ms, "on_card_ms": card_ms,
                     "copy_and_cast_ms": random_ms - card_ms}
    if not (ok and abs(mean) < 5 / np.sqrt(draws)
            and abs(sd - 1) < 5 / np.sqrt(2 * draws)):
        fail(f"api: Normal.dist(0, 1).random(): {out['random']}")

    radon = build_model(pm)
    _on_card(radon, "api radon")
    f = radon.logp_dlogp_function()
    q0 = f.dict_to_array(radon.test_point)
    q = (q0 + 0.1 * np.random.RandomState(30).randn(q0.size)).astype(
        np.float32)
    logp, grad = f(q)
    qt = torch.as_tensor(q, device=device)[None]
    blogp, bgrad = f(qt)
    same = isinstance(logp, float) and isinstance(grad, np.ndarray) \
        and logp == float(blogp[0]) \
        and np.array_equal(grad, bgrad[0].cpu().numpy())

    def batched_call():
        f(qt)
        torch.cuda.synchronize()
    out["one_point"] = {"bitwise_equal": bool(same),
                        "point_ms": _median_ms(lambda: f(q), reps),
                        "batched_1_chain_ms": _median_ms(batched_call, reps)}
    if not same:
        fail("api: the one-point logp_dlogp_function call differs from "
             "row 0 of the batched call")

    ref = _reference_fits("lbfgs_radon")
    t0 = time.time()
    res = lbfgs_through_grad_out(f, q0)
    lbfgs_wall = time.time() - t0

    def batched_neg(x):
        lp, g = f(torch.as_tensor(x, dtype=torch.float32,
                                  device=device)[None])
        return -float(lp[0]), -g[0].cpu().numpy().astype(np.float64)
    res_b = minimize(batched_neg, np.asarray(q0, np.float64), jac=True,
                     method="L-BFGS-B")
    at_ref = -f(np.asarray(ref["q"], np.float32))[0]
    q_err = float(np.abs(res.x - np.asarray(ref["q"])).max())
    out["lbfgs"] = {"iterations": int(res.nit), "wall_s": lbfgs_wall,
                    "neg_logp": float(res.fun),
                    "neg_logp_at_jax_optimum": at_ref,
                    "jax_neg_logp": ref["neg_logp"],
                    "jax_iterations": ref["iterations"],
                    "max_abs_q_err": q_err,
                    "same_as_batched": bool(np.array_equal(res.x, res_b.x)
                                            and res.nit == res_b.nit)}
    if not out["lbfgs"]["same_as_batched"]:
        fail("api: L-BFGS through grad_out left the batched call's path")
    if not (abs(res.fun - at_ref) < 1e-3 and q_err < 0.02):
        fail(f"api: L-BFGS through grad_out missed the JAX package's "
             f"optimum: {out['lbfgs']}")

    nojac = radon.make_logp_fn(jacobian=False)(q)
    jac = radon.make_logp_fn()(q)
    order = radon.ordering.by_name
    logjac = sum(float(rv.transform.jacobian_det(
        torch.as_tensor(q[order[rv.name].slc], device=device), {},
        {}).sum())
        for rv in radon.free_RVs if rv.orig_name in ("sigma_a", "sigma_b",
                                                      "eps"))
    want = float(jac) - logjac
    out["logp_nojac"] = {"got": float(nojac), "want": want,
                         "dims": list(nojac.shape)}
    if not (nojac.dim() == 0 and nojac.device.type == radon.device.type
            and abs(float(nojac) - want) <= 1e-6 * abs(want)):
        fail(f"api: make_logp_fn(jacobian=False): {out['logp_nojac']}")

    prior = pm.sample_prior_predictive(samples=100, model=radon,
                                       random_seed=30)
    dtypes = {k: str(v.dtype) for k, v in prior.items()}
    out["prior_dtypes"] = dtypes
    if dtypes != RADON_PRIOR_DTYPES or not all(
            np.all(np.isfinite(v)) for v in prior.values()):
        fail(f"api: sample_prior_predictive's dtypes {dtypes}")

    draw, two = draw_values([pm.Normal.dist(0.0, 1.0), 2.0], size=3)
    out["draw_values"] = {"shape": list(draw.shape),
                          "device": str(draw.device), "constant": float(two)}
    if not (tuple(draw.shape) == (3,) and draw.device.type == device.type
            and bool(torch.isfinite(draw).all()) and float(two) == 2.0):
        fail(f"api: draw_values: {out['draw_values']}")

    torch.cuda.synchronize()
    out["wall_s"] = time.time() - t_phase
    out["repaired"] = _api_repaired(pm)
    print(json.dumps(out), flush=True)
    if out["wall_s"] > 10.0:
        fail(f"api: (a)-(f) took {out['wall_s']:.1f} s, over 10 s")
    if out["repaired"]["wall_s"] > API_REPAIRED_WALL_S:
        fail(f"api: (g)-(j) took {out['repaired']['wall_s']:.1f} s, over "
             f"{API_REPAIRED_WALL_S} s")


# the cholesky model of phase 30 (j): 20 tune + 20 draws of 4 chains
API_CHOLESKY = {"chains": 4, "tune": 20, "draws": 20}
# the wall limit of phase 30's (g)-(j): the short sample of (j) included
API_REPAIRED_WALL_S = 20.0


def _cholesky_probe(pm):
    """``r ~ Normal(0, 1)`` and the log-diagonal of the Cholesky factor of
    [[1, r], [r, 1]] as a potential: 0.5 log(1 - r^2), NaN where |r| >=
    1."""
    with pm.Model() as model:
        r = pm.Normal("r", 0.0, 1.0)
        L = pm.math.cholesky(pm.math.stack([pm.math.stack([1.0, r]),
                                            pm.math.stack([r, 1.0])]))
        pm.Potential("p", pm.math.sum(pm.math.log(pm.math.extract_diag(L))))
    return model


def _api_repaired(pm):
    """Phase 30's call forms that the port once answered otherwise than
    the JAX package, on the card (each held against the JAX package on the
    CPU by ``tests/test_torch_result_faults.py``), each against the plain
    expectation printed on its line:

    (g) ``pm.math.eye(3)`` on a model on the card, in ``floatX`` on the
        model's device, inside a logp: ``x ~ N(0, 1)`` (3) plus the
        potential -|x (2 I)|^2 at x = (0.3, -0.2, 0.5): -3/2 log(2 pi) -
        4.5 |x|^2, rtol 1e-6;
    (h) ``outer`` of a (2, 2) and a (3,) card tensor is the (4, 3) outer
        product of the flattened operands, ``full_like`` of a (3, 4) card
        tensor and a (4,) one its rows, both on the card, equal to numpy;
    (i) ``Minibatch(data, batch_size=[10, 2])`` (100 rows, 3 columns): the
        logp of a normal mean model observed through it, with the draw's
        rows, equals the plain sum of the normal log densities of those
        rows x 100 / 10 plus the prior's (rtol 1e-5); then one ADVI step on
        the card, its loss and parameters finite;
    (j) ``pm.math.cholesky`` of a non-positive-definite matrix: the
        :func:`_cholesky_probe` logp is 0.5 log(0.75) - log(2 pi) / 2 -
        0.125 at r = 0.5 and NaN at r = 2, in one batched call; then
        ``sample()`` at ``API_CHOLESKY`` finishes with every draw in |r| < 1
        and the NaN region's steps counted as divergences (more than 0)."""
    from pymc3_tpu_torch.config import torch_floatX
    from pymc3_tpu_torch.data import minibatch_nodes
    from pymc3_tpu_torch.node import current_device
    t0 = time.time()
    out = {}
    device = current_device()

    with pm.Model() as model:
        x = pm.Normal("x", 0.0, 1.0, shape=3)
        eye = pm.math.eye(3)
        pm.Potential("p", -pm.math.sum(pm.math.sqr(
            pm.math.dot(x, 2.0 * eye))))
    _on_card(model, "api eye")
    q = np.array([0.3, -0.2, 0.5])
    got = float(model.logp_dlogp_function()(torch.as_tensor(
        q[None], dtype=torch_floatX(), device=model.device))[0][0])
    want = -1.5 * np.log(2 * np.pi) - 4.5 * float(q @ q)
    out["eye"] = {"dtype": str(eye.dtype), "device": str(eye.device),
                  "logp": got, "want": want}
    print("api eye in a logp: " + json.dumps(out["eye"]), flush=True)
    if not (eye.dtype == torch_floatX()
            and eye.device.type == model.device.type
            and abs(got - want) <= 1e-6 * abs(want)):
        fail(f"api: eye in a logp: {out['eye']}")

    rng = np.random.RandomState(31)
    a, b, c = rng.randn(2, 2), rng.randn(3), rng.randn(3, 4)
    fill = rng.randn(4)
    card = {k: torch.as_tensor(v, dtype=torch_floatX(), device=device)
            for k, v in (("a", a), ("b", b), ("c", c), ("fill", fill))}
    outer = pm.math.outer(card["a"], card["b"])
    full = pm.math.full_like(card["c"], card["fill"])
    err = {"outer": float(np.abs(outer.test_value - np.outer(
        a.ravel(), b)).max()), "full_like": float(np.abs(
            full.test_value - np.broadcast_to(fill, (3, 4))).max())}
    out["outer_full_like"] = {
        "shapes": [list(outer.test_value.shape),
                   list(full.test_value.shape)],
        "devices": [str(outer.value.device), str(full.value.device)],
        "max_abs_err": err}
    print("api outer, full_like: " + json.dumps(out["outer_full_like"]),
          flush=True)
    if not (outer.test_value.shape == (4, 3) and full.test_value.shape ==
            (3, 4) and outer.value.device.type == full.value.device.type ==
            device.type
            and max(err.values()) < 1e-6):
        fail(f"api: outer/full_like on the card: {out['outer_full_like']}")

    data = rng.randn(100, 3) + 1.0
    batch = pm.Minibatch(data, batch_size=[10, 2], random_seed=9)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 1.0, shape=3)
        pm.Normal("obs", mu, 1.0, observed=batch, total_size=100)
    node = minibatch_nodes(model)[0]
    rows = torch.as_tensor(rng.randint(0, 100, size=10), device=device)
    m = np.array([0.9, 1.1, 1.0])
    got = float(model.logp_point_fn()(torch.as_tensor(
        m, dtype=torch_floatX(), device=device), {node.noise_key: rows}))
    picked = data[rows.cpu().numpy()]

    def normal(v, loc):
        return -0.5 * np.log(2 * np.pi) - 0.5 * (v - loc) ** 2
    want = float(10.0 * normal(picked, m).sum() + normal(m, 0.0).sum())
    with model:
        approx = pm.fit(n=1, method="advi", random_seed=31,
                        progressbar=False)
    finite = bool(np.isfinite(approx.hist).all() and all(
        bool(torch.isfinite(t).all()) for g in approx.params.values()
        for t in g.values()))
    out["minibatch"] = {"batch_size": list(batch.batch_size),
                        "sampling": batch.sampling,
                        "noise_shape": list(node.noise_shape(1)),
                        "logp": got, "want": want, "advi_step_finite": finite}
    print("api per-axis Minibatch: " + json.dumps(out["minibatch"]),
          flush=True)
    if not (batch.sampling == "random" and abs(got - want) <= 1e-5 *
            abs(want) and finite):
        fail(f"api: per-axis Minibatch: {out['minibatch']}")

    model = _cholesky_probe(pm)
    _on_card(model, "api cholesky")
    lp = model.logp_dlogp_function()(torch.as_tensor(
        [[0.5], [2.0]], dtype=torch_floatX(), device=device))[0].cpu()
    want = 0.5 * np.log(0.75) - 0.5 * np.log(2 * np.pi) - 0.125
    trace = pm.sample(model=model, progressbar=False, random_seed=31,
                      compute_convergence_checks=False, **API_CHOLESKY)
    r = np.asarray(trace["r"])
    n_div = int(np.sum(trace.get_sampler_stats("diverging")))
    out["cholesky"] = {"logp_at_half": float(lp[0]), "want": want,
                       "logp_at_2_is_nan": bool(np.isnan(float(lp[1]))),
                       "draws": list(r.shape),
                       "max_abs_r": float(np.abs(r).max()),
                       "divergences": n_div}
    print("api cholesky model: " + json.dumps(out["cholesky"]), flush=True)
    if not (abs(float(lp[0]) - want) <= 1e-5 * abs(want)
            and out["cholesky"]["logp_at_2_is_nan"] and r.shape == (
                API_CHOLESKY["chains"] * API_CHOLESKY["draws"],)
            and np.abs(r).max() < 1.0 and n_div > 0):
        fail(f"api: the cholesky model on the card: {out['cholesky']}")
    torch.cuda.synchronize()
    out["wall_s"] = time.time() - t0
    return out


class _HostReads:
    """Counts the device-to-host reads of a block (``Tensor.item``,
    ``__bool__``, ``__float__``, ``tolist``) while it runs."""

    NAMES = ("item", "__bool__", "__float__", "tolist")

    def __enter__(self):
        self.count = 0
        self._orig = {n: getattr(torch.Tensor, n) for n in self.NAMES}
        for name, orig in self._orig.items():
            def spy(t, *a, _orig=orig, **k):
                self.count += 1
                return _orig(t, *a, **k)
            setattr(torch.Tensor, name, spy)
        return self

    def __exit__(self, *exc):
        for name, orig in self._orig.items():
            setattr(torch.Tensor, name, orig)


class _LaunchShapes:
    """Records the (B, n, m, d) of every forward and backward kernel call
    while it is entered."""

    def __init__(self, gp_cov):
        self.gp_cov = gp_cov

    def __enter__(self):
        gp_cov = self.gp_cov
        self.forward, self.backward = [], []
        self._orig = gp_cov._launch, gp_cov._launch_backward
        launch, launch_b = self._orig

        def spy(kind, X, Xs):
            self.forward.append((X.shape[0], X.shape[1], Xs.shape[1],
                                 X.shape[2]))
            return launch(kind, X, Xs)

        def spy_b(kind, g, X, Xs):
            self.backward.append((X.shape[0], X.shape[1], Xs.shape[1],
                                  X.shape[2]))
            return launch_b(kind, g, X, Xs)
        gp_cov._launch, gp_cov._launch_backward = spy, spy_b
        return self

    def __exit__(self, *exc):
        self.gp_cov._launch, self.gp_cov._launch_backward = self._orig


class _SMCCounts:
    """Counts the stages (calls of ``SMC.update_weights_beta``), the
    mutation steps (calls of ``_mutation_step``) and the host reads
    (:class:`_HostReads`) of the ``sample_smc`` calls made while it is
    entered."""

    def __enter__(self):
        from pymc3_tpu_torch.smc import smc as smc_mod
        self.stages = self.steps = 0
        self._mod = smc_mod
        self._orig = smc_mod._mutation_step, smc_mod.SMC.update_weights_beta
        step, update = self._orig

        def step_spy(*a, **k):
            self.steps += 1
            return step(*a, **k)

        def update_spy(smc):
            self.stages += 1
            return update(smc)
        smc_mod._mutation_step = step_spy
        smc_mod.SMC.update_weights_beta = update_spy
        self._reads = _HostReads().__enter__()
        return self

    def __exit__(self, *exc):
        self._reads.__exit__(*exc)
        self.reads = self._reads.count
        self._mod._mutation_step, self._mod.SMC.update_weights_beta = \
            self._orig


def phase_smc_bimodal(pm, card, particle_counts=(65_536, 1_048_576),
                      n_steps=25):
    """The JAX package's SMC benchmark (``scripts/bench_smc.py``):
    ``Uniform(-8, 8, shape=2)`` under two unnormalised Gaussian bumps at
    (3, 3) and (-3, -3), sd 0.5, ``n_steps`` 25, at 65,536 and at 1,048,576
    particles, through ``pm.sample_smc``. Prints particle updates/s
    (particles x mutation steps / wall, the steps summed over the stages),
    the stages and the host reads per stage (three: β with the evidence
    increment, the proposal's flag, the mean acceptance; the prior draws
    and the trace's one copy make none).

    Gates, with N the particles and S the stages:
    - the log evidence against the closed form log(pi / 512) = -5.0938:
      each stage's incremental weight at ESS = N/2 has a relative variance
      of 1, so Var(log Z) is about S / N_eff; with N_eff = N / 4 for the
      duplicates resampling leaves that 25 independent-Metropolis steps
      do not fully separate, the limit is 5 sqrt(4 S / N) (0.078 at 65,536
      and 4 stages, 0.0195 at 1,048,576; the JAX package's runs on the TPU
      missed by 0.002 and 0.001, ``BENCH_SUITE_r05.json``);
    - the benchmark's own moment gate: each coordinate's mean within 0.3
      of 0 and sd within 0.3 of sqrt(9.25) (a 5% skew of the modes moves
      the mean by 0.3), so the mode balance within 5%;
    - each mode's mean within 5 standard errors of 3 (or -3) and its sd
      within 5 relative standard errors of 0.5, the errors taken at an
      effective sample of a hundredth of the mode's particles (0.5 /
      sqrt(N_mode / 100) and 1 / sqrt(2 N_mode / 100));
    - exactly three host reads per stage."""
    from pymc3_tpu_torch.examples.suite import (SMC_BIMODAL_LOG_EVIDENCE,
                                                 smc_bimodal_model)
    out = {"phase": "smc_bimodal", "n_steps": n_steps, "card": card,
           "runs": []}
    # one untimed run first, as the benchmark compiles before it times: the
    # first use of each library kernel (searchsorted, the Cholesky) loads it
    pm.sample_smc(draws=4096, n_steps=2, model=smc_bimodal_model(pm),
                  random_seed=1)
    for n in particle_counts:
        model = smc_bimodal_model(pm)
        _on_card(model, "smc_bimodal")
        torch.cuda.synchronize()
        t0 = time.time()
        with _SMCCounts() as counts:
            trace = pm.sample_smc(draws=n, n_steps=n_steps, model=model,
                                  random_seed=2)
        wall = time.time() - t0
        stages, reads = counts.stages, counts.reads
        x = np.asarray(trace["x"], np.float64)
        pos = x[:, 0] > 0
        lml = trace.report.log_marginal_likelihood
        tol = 5.0 * np.sqrt(4.0 * stages / n)
        row = {"particles": n, "stages": stages,
               "mutation_steps": counts.steps, "wall_s": wall,
               "particle_updates_per_s": n * counts.steps / wall,
               "host_reads_per_stage": reads / stages,
               "log_marginal_likelihood": lml,
               "evidence_error": lml - SMC_BIMODAL_LOG_EVIDENCE,
               "evidence_tol": tol, "mode_balance": float(pos.mean()),
               "mean": x.mean(0).tolist(), "sd": x.std(0).tolist(),
               "modes": {}}
        ok = abs(lml - SMC_BIMODAL_LOG_EVIDENCE) < tol and \
            reads == 3 * stages and \
            np.all(np.abs(x.mean(0)) < 0.3) and \
            np.all(np.abs(x.std(0) - np.sqrt(9.25)) < 0.3)
        for sign, mask in ((1, pos), (-1, ~pos)):
            xm = x[mask]
            eff = len(xm) / 100.0
            z_mean = float(np.max(np.abs(xm.mean(0) - 3.0 * sign)
                                  / (0.5 / np.sqrt(eff))))
            z_sd = float(np.max(np.abs(xm.std(0) / 0.5 - 1.0)
                                * np.sqrt(2.0 * eff)))
            row["modes"]["+" if sign > 0 else "-"] = {
                "particles": int(len(xm)), "mean": xm.mean(0).tolist(),
                "sd": xm.std(0).tolist(), "z_mean": z_mean, "z_sd": z_sd}
            ok = ok and z_mean < 5.0 and z_sd < 5.0
        out["runs"].append(row)
        print(f"smc_bimodal {n} particles: " + json.dumps(row), flush=True)
        if not ok:
            fail(f"smc_bimodal at {n} particles disagrees with the target")
        del trace, model
    print(json.dumps(out), flush=True)
    return out


def _smc_reference_gate(got, ref, names, z_max=4.0, sd_rtol=0.2):
    """SMC moments against a reference with SMC's own Monte-Carlo error:
    |mean - reference mean| over sqrt(s^2 + mcse^2) below ``z_max``, where
    s (``got["smc_error"]``) is the error of the SMC mean, measured as the
    spread of the means of several SMC runs at the same particle count,
    and ``mcse`` the reference's own; sds within ``sd_rtol``."""
    worst_z = worst_sd = 0.0
    for v in names:
        s = got["smc_error"][v]
        z = abs(got["mean"][v] - ref[v]["mean"]) / np.sqrt(
            s ** 2 + ref[v]["mcse"] ** 2)
        worst_z = max(worst_z, float(z))
        worst_sd = max(worst_sd, abs(got["sd"][v] / ref[v]["sd"] - 1.0))
    return {"pass": bool(worst_z < z_max and worst_sd < sd_rtol),
            "max_z": round(worst_z, 2), "max_sd_rel": round(worst_sd, 3)}


def phase_smc_gp(pm, gp_cov, card, particles=4096, abc_particles=4096):
    """``pm.sample_smc`` on the GP of ``examples/suite.py`` (n = 200,
    ExpQuad) at 4,096 particles: the prior and likelihood of all particles
    are one ``vmap``, so each mutation step, and the first evaluation, is
    one forward launch at (4096, 200, 200, 1); the launches must equal the
    steps plus one, every one at that shape.

    Gates:
    - ``ls``, ``eta`` and ``sigma`` against ``BASELINE_CPU.json``'s GP: each
      mean within 4 of sqrt(s^2 + mcse^2), where s is the sd of the means
      of the JAX package's four SMC runs at 4,096 particles (SMC's own
      Monte-Carlo error, ``tests/torch_reference.py smc_gp``) and mcse the
      baseline's; each sd within 20% (``moment_check``'s limit);
    - the log evidence within 4 sds of the mean of those four JAX runs,
      the sd taken over the runs with the error of their mean added
      (sqrt(1 + 1/4) of it).

    Then SMC-ABC on the model of ``tests/test_smc.py:67`` with a torch
    simulator (``a + b * zeros(200)``) at 4,096 particles: the distance is
    (a - mean(y))^2 + var(y), so the pseudo-posterior of ``a`` is normal,
    precision 1 / 0.5^2 + 1 / 5^2, mean mean(y) 4 / 4.04, and ``b`` keeps
    its HalfNormal(2) prior (mean 1.596, sd 1.206). Means within 5 standard
    errors at an effective sample of a hundredth of the particles, sds
    within 5 relative ones; the host's simulator path must not run."""
    from pymc3_tpu_torch.examples.suite import (abc_data, abc_model,
                                                 abc_torch_simulator,
                                                 gp_regression)
    from pymc3_tpu_torch.smc import smc as smc_mod
    ref = _reference_fits("smc_gp")
    base = _baseline()["gp"]["moments"]
    names = ["ls", "eta", "sigma"]
    model = gp_regression(pm)[0]
    _on_card(model, "smc_gp")
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    with _LaunchShapes(gp_cov) as launched, _SMCCounts() as counts:
        torch.cuda.synchronize()
        t0 = time.time()
        trace = pm.sample_smc(draws=particles, model=model, random_seed=5)
        wall = time.time() - t0
    launches, shapes, steps = gp_cov.LAUNCHES, launched.forward, counts.steps
    backward = gp_cov.BACKWARD_LAUNCHES
    got = {"mean": {v: float(np.mean(trace[v], dtype=np.float64))
                    for v in names},
           "sd": {v: float(np.std(np.asarray(trace[v], np.float64)))
                  for v in names},
           "smc_error": {v: ref["mean"][v]["sd"] for v in names}}
    ref_base = {v: {"mean": base[v]["mean"][0], "sd": base[v]["sd"][0],
                    "mcse": base[v]["mcse"][0]} for v in names}
    gate = _smc_reference_gate(got, ref_base, names)
    lml = trace.report.log_marginal_likelihood
    lml_ref = ref["log_marginal_likelihood"]
    lml_z = abs(lml - lml_ref["mean"]) / (lml_ref["sd"] * np.sqrt(1.25))
    out = {"phase": "smc_gp", "particles": particles, "wall_s": wall,
           "stages": counts.stages, "mutation_steps": steps,
           "host_reads": counts.reads, "forward_launches": launches,
           "launch_shapes": sorted(set(shapes)),
           "log_marginal_likelihood": lml, "jax_evidence": lml_ref,
           "evidence_z": lml_z, "mean": got["mean"], "sd": got["sd"],
           "gate": gate, "card": card}
    print(json.dumps(out), flush=True)
    if launches != steps + 1 or set(shapes) != {SMC_SHAPE}:
        fail(f"smc_gp: {launches} forward launches at {set(shapes)} for "
             f"{steps} mutation steps, expected one each at {SMC_SHAPE} "
             "and one for the first evaluation")
    if backward != 0:
        fail(f"smc_gp: {backward} backward launches; SMC's likelihood "
             "takes no gradient")
    if not gate["pass"]:
        fail("smc_gp posterior moments disagree with BASELINE_CPU.json")
    if not lml_z < 4.0:
        fail(f"smc_gp evidence {lml:.4f} is {lml_z:.2f} sds from the JAX "
             "runs'")

    data = abc_data().astype(np.float64)
    host_calls = smc_mod.HOST_SIMULATOR_CALLS
    model = abc_model(pm, abc_torch_simulator)
    _on_card(model, "smc_abc")
    t0 = time.time()
    trace = pm.sample_smc(draws=abc_particles, kernel="abc", epsilon=0.5,
                          model=model, random_seed=4)
    torch.cuda.synchronize()
    wall = time.time() - t0
    eff = abc_particles / 100.0
    prec = 1 / 0.5 ** 2 + 1 / 5.0 ** 2
    want = {"a": (data.mean() * 4.0 / prec, 1.0 / np.sqrt(prec)),
            "b": (2.0 * np.sqrt(2.0 / np.pi), 2.0 * np.sqrt(1 - 2 / np.pi))}
    abc_out = {"phase": "smc_abc", "particles": abc_particles,
               "wall_s": wall, "card": card}
    ok = smc_mod.HOST_SIMULATOR_CALLS == host_calls
    for v, (m, sd) in want.items():
        x = np.asarray(trace[v], np.float64)
        z_mean = abs(x.mean() - m) / (sd / np.sqrt(eff))
        z_sd = abs(x.std() / sd - 1.0) * np.sqrt(2.0 * eff)
        abc_out[v] = {"mean": x.mean(), "sd": x.std(), "want": [m, sd],
                      "z_mean": z_mean, "z_sd": z_sd}
        ok = ok and z_mean < 5.0 and z_sd < 5.0
    print(json.dumps(abc_out), flush=True)
    if not ok:
        fail("smc_abc disagrees with its pseudo-posterior, or the host's "
             "simulator path ran")
    return launches


def _logp_grad_on(pm, gp_cov, build, points, device, exact=False):
    """logp and gradient of the model ``build`` makes on ``device`` at the
    rows of ``points`` as float64 numpy, the host ms of one call on the
    card, and the kernel launches of the first call. ``exact`` builds the
    model in float64 (on the CPU) with float32's jitter: the float32 runs'
    truth."""
    from pymc3_tpu_torch.gp import util as gp_util
    prev = pm.get_config().device, pm.get_config().floatX
    jitter = gp_util._default_jitter
    pm.set_config(device=device, floatX="float64" if exact else prev[1])
    if exact:
        gp_util._default_jitter = lambda: 5e-4
    try:
        model = build()
        q = torch.as_tensor(points, device=model.device,
                            dtype=torch.float64 if exact else None)
        vag = model.logp_dlogp_function()
        with _LaunchShapes(gp_cov) as shapes:
            logp, grad = vag(q)
    finally:
        pm.set_config(device=prev[0], floatX=prev[1])
        gp_util._default_jitter = jitter
    ms = _synced_ms(lambda: vag(q), calls=10) if device == "cuda" else None
    return (logp.double().cpu().numpy(), grad.double().cpu().numpy(), ms,
            shapes)


def phase_gp_sparse(pm, gp_cov, card, particles=4096, chains=64,
                    seeds=(6, 7, 8, 9, 10, 11)):
    """FITC at the published width of PyMC3's sparse-approximation notebook
    (``examples/suite.py::sparse_fitc_model``: 2,000 inputs, Matern52, 20
    inducing points by k-means), sampled by ``sample_smc`` at 4,096
    particles, once for each of six seeds. NUTS does not fit the script's
    time: the posterior's ridge between ``ls`` and ``eta`` needs trees of
    depth 5-7 even with a dense mass matrix (the deepest of 8 lanes at 6
    on the CPU), about 0.5 s an iteration at 64 chains, and with the depth
    capped at 4 split R-hat was 1.13-1.19 after 100 + 100. Each SMC step
    evaluates the likelihood of all particles in one ``vmap``: one forward
    launch at (4096, 20, 20, 1) for ``Kuu`` and one at (4096, 20, 2000, 1)
    for ``Kuf``, both asserted.

    Gate: ``ls``, ``eta`` and ``sigma`` against the JAX package's NUTS on
    the same model written with the covariances computed from the random
    hyperparameters (``tests/torch_reference.py sparse_fitc``; the JAX
    package's own ``MarginalSparse`` freezes them). The mean of the six
    runs' means within z_max times sqrt(s^2 / 6 + mcse_ref^2), s the sd of
    the six means (SMC's own Monte-Carlo error, measured), and z_max the
    99.95% point of Student's t with 5 degrees of freedom (6.87), since s
    is estimated from six runs; the sd of all the runs' particles within
    20% (``moment_check``'s limit).

    Then, on the card against the same functions on the CPU, logp and
    gradient at 64 points (the test point moved by seeded noise) of the
    FITC model, through both kernels at (64, 20, 20, 1) and
    (64, 20, 2000, 1) (asserted), of the latent-GP notebook's model (n =
    200, Matern52, StudentT likelihood), of the same with a ``TP`` prior,
    and of ``MarginalKron`` on a 50 x 30 grid. Both float32 results are
    held against the float64 truth (the same model built in float64 on the
    CPU, float32's jitter kept): the card's largest error, relative to the
    largest logp and to the largest gradient entry, within 4 times the
    CPU's plus 1e-6. The error is float32 rounding amplified by the
    factors' condition numbers (about 1e6 for the latent GP's 200 x 200
    covariance at its jitter, where a gradient through the Cholesky carries
    it in full), and the card and the CPU round differently, so neither
    can hold the other to float32 tolerance.
    ``MarginalKron`` with no jitter also against the dense ``Marginal`` on
    the 1,500-point grid, on the card (rtol 1e-4 on logp: the
    eigendecompositions of 50 x 50 and 30 x 30 factors against one 1,500 x
    1,500 Cholesky). Finally 10,000 prior draws of a ``Latent`` f at the
    notebook's 200 inputs (ls = 1, eta = 3): every entry of their second
    moment within 6 standard errors of K, sqrt((K_ii K_jj + K_ij^2) / N)
    (6: over the 20,100 distinct entries P(|z| > 6) = 2e-9 each)."""
    from scipy import stats

    from pymc3_tpu_torch.examples import suite
    from pymc3_tpu_torch.gp import util as gp_util
    model, names, _ = suite.sparse_fitc_model(pm)
    _on_card(model, "gp_sparse")
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    runs = []
    with _LaunchShapes(gp_cov) as shapes, _SMCCounts() as counts:
        for seed in seeds:
            t0 = time.time()
            trace = pm.sample_smc(draws=particles, model=model,
                                  random_seed=seed)
            runs.append({"wall_s": time.time() - t0,
                         "log_marginal_likelihood":
                             trace.report.log_marginal_likelihood,
                         **{v: np.asarray(trace[v], np.float64)
                            for v in names}})
    launches = {"forward": gp_cov.LAUNCHES,
                "backward": gp_cov.BACKWARD_LAUNCHES}
    k = len(seeds)
    means = {v: np.array([r[v].mean() for r in runs]) for v in names}
    pooled = {v: np.concatenate([r[v] for r in runs]) for v in names}
    spread = {v: float(means[v].std(ddof=1)) for v in names}
    got = {"mean": {v: float(pooled[v].mean()) for v in names},
           "sd": {v: float(pooled[v].std()) for v in names},
           "smc_error": {v: spread[v] / np.sqrt(k) for v in names}}
    ref = {v: {key: m[key][0] for key in ("mean", "sd", "mcse")}
           for v, m in _reference("sparse_fitc").items()}
    z_max = float(stats.t.ppf(0.9995, k - 1))
    gate = _smc_reference_gate(got, ref, names, z_max=z_max)
    uu, uf = (particles, 20, 20, 1), (particles, 20, 2000, 1)
    evidence = [r["log_marginal_likelihood"] for r in runs]
    out = {"phase": "gp_sparse", "particles": particles, "seeds": list(seeds),
           "wall_s": [r["wall_s"] for r in runs], "stages": counts.stages,
           "mutation_steps": counts.steps, "host_reads": counts.reads,
           "launches": launches,
           "launch_shapes": sorted(set(shapes.forward)),
           "log_marginal_likelihood": evidence,
           "run_means": {v: means[v].tolist() for v in names},
           "spread_of_means": spread,
           # the error one run's mean would have at an effective sample of
           # a hundredth of its particles, for comparison with the spread
           "sd_over_sqrt_n_over_100": {
               v: float(np.mean([r[v].std() for r in runs])
                        / np.sqrt(particles / 100.0)) for v in names},
           "mean": got["mean"], "sd": got["sd"], "reference": ref,
           "gate": gate, "z_max": z_max, "card": card}
    print(json.dumps(out), flush=True)
    if sorted(shapes.forward) != sorted([uu, uf] * (counts.steps + k)) or \
            launches != {"forward": 2 * (counts.steps + k), "backward": 0}:
        fail(f"gp_sparse: launches {launches} at {set(shapes.forward)} for "
             f"{counts.steps} steps of {k} runs, expected {uu} and {uf} "
             "once a step and once for each run's first evaluation")
    if not gate["pass"]:
        fail("gp_sparse FITC posterior disagrees with the JAX reference "
             "run")
    del trace, model, runs, pooled

    rng = np.random.RandomState(17)
    checks = {}
    builders = {
        "fitc": lambda: suite.sparse_fitc_model(pm)[0],
        "latent": lambda: suite.latent_model(pm),
        "tp": lambda: suite.latent_model(pm, "tp"),
        "marginal_kron": lambda: suite.kron_model(pm)}
    fitc_launches = None
    for label, build in builders.items():
        pm.set_config(device="cpu")
        try:
            probe = build()
        finally:
            pm.set_config(device="cuda")
        q0 = probe.dict_to_array(probe.test_point)
        q = (q0[None] + 0.2 * rng.randn(chains, q0.size)).astype(np.float32)
        lc, gc, ms, shapes = _logp_grad_on(pm, gp_cov, build, q, "cuda")
        lh, gh, _, _ = _logp_grad_on(pm, gp_cov, build, q, "cpu")
        lt, gt, _, _ = _logp_grad_on(pm, gp_cov, build, q, "cpu",
                                     exact=True)
        lscale = max(1.0, float(np.abs(lt).max()))
        gscale = max(1.0, float(np.abs(gt).max()))
        err = {where: [float(np.max(np.abs(lv - lt))) / lscale,
                       float(np.max(np.abs(gv - gt))) / gscale]
               for where, lv, gv in (("card", lc, gc), ("cpu", lh, gh))}
        checks[label] = {"logp_grad_ms": ms,
                         "rel_err_logp_grad": err,
                         "forward_shapes": shapes.forward,
                         "backward_shapes": shapes.backward}
        if not (np.all(np.isfinite(lc)) and all(
                c <= 4.0 * h + 1e-6 for c, h in zip(err["card"],
                                                    err["cpu"]))):
            fail(f"gp_sparse {label}: the card's logp+grad is further from "
                 f"the float64 truth than 4x the CPU's ({err})")
        if label == "fitc":
            want = sorted([(chains, 20, 20, 1), FITC_SHAPE])
            if sorted(shapes.forward) != want or \
                    sorted(shapes.backward) != want:
                fail(f"gp_sparse: FITC logp+grad launched {shapes.forward} "
                     f"and {shapes.backward}, expected {want} each way")
            fitc_launches = {"forward": len(shapes.forward),
                             "backward": len(shapes.backward)}
        if label == "marginal_kron":
            jitter = gp_util._default_jitter
            gp_util._default_jitter = lambda: 0.0
            try:
                lk = _logp_grad_on(pm, gp_cov, build, q[:8], "cuda")[0]
                ld, _, ms_d, _ = _logp_grad_on(
                    pm, gp_cov, lambda: suite.kron_model(pm, dense=True),
                    q[:8], "cuda")
            finally:
                gp_util._default_jitter = jitter
            rel = float(np.max(np.abs(lk - ld) / np.abs(ld)))
            checks[label].update(dense_rel=rel, dense_logp_grad_ms=ms_d)
            if not rel < 1e-4:
                fail(f"gp_sparse: MarginalKron off the dense Marginal by "
                     f"{rel:.2e} relative")
        print(f"gp_sparse {label}: " + json.dumps(checks[label]), flush=True)

    X, _ = suite.latent_data()
    n = 10_000
    with pm.Model() as model:
        gp = pm.gp.Latent(cov_func=3.0 ** 2 * pm.gp.cov.Matern52(1, 1.0))
        gp.prior("f", X=X)
    _on_card(model, "latent prior")
    t0 = time.time()
    draws_f = pm.sample_prior_predictive(samples=n, model=model,
                                         var_names=["f"],
                                         random_seed=3)["f"]
    pwall = time.time() - t0
    K = pm.node.evaluate(gp_util.stabilize(gp.cov_func(X)), {})
    K = K.double().cpu().numpy()
    f = draws_f.astype(np.float64)
    S = f.T @ f / n
    se = np.sqrt((np.outer(np.diag(K), np.diag(K)) + K ** 2) / n)
    z = float(np.max(np.abs(S - K) / se))
    checks["prior_draws"] = {"draws": list(f.shape), "wall_s": pwall,
                             "max_z": z}
    print("gp_sparse prior draws: " + json.dumps(checks["prior_draws"]),
          flush=True)
    if f.shape != (n, len(X)) or not z < 6.0:
        fail(f"gp_sparse: prior draws of f off K (max z {z:.2f})")
    print(json.dumps({"phase": "gp_sparse_checks", **checks, "card": card}),
          flush=True)
    return {"smc": launches, "logp_grad": fitc_launches}

def _ode_counts():
    from pymc3_tpu_torch.ode import ode as ode_mod
    return ode_mod.ITERATIONS, ode_mod.SOLVES


def _reset_ode_counts():
    from pymc3_tpu_torch.ode import ode as ode_mod
    ode_mod.ITERATIONS = ode_mod.SOLVES = 0


def _card_vs_cpu(pm, gp_cov, build, q, label):
    """logp and gradient of ``build()`` at the rows of ``q`` on the card,
    on the CPU in float32 and on the CPU in float64 (the truth): the
    card's largest error, relative to the largest logp and the largest
    gradient entry, must be within 4 times the CPU's plus 1e-6 (phase
    22's yardstick: the two float32 runs round differently, so neither can
    hold the other to float32 tolerance). Returns the card's ms per
    call and both errors."""
    lc, gc, ms, _ = _logp_grad_on(pm, gp_cov, build, q, "cuda")
    lh, gh, _, _ = _logp_grad_on(pm, gp_cov, build, q, "cpu")
    lt, gt, _, _ = _logp_grad_on(pm, gp_cov, build, q, "cpu", exact=True)
    lscale = max(1.0, float(np.abs(lt).max()))
    gscale = max(1.0, float(np.abs(gt).max()))
    err = {where: [float(np.max(np.abs(lv - lt))) / lscale,
                   float(np.max(np.abs(gv - gt))) / gscale]
           for where, lv, gv in (("card", lc, gc), ("cpu", lh, gh))}
    if not (np.all(np.isfinite(lc)) and np.all(np.isfinite(gc)) and all(
            c <= 4.0 * h + 1e-6 for c, h in zip(err["card"], err["cpu"]))):
        fail(f"{label}: the card's logp+grad is further from the float64 "
             f"truth than 4x the CPU's ({err})")
    return {"logp_grad_ms": ms, "rel_err_logp_grad": err}


def _ode_graphs_check(model, ode, chains=64, label="ode"):
    """logp+grad of ``model`` at ``chains`` points near the test point
    through the CUDA graphs of the solve and eagerly: the same numbers (bit
    for bit in float32; in float64 within rtol 1e-12 and atol 1e-12 x the
    largest value, and whether bit for bit is printed), the forward and
    backward graphs of ``chains`` lanes in the model's float type captured
    (counted; a capture that fails raises), and each path's host ms per
    synced call."""
    from pymc3_tpu_torch.ode import graphs
    rng = np.random.RandomState(23)
    q0 = model.dict_to_array(model.test_point)
    q = torch.as_tensor((q0[None] + 0.1 * rng.randn(chains, q0.size))
                        .astype(q0.dtype), device=model.device)
    vag = model.logp_dlogp_function()
    res, ms = {}, {}
    for enabled in (False, True):
        graphs.ENABLED = enabled
        ms[enabled] = _synced_ms(lambda: vag(q), calls=10, warmup=2)
        res[enabled] = [x.cpu().numpy() for x in vag(q)]
    captures = {kind: sum(1 for key in cache
                          if key[1][0] == chains and q.dtype in key)
                for kind, cache in (("forward", ode._graphs.forward),
                                    ("backward", ode._graphs.backward))}
    used = min(captures.values()) > 0
    bitwise = all(np.array_equal(a, b)
                  for a, b in zip(res[False], res[True]))
    same = bitwise if q.dtype == torch.float32 else all(
        np.allclose(b, a, rtol=1e-12, atol=1e-12 * np.abs(a).max())
        for a, b in zip(res[False], res[True]))
    out = {"chains": chains, "dtype": str(q.dtype), "eager_ms": ms[False],
           "graphs_ms": ms[True], "captured": used, "captures": captures,
           "same_numbers": same, "bitwise_equal": bitwise}
    print(f"{label} graphs: " + json.dumps(out), flush=True)
    if not (used and same):
        fail(f"{label}: the solve's CUDA graphs were not captured or do not "
             "give the eager path's numbers")
    return out


def phase_ode(pm, gp_cov, card, draws=150, tune=150, chains=64, window=40):
    """The bench suite's freefall ODE (``examples/suite.py::ode_model``: 1
    state, 2 parameters, 20 outputs from t0 = times[0]) sampled by NUTS on
    the card through the adaptive DOPRI5 solve, tune 150 + draws 150 (the
    reference ran 2 chains of 1000 + 500: chains run batched, so this
    phase takes 64 chains and cuts tune and draws). The chains start at
    jittered test points (``init="jitter+adapt_diag"``'s) and adapt a
    diagonal mass matrix pooled over the chains,
    ``QuadPotentialDiagAdapt(adaptation_window=40)``: the estimate is
    promoted at 25 draws (64 x 25 pooled draws clear 1,024), 40, 80 and
    120, so the draws run on the variances of draws 81-150. With the
    default window of 101 the last estimate took in draws 26-150, the
    burn-in with them: mean depth 2.63 and every draw's deepest lane at 3
    on the card, against 1.87 and 2.36-2.41 with a window of 40 on the
    CPU (two seeds, R-hat 1.0048-1.0086), a fifth less wall.

    Gate: ``sigma`` and ``gamma`` against ``BASELINE_CPU.json`` ``ode``
    (the JAX package at the reference's config: gamma 0.40036 +- 0.00687)
    by ``moment_check``, split R-hat < 1.01. Printed: the calibrated
    ``max_steps``, host ms per synced logp+grad at 2, 16 and 256 chains
    with the loop iterations per solve, the same at 64 chains through the
    solve's CUDA graphs and eagerly (the same numbers, asserted), and the
    iterations per solve of the whole run. Then the posterior predictive of
    ``Y`` at every draw: shape, finiteness, and each time's predictive mean
    within 4 sigma of the observation, the residuals' sd within 50% of the
    posterior mean of sigma. Then the SIR model of PyMC3's ODE notebook
    (``examples/suite.py::sir_model``: 2 states, 2 parameters, 19 times)
    at 64 points: logp+grad on the card against the CPU in float32 and
    float64 (:func:`_card_vs_cpu`)."""
    from pymc3_tpu_torch.examples import suite
    ode = suite.freefall_ode(pm)
    model, names = suite.ode_model(pm, ode)
    _on_card(model, "ode")
    out = {"phase": "ode", "chains": chains, "tune": tune, "draws": draws,
           "max_steps": ode.max_steps, "card": card}
    timed = {}
    for n in (2, 16, 256):
        _reset_ode_counts()
        ms = _logp_grad_ms(model, n, calls=20)
        it, solves = _ode_counts()
        timed[n] = {"logp_grad_ms": ms, "iterations_per_solve":
                    it / max(solves, 1)}
    out["logp_grad"] = timed
    print("ode logp+grad: " + json.dumps(timed) + f", max_steps "
          f"{ode.max_steps}", flush=True)
    out["graphs"] = _ode_graphs_check(model, ode)
    ref = _baseline()["ode"]["moments"]
    from pymc3_tpu_torch.step_methods.hmc import QuadPotentialDiagAdapt
    _reset_ode_counts()
    t0 = time.time()
    start, _ = pm.init_nuts(init="jitter+adapt_diag", chains=chains,
                            model=model, random_seed=2)
    q = np.stack([model.dict_to_array(p) for p in start])
    step = pm.NUTS(potential=QuadPotentialDiagAdapt(
        q.shape[1], q.mean(axis=0), np.ones(q.shape[1]), 10,
        adaptation_window=window), model=model, axis_name="chains_local")
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      step=step, start=start, progressbar=False,
                      random_seed=2, axis_name="chains_local",
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    it, solves = _ode_counts()
    out["sample"] = _gate(pm, trace, names, ref, wall,
                          f"ode chains={chains} tune={tune} draws={draws}")
    out["sample"].update(solves=solves, iterations_per_solve=it / solves)
    print(f"ode sample: {solves} solves, {it / solves:.2f} loop iterations "
          f"a solve against max_steps {ode.max_steps}", flush=True)

    t0 = time.time()
    ppc = pm.sample_posterior_predictive(trace, model=model,
                                         random_seed=3)["Y"]
    pwall = time.time() - t0
    y = suite.ode_model_data()
    sig = float(np.mean(trace["sigma"]))
    resid = y - ppc.reshape(ppc.shape[0], -1).mean(axis=0)
    out["predictive"] = {"draws": list(ppc.shape), "wall_s": pwall,
                         "max_abs_resid": float(np.abs(resid).max()),
                         "resid_sd": float(resid.std()), "sigma": sig}
    print("ode predictive: " + json.dumps(out["predictive"]), flush=True)
    if ppc.shape != (chains * draws, 20, 1) or not np.isfinite(ppc).all():
        fail(f"ode predictive draws of shape {ppc.shape}, or not finite")
    if not (np.abs(resid).max() < 4 * sig
            and 0.5 * sig < resid.std() < 1.5 * sig):
        fail("ode predictive means disagree with the data")
    del trace

    rng = np.random.RandomState(19)
    pm.set_config(device="cpu")
    try:
        probe = suite.sir_model(pm)
    finally:
        pm.set_config(device="cuda")
    q0 = probe.dict_to_array(probe.test_point)
    q = (q0[None] + 0.2 * rng.randn(64, q0.size)).astype(np.float32)
    _reset_ode_counts()
    out["sir"] = _card_vs_cpu(pm, gp_cov, lambda: suite.sir_model(pm), q,
                              "ode SIR")
    print("ode SIR logp+grad at 64 points: " + json.dumps(out["sir"]),
          flush=True)
    print(json.dumps(out), flush=True)
    return out


def _rhat_np(x):
    """Split R-hat in float64 numpy, the plain formula of
    ``stats/device.py``."""
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]])
    n = x.shape[1]
    within = x.var(axis=1, ddof=1).mean(axis=0)
    between = n * x.mean(axis=1).var(axis=0, ddof=1)
    return np.sqrt(((n - 1) / n * within + between / n) / within)


def _ess_np(x):
    """Bulk ESS in float64 numpy, the plain formula of
    ``stats/device.py``: Geyer's pairs of lags, kept while positive, made
    monotone by a running minimum."""
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]])
    m, n, _ = x.shape
    mpad = 2 ** int(np.ceil(np.log2(2 * n)))
    c = x - x.mean(axis=1, keepdims=True)
    f = np.fft.rfft(c, mpad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), mpad, axis=1)[:, :n] / n
    mean_var = acov[:, 0].mean(axis=0) * n / (n - 1)
    var_plus = mean_var * (n - 1) / n + x.mean(axis=1).var(axis=0, ddof=1)
    rho = 1 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    pair = rho[:2 * (n // 2)].reshape(n // 2, 2, -1).sum(axis=1)
    keep = np.cumprod(pair > 0, axis=0).astype(bool)
    pair = np.where(keep, np.minimum.accumulate(
        np.where(keep, pair, np.inf), axis=0), 0.0)
    return m * n / np.maximum(-1 + 2 * pair.sum(axis=0), 1.0)


def _split_loo(pm, trace, model, chains):
    """LOO of the first and of the second half of the chains: their
    difference measures the Monte-Carlo error of the whole run's LOO."""
    halves = []
    for part in (trace.chains[:chains // 2], trace.chains[chains // 2:]):
        sub = _ChainView(trace, part)
        halves.append(float(pm.loo(sub, model).loo))
    return halves


class _ChainView:
    """Some chains of a trace, with what ``loo`` reads of a MultiTrace."""

    def __init__(self, trace, chains):
        self._trace, self.chains = trace, list(chains)
        self.nchains = len(self.chains)
        self.varnames = trace.varnames

    def get_values(self, name, chains=None, combine=True, squeeze=True):
        return self._trace.get_values(
            name, chains=self.chains if chains is None else chains,
            combine=combine, squeeze=squeeze)


def phase_glm(pm, gp_cov, card, draws=150, tune=(100, 150), chains=256,
              window=20):
    """The radon GLMs of ``examples/suite.py``: ``GLM.from_formula(
    "log_radon ~ floor", radon)`` (3 free values) and ``"log_radon ~ floor +
    C(county)"`` (86 coefficients and ``sd`` over 919 rows, radon read
    without pandas), each sampled by NUTS on the card at 256 chains, tune
    100 (pooled) and 150 (unpooled) + draws 150 (the reference ran 8
    chains of 1000 + 2000 per seed). Both start at jittered test points
    and adapt their own mass matrix, pooled over the chains. The pooled
    model adapts a diagonal one (``init="jitter+adapt_diag"``). The
    unpooled model's flat intercept is the baseline county's (4 homes) and
    every county coefficient is a difference from it: with a diagonal mass
    matrix the JAX package's trees averaged depth 4.8 and split R-hat of
    the intercept stayed at 1.024 and 1.047 after 1000 + 2000, so its
    reference runs adapt a dense one (``jitter+adapt_full``). Here it does
    too, through ``QuadPotentialFullAdapt(adaptation_window=20)``: with the
    default window of 101 every one of the first 101 tuning draws built a
    tree at the depth cap on the identity (441.7 s for tune 150 + draws
    150); 256 chains pool 5,120 draws in 20, and the doubling windows
    promote estimates at 20, 60 and 140 draws, so the last tuning draws
    and all draws run on the covariance of draws 61-150. (On the CPU,
    three seeds: depth 3.00, R-hat 1.0074-1.0079; with a window of 25 and
    tune 125 the last estimate took in draws 26-75, still burning in:
    depth 3.94 and R-hat 1.0117.)

    Gates: ``Intercept``, ``floor`` and ``sd`` of each model against the
    JAX package's NUTS runs (``tests/torch_reference.py glm_radon``, two
    seeds pooled) by ``moment_check``, R-hat < 1.01. Then ``loo`` and
    ``waic`` of both models on the card, and:

    - the pointwise log-likelihood matrix of each, at the draws of its
      first 16 chains, against the same draws' on the CPU in float32 and
      in float64 (relative error within 4 times the CPU's plus 1e-6, as
      :func:`_card_vs_cpu`);
    - the unpooled model ranks first by LOO, as in both reference runs;
    - d_loo = LOO(unpooled) - LOO(pooled) (deviance) within 5 noise sds of
      the two reference runs' mean. One run's noise s is estimated from the
      two runs, s^2 = (d1 - d2)^2 / 2, or from this run's halves (the first
      and the last 128 chains: s^2 = (dA - dB)^2 / 4 for the whole run)
      where that is larger; the limit is 5 sqrt(s_ref^2 / 2 + s_run^2),
      with s_ref the larger of the two, since this run and the mean of two
      reference runs each carry their own Monte-Carlo error, as
      ``_fit_gate`` reads two ADVI fits.

    Finally ``rhat_device`` / ``ess_device`` on the unpooled trace's 87
    free values at once, against float64 numpy of the same plain formulas
    (relative error 1e-6), timed beside the host's rank-normalised
    ``pm.rhat`` / ``pm.ess``; their ratio is printed, not gated."""
    from pymc3_tpu_torch.examples import suite
    with open(os.path.join(ROOT, "pymc3_tpu_torch", "examples",
                           "reference_moments.json")) as f:
        ref = json.load(f)["configs"]["glm_radon"]
    out = {"phase": "glm", "chains": chains, "tune": tune, "draws": draws,
           "card": card}
    from pymc3_tpu_torch.step_methods.hmc import QuadPotentialFullAdapt
    traces, models = {}, {}
    for label, build, n_tune in (("pooled", suite.glm_radon_pooled, tune[0]),
                                 ("unpooled", suite.glm_radon_unpooled,
                                  tune[1])):
        model, names = build(pm)
        _on_card(model, f"glm {label}")
        keep = [rv.name for rv in model.free_RVs] + names
        t0 = time.time()
        start, step = None, None
        if label == "unpooled":
            start, _ = pm.init_nuts(init="jitter+adapt_full", chains=chains,
                                    model=model, random_seed=3)
            q = np.stack([model.dict_to_array(p) for p in start])
            step = pm.NUTS(potential=QuadPotentialFullAdapt(
                q.shape[1], q.mean(axis=0), adaptation_window=window),
                model=model, axis_name="chains_local")
        trace = pm.sample(draws=draws, tune=n_tune, chains=chains,
                          model=model, step=step, start=start,
                          init="jitter+adapt_diag", progressbar=False,
                          random_seed=2, axis_name="chains_local",
                          trace=list(dict.fromkeys(keep)),
                          compute_convergence_checks=False)
        torch.cuda.synchronize()
        wall = time.time() - t0
        out[label] = _gate(pm, trace, names, ref[label]["moments"], wall,
                           f"glm {label} chains={chains} tune={n_tune} "
                           f"draws={draws}",
                           against="the JAX package's reference runs")
        out[label]["logp_grad_ms"] = _logp_grad_ms(model, chains)
        traces[label], models[label] = trace, model

    from pymc3_tpu_torch import stats as tstats
    ic = {}
    for label, build in (("pooled", suite.glm_radon_pooled),
                         ("unpooled", suite.glm_radon_unpooled)):
        trace, model = traces[label], models[label]
        t0 = time.time()
        lo = pm.loo(trace, model)
        wa = pm.waic(trace, model)
        ic_wall = time.time() - t0
        halves = _split_loo(pm, trace, model, chains)
        first = _ChainView(trace, trace.chains[:16])
        lls = {}
        for device, exact in (("cuda", False), ("cpu", False),
                              ("cpu", True)):
            prev = pm.get_config().device, pm.get_config().floatX
            pm.set_config(device=device,
                          floatX="float64" if exact else prev[1])
            try:
                lls[(device, exact)] = np.asarray(
                    tstats._log_likelihood_matrix(first, build(pm)[0]),
                    np.float64)
            finally:
                pm.set_config(device=prev[0], floatX=prev[1])
        truth = lls[("cpu", True)]
        scale = max(1.0, float(np.abs(truth).max()))
        err = {"card": float(np.abs(lls[("cuda", False)] - truth).max())
               / scale,
               "cpu": float(np.abs(lls[("cpu", False)] - truth).max())
               / scale}
        ic[label] = {"loo": float(lo.loo), "loo_se": float(lo.loo_se),
                     "p_loo": float(lo.p_loo), "shape_warn": lo.shape_warn,
                     "waic": float(wa.waic), "waic_se": float(wa.waic_se),
                     "p_waic": float(wa.p_waic), "wall_s": ic_wall,
                     "loo_halves": halves, "ll_shape": list(truth.shape),
                     "ll_rel_err": err}
        print(f"glm {label} loo/waic: " + json.dumps(ic[label]), flush=True)
        if not (np.isfinite(lo.loo) and np.isfinite(wa.waic)):
            fail(f"glm {label}: LOO or WAIC is not finite")
        if not err["card"] <= 4.0 * err["cpu"] + 1e-6:
            fail(f"glm {label}: the card's pointwise log likelihood is "
                 f"further from float64 than 4x the CPU's ({err})")
    d = ic["unpooled"]["loo"] - ic["pooled"]["loo"]
    d_ref = np.asarray(ref["d_loo"], np.float64)
    s_ref = float(abs(d_ref[0] - d_ref[1]) / np.sqrt(2.0))
    halves_d = np.subtract(ic["unpooled"]["loo_halves"],
                           ic["pooled"]["loo_halves"])
    s_run = float(abs(halves_d[0] - halves_d[1]) / 2.0)
    s = max(s_ref, s_run)
    limit = 5.0 * np.sqrt(s ** 2 / 2.0 + s_run ** 2)
    out["ic"] = ic
    out["d_loo"] = {"card": d, "reference": d_ref.tolist(),
                    "s_ref": s_ref, "s_run": s_run, "limit": limit}
    print("glm d_loo: " + json.dumps(out["d_loo"]), flush=True)
    if not (d < 0 and np.all(d_ref < 0)):
        fail(f"glm: the unpooled model does not rank first by LOO "
             f"(d_loo {d:.3f}, reference {d_ref.tolist()})")
    if not abs(d - d_ref.mean()) <= limit:
        fail(f"glm: d_loo {d:.3f} is {abs(d - d_ref.mean()):.3f} from the "
             f"reference's {d_ref.mean():.3f}, beyond {limit:.3f}")

    trace, model = traces["unpooled"], models["unpooled"]
    free = [rv.name for rv in model.free_RVs]
    x = np.concatenate([np.stack(trace.get_values(
        v, combine=False, squeeze=False)).reshape(chains, draws, -1)
        for v in free], axis=2)
    xd = torch.as_tensor(x, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    r_dev, e_dev = pm.rhat_device(xd), pm.ess_device(xd)
    dev_wall = time.time() - t0
    t0 = time.time()
    r_host, e_host = pm.rhat(trace, var_names=free), pm.ess(
        trace, var_names=free)
    host_wall = time.time() - t0
    x64 = x.astype(np.float64)
    r_np, e_np = _rhat_np(x64), _ess_np(x64)
    rel = {"rhat": float(np.max(np.abs(r_dev - r_np) / np.abs(r_np))),
           "ess": float(np.max(np.abs(e_dev - e_np) / np.abs(e_np)))}
    r_rank = np.concatenate([np.ravel(r_host[v]) for v in free])
    e_rank = np.concatenate([np.ravel(e_host[v]) for v in free])
    out["device_diagnostics"] = {
        "values": x.shape[2], "device_wall_s": dev_wall,
        "host_wall_s": host_wall, "rel_err_to_float64": rel,
        "rhat_over_rank_normalised": [float(np.min(r_dev / r_rank)),
                                      float(np.max(r_dev / r_rank))],
        "ess_over_rank_normalised": [float(np.min(e_dev / e_rank)),
                                     float(np.max(e_dev / e_rank))]}
    print("glm device diagnostics: " + json.dumps(out["device_diagnostics"]),
          flush=True)
    if not (rel["rhat"] <= 1e-6 and rel["ess"] <= 1e-6):
        fail(f"glm: rhat_device/ess_device off float64 numpy ({rel})")
    print(json.dumps(out), flush=True)
    return out


# examples of phase 25, in the order of ``tests/test_examples.py``'s port
EXAMPLES = ("gelman_schools", "gelman_bioassay", "baseball",
            "lightspeed_example", "factor_potential", "censored_data",
            "glm_hierarchical", "custom_dists", "arbitrary_stochastic",
            "rankdata_ordered", "arma_example", "samplers_mvnormal",
            "gp_example", "minibatch_advi_logistic", "lasso_missing")
# each example's wall in phase 25 (s; NVIDIA H100 80GB HBM3, 700.00 W,
# beside the other workers and phases 7-11), from which the workers'
# groups are made (:func:`_example_groups`)
EXAMPLE_WALLS = {
    "lasso_missing": 94.5, "glm_hierarchical": 42.8, "baseball": 38.3,
    "gp_example": 28.2, "arma_example": 26.4, "gelman_schools": 24.7,
    "rankdata_ordered": 23.1, "custom_dists": 14.2, "censored_data": 8.2,
    "lightspeed_example": 7.4, "samplers_mvnormal": 6.9,
    "minibatch_advi_logistic": 5.1, "arbitrary_stochastic": 3.2,
    "gelman_bioassay": 3.0, "factor_potential": 2.0}
EXAMPLE_WORKERS = 3
# tune, draws and sample() arguments of each example where they differ
# from phase 25's defaults (see phase_examples)
EXAMPLE_RUNS = {
    "lasso_missing": {"dense_window": 16, "tune": 80, "draws": 30},
    "custom_dists": {"start": "least_squares",
                     "nuts": {"max_treedepth": 6}},
    "arma_example": {"init": "adapt_diag"},
    "glm_hierarchical": {"nuts": {"max_treedepth": 5}},
}


def _example_groups(workers=EXAMPLE_WORKERS):
    """Phase 25's examples cut into ``workers`` groups of about equal
    summed walls (``EXAMPLE_WALLS``): the longest first, each to the group
    with the least so far."""
    groups = [[] for _ in range(workers)]
    load = [0.0] * workers
    for name in sorted(EXAMPLES, key=lambda n: -EXAMPLE_WALLS[n]):
        i = load.index(min(load))
        groups[i].append(name)
        load[i] += EXAMPLE_WALLS[name]
    return [tuple(g) for g in groups]


def _example_closed_form(name, module):
    """The exact posterior of the two examples that have one, in the shape
    ``moment_check`` compares: ``factor_potential``'s N(1/3, 1/3) and
    ``samplers_mvnormal``'s N(0, cov)."""
    if name == "factor_potential":
        return ["x"], _exact_ref({"x": {"mean": 1.0 / 3.0,
                                        "sd": np.sqrt(1.0 / 3.0)}})
    cov = module.build_model()[1].astype(np.float64)
    return ["x"], _exact_ref({"x": {"mean": np.zeros(len(cov)),
                                    "sd": np.sqrt(np.diag(cov))}})


def _rhat_limits(moments, draws, names, tau_floor=2.0):
    """Split R-hat limit of each gated variable: ``1.01 + 2 (tau - 1) /
    draws``, ``tau`` the reference run's integrated autocorrelation time
    (its chains x draws over its ESS, the largest over the variable's
    elements), at least ``tau_floor`` (and that alone for a closed form).
    See :func:`phase_examples`."""
    limits = {}
    for v in names:
        m = moments[v]
        tau = tau_floor
        mcse = np.atleast_1d(np.asarray(m["mcse"], np.float64))
        if np.all(mcse > 0):
            sd = np.atleast_1d(np.asarray(m["sd"], np.float64))
            tau = max(tau, float(np.max(m["draws_total"] * (mcse / sd) ** 2)))
        limits[v] = 1.01 + 2.0 * (tau - 1.0) / draws
    return limits


def _run_example(pm, gp_cov, name, card, ref, chains=256, tune=100,
                 draws=50, devices=None):
    """One example of phase 25 on the card: its row of numbers, the list
    of its failed gates, and (for ``gp_example``) its kernel launches.
    ``devices`` goes to ``sample()`` (phase 27's one-rank NCCL run)."""
    import importlib
    from pymc3_tpu_torch.examples.suite import (EXAMPLE_ADVI, EXAMPLE_GATES,
                                                 example_model)
    module = importlib.import_module(f"pymc3_tpu_torch.examples.{name}")
    t0 = time.time()
    if name == "minibatch_advi_logistic":
        X, y, _ = module.make_data()
        model = module.build_model(X, y)
        _on_card(model, name)
        approx = pm.fit(n=EXAMPLE_ADVI["steps"], method="advi", model=model,
                        progressbar=False, random_seed=1,
                        obj_optimizer=pm.variational.updates.adam(
                            learning_rate=EXAMPLE_ADVI["learning_rate"]))
        torch.cuda.synchronize()
        wall = time.time() - t0
        gate = _fit_gate(approx.mean, approx.std, ref[name]["fits"])
        row = {"wall_s": wall, "steps": EXAMPLE_ADVI["steps"],
               "steps_per_s": EXAMPLE_ADVI["steps"] / wall, "gate": gate}
        print(f"examples {name}: " + json.dumps(row), flush=True)
        return row, ([] if gate["pass"] else [
            f"{name}: the fit is {gate['max_z']:.2f} noise sds from the JAX "
            "fits"]), None
    run = dict(EXAMPLE_RUNS.get(name, {}))
    tune, draws = run.get("tune", tune), run.get("draws", draws)
    if name in ("factor_potential", "samplers_mvnormal"):
        names, want = _example_closed_form(name, module)
        nuts, against = {}, "its closed form"
    else:
        names, nuts = EXAMPLE_GATES[name]
        want = ref[name]["moments"]
        against = "the JAX package's reference run"
        for v in names:
            want[v]["draws_total"] = ref[name]["chains"] * ref[name]["draws"]
    model = example_model(module)
    _on_card(model, name)
    nuts = dict(nuts, **run.get("nuts", {}))
    if run.get("dense_window"):
        from pymc3_tpu_torch.step_methods.hmc.quadpotential import (
            QuadPotentialFullAdapt)
        cont = [v for v in model.free_RVs if v not in model.missing_values]
        mean = np.concatenate([np.ravel(v.test_value) for v in cont])
        nuts.update(axis_name="chains_local",
                    potential=QuadPotentialFullAdapt(
                        len(mean), mean,
                        adaptation_window=run["dense_window"]))
    start = None
    if run.get("start") == "least_squares":
        slope, intercept = np.polyfit(module.xdata, module.ydata, 1)
        resid = module.ydata - (intercept + slope * module.xdata)
        start = {"intercept": np.float32(intercept),
                 "slope": np.float32(slope),
                 "sigma": np.float32(resid.std())}
    if name == "gp_example":
        gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    trace = pm.sample(draws=draws, tune=tune, chains=chains, model=model,
                      init=run.get("init", "auto"), start=start,
                      progressbar=False,
                      random_seed=2, axis_name="chains_local", trace=names,
                      compute_convergence_checks=False, nuts=nuts,
                      devices=devices)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = None
    failed = []
    if name == "gp_example":
        launches = {"forward": gp_cov.LAUNCHES,
                    "backward": gp_cov.BACKWARD_LAUNCHES}
        if min(launches.values()) == 0:
            failed.append(f"gp_example launched no kernel: {launches}")
    limits = _rhat_limits(want, draws, names)
    try:
        out = _gate(pm, trace, names, want, wall,
                    f"examples {name} chains={chains} tune={tune} "
                    f"draws={draws}", against=against, rhat_limit=limits)
    except SystemExit:
        for v in names:
            x = np.stack(trace.get_values(v, combine=False)).astype(
                np.float64)
            x = x.reshape(x.shape[0], x.shape[1], -1)
            far = np.abs(x.mean(1) - x.mean((0, 1))) / x.std((0, 1))
            worst = np.argsort(far.max(1))[-3:]
            print(f"examples {name} {v}: mean {x.mean((0, 1))}, sd "
                  f"{x.std((0, 1))}; chains {worst.tolist()} lie "
                  f"{far.max(1)[worst].round(2).tolist()} sds away",
                  flush=True)
        return {"wall_s": wall}, failed + [name], launches
    row = {k: out[k] for k in (
        "wall_s", "min_ess", "rhat", "divergences",
        "mean_tree_depth", "deepest_lane_depth", "moment_check")}
    row.update(tune=tune, draws=draws, rhat_limit=limits)
    return row, failed, launches


def _worker(args):
    """A worker process of phases 24-29 and 31: ``traces CARD`` (phases 26
    and 29), ``multirank CARD``, ``aevb CARD``, ``float64 CARD`` and ``glm
    CARD`` run phase 26, 27, 28, 31 or 24 and print a ``TRACES``,
    ``MULTIRANK``, ``AEVB``, ``FLOAT64`` or ``GLM`` JSON line at its end;
    otherwise it runs the examples ``args``, one ``EXAMPLE`` JSON line
    each. Exits 1 if anything failed."""
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch.ops import gp_cov
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    # a SIGTERM from the main process's exit handler unwinds this process,
    # so that parallel.launch stops phase 27's ranks
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    if args[0] == "traces":
        phase_plots(pm, args[1], *phase_traces(pm, args[1]))
        print("TRACES " + json.dumps({"finished_at": time.time(),
                                      "radon": RESULTS["radon"]}),
              flush=True)
        sys.exit(0)
    if args[0] == "float64":
        out = phase_float64(pm, gp_cov, args[1])
        print("FLOAT64 " + json.dumps(dict(out, finished_at=time.time())),
              flush=True)
        sys.exit(0)
    if args[0] == "multirank":
        launches = phase_multirank(pm, args[1])
        print("MULTIRANK " + json.dumps({"finished_at": time.time(),
                                         "launches": launches}), flush=True)
        sys.exit(0)
    if args[0] == "aevb":
        phase_aevb(pm, args[1])
        print("AEVB " + json.dumps({"finished_at": time.time()}),
              flush=True)
        sys.exit(0)
    if args[0] == "glm":
        out = phase_glm(pm, gp_cov, args[1])
        print("GLM " + json.dumps({"finished_at": time.time(),
                                   "pooled": out["pooled"]}), flush=True)
        sys.exit(0)
    ref = _reference_fits("examples")
    failed = []
    for name in args:
        row, bad, launches = _run_example(pm, gp_cov, name, "", ref)
        failed += bad
        print("EXAMPLE " + json.dumps({"name": name, "row": row,
                                       "failed": bad, "launches": launches,
                                       "finished_at": time.time()}),
              flush=True)
    sys.exit(1 if failed else 0)


_WORKER_CODE = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
                "chip_smoke._worker(sys.argv[1:])")


# (worker, its temporary directory) of every worker started, stopped at exit
_SPAWNED = []


def _stop_workers():
    """SIGTERM to every worker still running, then SIGKILL after 10 s."""
    for (proc, _, _, _), _ in _SPAWNED:
        if proc.poll() is None:
            proc.terminate()
    for (proc, out, err, _), tmp in _SPAWNED:
        try:
            proc.wait(timeout=10)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        out.close()
        err.close()
        shutil.rmtree(tmp, ignore_errors=True)


def _spawn(args, env=None):
    """Start one worker (:func:`_worker`) on ``args``; its output goes to
    files, not pipes (a full pipe would stall it), and it is stopped if the
    script ends first. Returns ``(process, out, err, args)``."""
    import atexit
    import tempfile
    if not _SPAWNED:
        atexit.register(_stop_workers)
    tmp = tempfile.mkdtemp()
    out = open(os.path.join(tmp, "out"), "w+")
    err = open(os.path.join(tmp, "err"), "w+")
    worker = (subprocess.Popen(
        [sys.executable, "-c", _WORKER_CODE, *args], cwd=ROOT, stdout=out,
        stderr=err, text=True, env=env), out, err, args)
    _SPAWNED.append((worker, tmp))
    return worker


def start_workers(card, traces=True):
    """Start phase 25's example workers and, with ``traces``, the workers
    of phases 26, 27 and 28; :func:`phase_examples` and
    :func:`read_worker_phase` read them. Returns ``(examples, {phase name:
    worker}, time started)``, each worker ``(process, out, err, args)``."""
    started_at = time.time()
    examples = [_spawn(group) for group in _example_groups()]
    named = ("traces", "multirank", "aevb") if traces else ()
    return examples, {name: _spawn((name, card)) for name in named}, \
        started_at


def start_float64_worker(card, started):
    """Start phase 31's worker with ``PYMC3_TPU_FLOATX=float64`` in its
    environment, so that the port reads its float width from there, and
    add it to ``started``'s workers."""
    started[1]["float64"] = _spawn(
        ("float64", card), env=dict(os.environ, PYMC3_TPU_FLOATX="float64"))


def start_glm_worker(card, started):
    """Start phase 24's worker and add it to ``started``'s workers."""
    started[1]["glm"] = _spawn(("glm", card))


def _read_worker(worker):
    """Wait for a worker, copy its standard error to ours, and return its
    exit code and the lines of its standard output."""
    proc, out, err, _ = worker
    proc.wait()
    err.seek(0)
    sys.stderr.write(err.read())
    out.seek(0)
    return proc.returncode, out.read().splitlines()


def _finished_during(finished):
    """The phase of the main process that was running at ``finished``."""
    during = [name for name, at in PHASE_STARTS
              if finished is not None and at <= finished]
    return during[-1] if during else None


# (phase name, time.time() at its start) of each of phases 7-31 run so far
PHASE_STARTS = []
# the gates of phase 4's GP and phase 26's radon run (float32), which phase
# 31 prints beside its float64 runs
RESULTS = {}
# what each phase of the main loop returned (phases 9-11, 17, 23 and 24
# give phase 31 its float32 walls)
PHASE_OUT = {}


def phase_examples(card, started):
    """The fifteen examples of ``tests/test_examples.py`` on the card, each
    built by its own module at its own data width and run through its own
    entry point: ``sample()`` at 256 chains, tune 100 + draws 50, pooled
    adaptation and the NUTS arguments of the example's ``run()``, or
    ``pm.fit`` for ``minibatch_advi_logistic``. Many chains and short runs:
    a batch of chains costs little more than one, but a NUTS iteration
    lasts as long as its deepest lane's tree. Where a first run showed one
    lane far deeper than the rest, ``EXAMPLE_RUNS`` changes the run:

    - ``glm_hierarchical`` (the centred radon model, a funnel: 110
      divergences and the deepest lane at depth 6.4 of a mean 4.3; 59 s)
      caps the tree depth at 5;
    - ``arma_example`` starts every chain at the test point
      (``init="adapt_diag"``): with the default jitter one of 256 lanes was
      stranded 12 posterior sds away;
    - ``custom_dists`` starts every chain at the least-squares line and its
      residual sd, and caps its depth at 6: its ``sigma`` is untransformed
      with a 1/sigma prior, so from the jittered test point (``sigma`` near
      1 or below, residuals near 50) one lane was stranded 6 sds away and
      built trees of depth 10 every draw (170 s), and from the test point
      itself several lanes halved their step sizes to a standstill;
    - ``lasso_missing`` is a compound step, NUTS over the continuous
      variables and the binary Gibbs sampler that ``sample()`` assigns to
      its 91 imputed indicators (91 logp calls a draw). Its uncentred
      predictors correlate the intercept with age's coefficient: with a
      diagonal mass matrix the deepest lane reached depth 7.4 (374 s), so
      its NUTS adapts a dense one pooled over the chains, windows of 16 and
      32 draws (after tune 60 with windows of 20 the second window never
      closed, the estimate kept the first draws and the depth stayed near
      6); tune 80 + draws 30. (``BinaryMetropolis`` over the indicators,
      one logp a draw, failed the moment check by 15 MCSEs in 50 draws,
      with R-hat 1.25: the imputed values mixed too slowly.)

    The examples run in three worker processes, started after phase 5 and
    read here: each step of one is bound by its process's host dispatch,
    and the card is idle most of the time, so they run beside phases 7-24
    (whose walls they lengthen) instead of adding their own. The groups are
    made from each example's wall in an earlier run (``EXAMPLE_WALLS``,
    :func:`_example_groups`). Each worker's finish is printed with the
    phase of the main process it fell in, which shows how far the overlap
    reached. Each example's wall is taken beside the other processes; its
    ms per logp+grad at 256 chains is taken here, in the main process,
    after the workers have exited, with the card to itself.

    Gates. ``factor_potential`` against its closed form N(1/3, 1/3) and
    ``samplers_mvnormal`` against N(0, cov) (``moment_check`` with no
    error on the exact side). The other sampled ones against the JAX
    package's run of the same example at 16 chains, tune 1000 + draws 2500
    (``examples/reference_moments.json``, ``tests/torch_reference.py
    examples``; the variables of ``examples/suite.py::EXAMPLE_GATES``):
    |Δmean| / combined MCSE < 4 and sds within 20%. Split R-hat (rank
    normalised, the larger of the bulk and the folded one): of a converged
    ensemble it is about ``1 + (tau - 1) / draws``, ``tau`` the draws'
    integrated autocorrelation time, whatever the chain count. NUTS draws
    of a near-Gaussian posterior alternate about the mean (bulk ESS above
    the draw count), which correlates the folded draws |x - median| and
    lifts R-hat above 1.01 at 50 draws all the same
    (``tests/test_torch_stats.py::test_split_rhat_of_converged_short_chains``
    simulates both at 256 x 50; ``gelman_bioassay`` read 1.0224 on the
    card with a bulk ESS of 12,388 of its 12,800 draws). So the limit
    is ``1.01 + 2 (tau - 1) / draws`` with ``tau`` the reference run's
    (chains x draws over its ESS) but at least 2: it admits the port's
    draws being twice as correlated as that and flags chains that
    disagree beyond it. ``minibatch_advi_logistic`` (50,000 rows, d = 10,
    batches of 500, Adam at 0.02 for ``EXAMPLE_ADVI``'s steps) against two
    JAX fits of the same settings with phase 17's ``_fit_gate``. Every
    example runs before the phase fails; any failure ends the script.

    ``gp_example`` (60 inputs) runs both covariance kernels at (256, 60,
    60, 1): its worker counts their launches in its ``sample()``, which
    are returned for the kernels line."""
    procs, _, started_at = started
    t0 = time.time()
    rows, failed, launches, workers = {}, [], None, []
    for worker in procs:
        code, lines = _read_worker(worker)
        group, finished = worker[3], None
        for line in lines:
            if line.startswith("EXAMPLE "):
                res = json.loads(line[len("EXAMPLE "):])
                rows[res["name"]] = res["row"]
                failed += res["failed"]
                launches = res["launches"] or launches
                finished = res["finished_at"]
            else:
                print(line, flush=True)
        missing = [n for n in group if n not in rows]
        if missing:
            failed.append(f"worker {group} exited {code} without a result "
                          f"for {missing}")
        workers.append({
            "examples": list(group), "exit": code,
            "walls_s": sum(EXAMPLE_WALLS[n] for n in group),
            "finished_s": (None if finished is None
                           else finished - started_at),
            "during": _finished_during(finished)})
        print(f"examples worker: {json.dumps(workers[-1])}", flush=True)
    waited = time.time() - t0
    if failed or sorted(rows) != sorted(EXAMPLES):
        fail("examples: " + "; ".join(failed or ["an example did not run"]))
    import importlib
    from pymc3_tpu_torch.examples.suite import example_model
    for name in EXAMPLES:
        if name == "minibatch_advi_logistic":
            continue
        model = example_model(importlib.import_module(
            f"pymc3_tpu_torch.examples.{name}"))
        _on_card(model, name)
        rows[name]["logp_grad_ms"] = _logp_grad_ms(model, 256, calls=20)
    print("examples logp+grad ms at 256 chains: " + json.dumps(
        {n: r["logp_grad_ms"] for n, r in rows.items()
         if "logp_grad_ms" in r}), flush=True)
    print(json.dumps({"phase": "examples", "examples": rows,
                      "gp_example_launches": launches, "workers": workers,
                      "waited_s": waited, "card": card}), flush=True)
    return launches


def read_worker_phase(started, name):
    """Phase 24, 26, 27, 28 or 31 (``name``) as the full run makes it: read
    from the worker that :func:`start_workers` started after phase 5, or
    :func:`start_float64_worker` or :func:`start_glm_worker` later (its
    lines are printed here), and fail if it failed. Each of these runs is bound
    by its own process's host dispatch, as the examples are, so it runs
    beside phases 7-24 instead of adding its wall to theirs; its walls are
    taken beside them. Returns the worker's closing JSON line."""
    _, workers, started_at = started
    marker = name.upper() + " "
    t0 = time.time()
    code, lines = _read_worker(workers[name])
    result = None
    for line in lines:
        if line.startswith(marker):
            result = json.loads(line[len(marker):])
        else:
            print(line, flush=True)
    finished = None if result is None else result["finished_at"]
    print(f"{name} worker: " + json.dumps({
        "exit": code, "finished_s": (None if finished is None
                                     else finished - started_at),
        "during": _finished_during(finished),
        "waited_s": time.time() - t0}), flush=True)
    if code != 0 or result is None:
        fail(f"{name}: the worker exited {code}")
    return result


def _concat_draws(first, second):
    """One trace of each chain's draws of ``first`` followed by those of
    ``second`` (values and statistics)."""
    from pymc3_tpu_torch.backends.base import MultiTrace
    from pymc3_tpu_torch.backends.ndarray import NDArray
    straces = []
    for c in first.chains:
        a, b = first._straces[c], second._straces[c]
        s = NDArray(model=a.model, vars=a.vars)
        s.chain = c
        s.samples = {k: np.concatenate([a.samples[k], b.samples[k]])
                     for k in a.samples}
        s.sampler_vars = a.sampler_vars
        s._stats = [{k: np.concatenate([x[k], y[k]]) for k in x}
                    for x, y in zip(a._stats, b._stats)]
        s.draw_idx = s.draws = len(a) + len(b)
        straces.append(s)
    return MultiTrace(straces)


def _nuts_template(model):
    """A NUTS kernel state of ``model`` (the structure of phase 26's
    checkpoints) and a function giving the index, in its flattened leaves,
    of the tensor that ``pick(state)`` returns."""
    from torch.utils._pytree import tree_flatten
    from pymc3_tpu_torch.step_methods.hmc.nuts import NUTS
    q = torch.as_tensor(model.dict_to_array(model.test_point)[None],
                        device=model.device)
    state = NUTS(model=model).kernel_init(q)
    leaves = tree_flatten(state)[0]

    def index_of(pick):
        target = pick(state)
        return next(i for i, leaf in enumerate(leaves) if leaf is target)
    return state, index_of


def _dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def phase_traces(pm, card, tune=150, draws=(30, 30), chains=2048,
                 small_chains=256):
    """Phase 6's radon run at 2048 chains (``bench.py``'s model, pooled
    adaptation, target 0.9) split in two through the trace backends:

    1. tune 150 + draws 30, recording every free variable (a resumed chain
       starts at its trace's last point, so a trace that lacks a free
       variable cannot resume: that raises, naming it);
    2. ``save_trace`` to a temporary directory, then ``load_trace``;
    3. ``sample(tune=0, draws=30, resume_from=loaded)``.

    Checks: the resumed run's first step size equals the checkpoint's
    (``exp(log_bar_step) * eps_scale`` of each chain's dual averaging, and
    the first part's last step size), its mass-matrix diagonal equals the
    checkpoint's (its own checkpoint, after 30 draws untuned, holds the
    loaded one's ``var`` exactly); the 60 draws of both parts pass phase
    6's gate against ``BASELINE_CPU.json`` (moment check of ``mu_a``,
    R-hat < 1.01). Prints the save and load walls and the bytes written.

    Then ``gelman_schools`` at ``small_chains`` chains, tune 20 + draws 10
    by ``Metropolis`` (the backends, not the sampler, are under test here:
    under NUTS, untuned, the three runs took 47 s in a first run), once
    into NDArray, once through ``trace="text"`` and once through
    ``trace="sqlite"`` (the shortcuts write under the working directory, a
    temporary one here), each read back with its backend's ``load``: the
    card repeats a seed exactly, so every recorded value of the three runs
    must be equal. The text files hold each float's shortest repr, which
    reads back to the same float32: the tolerance is 0, as for SQLite's
    raw bytes.

    Returns radon's model and its 60 draws (with their energies), which
    phase 29 plots."""
    import tempfile
    from pymc3_tpu_torch.backends import sqlite as sqlite_backend
    from pymc3_tpu_torch.backends import text as text_backend
    from pymc3_tpu_torch.examples.radon import build_model
    model = build_model(pm)
    _on_card(model, "traces")
    kw = dict(chains=chains, model=model, progressbar=False,
              target_accept=0.9, axis_name="chains_local",
              record_stats=["diverging", "step_size", "energy"],
              compute_convergence_checks=False)
    t0 = time.time()
    first = pm.sample(draws=draws[0], tune=tune, random_seed=2, **kw)
    torch.cuda.synchronize()
    t_first = time.time() - t0
    lacking = pm.point_list_to_multitrace([{"mu_a": np.float32(1.0)}],
                                          model=model)
    try:
        pm.sample(draws=2, tune=0, model=model, progressbar=False,
                  resume_from=lacking, compute_convergence_checks=False)
        fail("traces: a trace without every free variable resumed")
    except ValueError as e:
        if "sigma_a_log__" not in str(e):
            fail(f"traces: the refusal does not name the variable: {e}")
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        path = pm.save_trace(first, os.path.join(tmp, "radon"))
        t_save = time.time() - t0
        n_bytes = _dir_bytes(path)
        t0 = time.time()
        loaded = pm.load_trace(path, model=model)
        t_load = time.time() - t0
    t0 = time.time()
    second = pm.sample(draws=draws[1], tune=0, random_seed=3,
                       resume_from=loaded, **kw)
    torch.cuda.synchronize()
    t_second = time.time() - t0

    def stat(trace, at):
        return np.asarray(trace.get_sampler_stats(
            "step_size", combine=False))[:, at]
    from pymc3_tpu_torch.sampling import checkpoint_leaves
    template, index_of = _nuts_template(model)
    i_bar = index_of(lambda s: s.da.log_bar_step)
    i_scale = index_of(lambda s: s.eps_scale)
    i_var = index_of(lambda s: s.pot.var)
    ckpt = checkpoint_leaves(template, [loaded._straces[c].warmup_state
                                        for c in loaded.chains])
    eps_ckpt = np.exp(ckpt[i_bar].astype(np.float64)) \
        * ckpt[i_scale].astype(np.float64)
    eps_err = float(np.max(np.abs(stat(second, 0) / eps_ckpt - 1.0)))
    if not np.array_equal(stat(second, 0), stat(first, -1)) \
            or not eps_err < 1e-6:
        fail(f"traces: the resumed step sizes differ from the checkpoint's "
             f"(relative error {eps_err:.2e})")
    var_in = ckpt[i_var]
    var_out = checkpoint_leaves(template, [
        second._straces[c].warmup_state for c in second.chains])[i_var]
    if not np.array_equal(var_in, var_out):
        fail("traces: the resumed run's mass matrix differs from the "
             "checkpoint's")
    both = _concat_draws(first, second)
    gate = RESULTS["radon"] = _gate(
        pm, both, ["mu_a"], _baseline()["radon"]["moments"],
        t_first + t_second,
        f"traces: radon chains={chains} tune={tune} draws="
        f"{draws[0]}+{draws[1]} (saved, loaded, resumed)")
    print(f"traces: save_trace {t_save:.2f} s, load_trace {t_load:.2f} s, "
          f"{n_bytes} bytes in {chains} chain directories; first part "
          f"{t_first:.2f} s, resumed part {t_second:.2f} s; step sizes "
          f"equal the checkpoint's to {eps_err:.1e}, mass matrix equal",
          flush=True)

    from pymc3_tpu_torch.examples.gelman_schools import build_model as schools
    small = schools()
    names = [v.name for v in small.unobserved_RVs]
    skw = dict(draws=10, tune=20, chains=small_chains, model=small,
               progressbar=False, random_seed=5,
               compute_convergence_checks=False)
    here = os.getcwd()
    walls = {}
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            t0 = time.time()
            ref = pm.sample(step=pm.Metropolis(model=small), **skw)
            walls["ndarray"] = time.time() - t0
            read = {}
            for backend, module, where in (
                    ("text", text_backend, "mcmc"),
                    ("sqlite", sqlite_backend, "mcmc.sqlite")):
                t0 = time.time()
                pm.sample(trace=backend, step=pm.Metropolis(model=small),
                          **skw)
                walls[backend] = time.time() - t0
                read[backend] = module.load(os.path.join(tmp, where),
                                            model=small)
        finally:
            os.chdir(here)
        for backend, got in read.items():
            if got.nchains != small_chains or len(got) != len(ref):
                fail(f"traces: {backend} read back {got.nchains} chains of "
                     f"{len(got)} draws")
            for v in names:
                for c in (0, small_chains // 2, small_chains - 1):
                    if not np.array_equal(
                            np.asarray(got.get_values(v, chains=[c])),
                            np.asarray(ref.get_values(v, chains=[c]))):
                        fail(f"traces: {backend}'s {v} of chain {c} differs "
                             "from the NDArray run's")
    print(f"traces: gelman_schools chains={small_chains} through NDArray, "
          f"text and SQLite: every value read back equal; walls "
          + json.dumps({k: round(v, 2) for k, v in walls.items()}),
          flush=True)
    print(json.dumps({"phase": "traces", "radon": gate, "save_s": t_save,
                      "load_s": t_load, "bytes": n_bytes,
                      "first_part_s": t_first, "resumed_part_s": t_second,
                      "step_size_rel_err": eps_err,
                      "small_walls_s": walls, "card": card}), flush=True)
    return model, both


# phase 29: the plots' numbers and the model graph ------------------------
# radon's five scalar hyper-parameters (pairplot) and its graph
RADON_HYPER = ["mu_a", "sigma_a", "mu_b", "sigma_b", "eps"]
RADON_GRAPH = {"mu_a": set(), "sigma_a": set(), "mu_b": set(),
               "sigma_b": set(), "a": set(), "b": set(), "eps": set(),
               "radon_like": {"mu_a", "sigma_a", "mu_b", "sigma_b", "a", "b",
                              "eps"}}
RADON_PLATES = {(): {"mu_a", "sigma_a", "mu_b", "sigma_b", "eps"},
                (85,): {"a", "b"}, (919,): {"radon_like"}}
# chains of the card-against-CPU check; the CPU tests' tolerance
PLOTS_CHECK_CHAINS = 64
PLOTS_RTOL = 1e-4


def _plot_data_calls():
    """{plot: (data function of (trace, device), series it computes)}."""
    from pymc3_tpu_torch import plots
    return {
        "traceplot": (lambda tr, dev: plots._trace_data(tr, device=dev),
                      lambda d: d["x"].shape[0] * d["x"].shape[1]),
        "plot_posterior": (
            lambda tr, dev: plots._posterior_data(tr, device=dev),
            lambda d: d["x"].shape[0]),
        "forestplot": (lambda tr, dev: plots._forest_data(tr, device=dev),
                       lambda d: d["hpd"].shape[0]),
        "densityplot": (lambda tr, dev: plots._density_data(tr, device=dev),
                        lambda d: d["x"].shape[0]),
        "autocorrplot": (
            lambda tr, dev: plots._autocorr_data(tr, device=dev),
            lambda d: d["acf"].shape[0] * d["acf"].shape[1]),
        "energyplot": (lambda tr, dev: plots._energy_data(tr, device=dev),
                       lambda d: 2),
        "pairplot": (lambda tr, dev: plots._pair_data(
            tr, RADON_HYPER, divergences=True, device=dev),
            lambda d: d["x"].shape[0]),
    }


def _plot_data_err(what, got, want):
    """The largest difference of two data functions' results, relative to
    each array's largest magnitude; fails where labels or flags differ."""
    if isinstance(want, dict):
        if set(got) != set(want):
            fail(f"plots: {what} has fields {sorted(got)}, expected "
                 f"{sorted(want)}")
        return max([0.0] + [_plot_data_err(f"{what}.{k}", got[k], want[k])
                            for k in want])
    if isinstance(want, tuple):
        return max(_plot_data_err(f"{what}[{i}]", a, b)
                   for i, (a, b) in enumerate(zip(got, want)))
    if isinstance(want, np.ndarray) and want.dtype.kind == "f":
        if got.shape != want.shape:
            fail(f"plots: {what} of shape {got.shape}, expected {want.shape}")
        scale = max(float(np.max(np.abs(want))), 1e-300) if want.size else 1.0
        return float(np.max(np.abs(got - want))) / scale if want.size \
            else 0.0
    if not np.array_equal(np.asarray(got), np.asarray(want)):
        fail(f"plots: {what} differs between the card and the CPU")
    return 0.0


def phase_plots(pm, card, model, trace):
    """The numbers behind every plot, on the card, from phase 26's radon
    trace (2048 chains, 60 draws, 175 scalars): each plot's data function
    over every scalar (``pairplot``'s over the five hyper-parameters),
    timed, its arrays checked for shape and finiteness; then each run on
    the first 64 chains both on the card and on the CPU, their arrays equal
    within the CPU tests' tolerance (rtol 1e-4 of each array's largest
    magnitude). The card's machine has no matplotlib: nothing is drawn.
    Then ``ModelGraph`` of the model built on the card: its parents and
    plates against ``RADON_GRAPH``/``RADON_PLATES``."""
    from pymc3_tpu_torch.backends.base import MultiTrace
    from pymc3_tpu_torch.model_graph import ModelGraph
    calls = _plot_data_calls()
    rows, labels = {}, []
    for name, (data, series) in calls.items():
        torch.cuda.synchronize()
        t0 = time.time()
        d = data(trace, None)
        wall = time.time() - t0
        rows[name] = {"wall_s": wall, "series": series(d),
                      "series_per_s": series(d) / wall}
        arrays = [d[k] for k in ("x", "y", "hpd", "mean", "acf") if k in d]
        arrays += list(d.get("marginal", ())[:2]) + list(
            d.get("transition", ())[:2])
        if not all(np.isfinite(a).all() for a in arrays):
            fail(f"plots: {name}'s data not finite")
        if name == "forestplot":
            labels = d["labels"]
    if len(labels) != 175:
        fail(f"plots: {len(labels)} scalars, expected radon's 175")
    if rows["traceplot"]["series"] != 175 * trace.nchains:
        fail("plots: traceplot did not compute a KDE a chain and scalar")
    sub = MultiTrace([trace._straces[c]
                      for c in trace.chains[:PLOTS_CHECK_CHAINS]])
    for name, (data, _) in calls.items():
        err = _plot_data_err(name, data(sub, None), data(sub, "cpu"))
        rows[name]["card_vs_cpu"] = err
        if not err <= PLOTS_RTOL:
            fail(f"plots: {name} on the card differs from the CPU by {err:.2e}"
                 f" of the largest value (rtol {PLOTS_RTOL})")
    t0 = time.time()
    graph = ModelGraph(model)
    parents, plates = graph.make_compute_graph(), graph.get_plates()
    graph_wall = time.time() - t0
    if parents != RADON_GRAPH or plates != RADON_PLATES:
        fail(f"plots: radon's graph {parents} / plates {plates} differ from "
             "the literal")
    for name, row in rows.items():
        print(f"plots: {name} data {row['wall_s']:.3f} s, {row['series']} "
              f"series, {row['series_per_s']:.1f} series/s, card vs CPU at "
              f"{PLOTS_CHECK_CHAINS} chains {row['card_vs_cpu']:.1e}",
              flush=True)
    print(json.dumps({"phase": "plots", "chains": trace.nchains,
                      "draws": len(trace), "scalars": len(labels),
                      "data": rows, "graph_s": graph_wall,
                      "card": card}), flush=True)


# phase 27: several ranks on the card ------------------------------------
MULTIRANK_CHAINS = 2048
MULTIRANK_TRANSITIONS = 30
# tolerance of the exactness check: a float32 transition of 2048 chains on
# two ranks against one process (rtol and atol)
MULTIRANK_TOL = dict(rtol=1e-5, atol=1e-5)
# the jobs of phase 27: (job, backend, ranks), all ranks on one card
MULTIRANK_JOBS = (("pair", "gloo", 2), ("schools", "nccl", 1))
MULTIRANK_DEVICE = "cuda:0"
_RANK_CODE = ("import sys; sys.path.insert(0, '.'); import chip_smoke; "
              "chip_smoke._multirank_rank(sys.argv[1:])")


def _radon_transitions(pm, mesh=None):
    """``MULTIRANK_TRANSITIONS`` pooled tuning transitions of radon
    (``bench.py``'s model, target 0.9) over ``MULTIRANK_CHAINS`` chains
    jittered from the test point, after the step-size probe: this rank's
    rows of them, with the global chains' noise (``parallel.GlobalNoise``,
    seed 11), so that ranks consume the numbers one process over every
    chain does. Deterministic
    algorithms on, so that no atomic sum blurs what is compared. Returns
    ``q``, the step sizes and the mass diagonal after the first and the
    last transition, as numpy."""
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.parallel import GlobalNoise
    from pymc3_tpu_torch.step_methods.arraystep import TuneContext
    from pymc3_tpu_torch.step_methods.hmc.nuts import find_reasonable_eps
    from pymc3_tpu_torch.step_methods.hmc.quadpotential import (
        QuadPotentialDiagAdapt)
    chains, transitions = MULTIRANK_CHAINS, MULTIRANK_TRANSITIONS
    model = build_model(pm)
    _on_card(model, "multirank exactness")
    n = model.ndim
    q0 = (model.dict_to_array(model.test_point)[None]
          + np.random.RandomState(3).uniform(-1, 1, (chains, n))).astype(
              np.float32)
    step = pm.NUTS(model=model, target_accept=0.9, axis_name="chains",
                   potential=QuadPotentialDiagAdapt(n, q0.mean(0),
                                                    np.ones(n), 10))
    step.mesh = mesh
    rows = slice(0, chains) if mesh is None else mesh.local_rows(chains)
    gen = torch.Generator(device=model.device)
    gen.manual_seed(11)
    noise = GlobalNoise(gen, chains, model.device, rows)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        q = torch.as_tensor(q0[rows], device=model.device)
        step.step_size = find_reasonable_eps(step, q, noise=noise)
        state = step.kernel_init(q)
        out = {"probe_eps": step.step_size}
        for i in range(transitions):
            q, state, stats = step.kernel_step(
                q, state, TuneContext(True, i, 150), noise)
            if i in (0, transitions - 1):
                out[i] = {k: v.detach().cpu().numpy() for k, v in (
                    ("q", q), ("eps", stats["step_size"]),
                    ("var", state.pot.var))}
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def _collectives_check(mesh):
    """gloo's SUM, MAX, MIN and broadcast on CUDA tensors (float32 and
    int64) against their values computed on the host."""
    w = mesh.world_size
    ranks = np.arange(w, dtype=np.float64)
    rows = np.stack([[1.0 + r, 5.0 - r, -r] for r in ranks])
    for dtype in (torch.float32, torch.int64):
        x = torch.tensor(rows[mesh.rank], dtype=dtype, device=mesh.device)
        got = {"sum": mesh.sum(x), "max": mesh.max(x), "min": mesh.min(x),
               "broadcast": mesh.broadcast(x, src=w - 1)}
        want = {"sum": rows.sum(0), "max": rows.max(0), "min": rows.min(0),
                "broadcast": rows[w - 1]}
        for op, t in got.items():
            if t.device != x.device or not np.array_equal(
                    t.cpu().numpy().astype(np.float64), want[op]):
                fail(f"multirank: {mesh.backend} {op} of {dtype} CUDA "
                     f"tensors gave {t.tolist()}, want {want[op].tolist()}")
    return ["sum", "max", "min", "broadcast"]


def _digest(arrays):
    """A hash of named numpy arrays, to compare them across ranks."""
    import hashlib
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _multirank_radon(pm, mesh, tune=150, draws=60):
    """Phase 26's radon run sharded over the ranks, pooled: every rank
    returns the trace of all 2048 chains. Rank 0 gates ``mu_a`` as phase
    26 does (moment check against ``BASELINE_CPU.json``, R-hat < 1.01).
    Returns the rank's wall, its collectives a draw and their host ms, the
    pooled step size (``exp(log_bar_step)``) and mass diagonal of each of
    its chains from the checkpoints, and a digest of the trace."""
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.sampling import checkpoint_leaves
    model = build_model(pm)
    _on_card(model, "multirank radon")
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    trace = pm.sample(draws=draws, tune=tune, chains=MULTIRANK_CHAINS,
                      model=model, devices=mesh, axis_name="chains",
                      target_accept=0.9, random_seed=2,
                      record_stats=["diverging", "step_size"],
                      progressbar=False, compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    calls, host_s = mesh.calls, mesh.host_s
    template, index_of = _nuts_template(model)
    ckpt = checkpoint_leaves(template, [trace._straces[c].warmup_state
                                        for c in trace.chains])
    bar = np.exp(ckpt[index_of(lambda s: s.da.log_bar_step)])
    var = ckpt[index_of(lambda s: s.pot.var)]
    arrays = {v: np.asarray(trace.get_values(v, combine=False))
              for v in trace.varnames}
    arrays.update({f"stat_{k}": np.asarray(trace.get_sampler_stats(
        k, combine=False)) for k in trace.stat_names})
    out = {"wall_s": wall, "chains": trace.nchains, "draws": len(trace),
           "tune": tune, "collectives_per_draw": calls / (tune + draws),
           "collective_host_ms_per_draw": 1e3 * host_s / (tune + draws),
           "bar": bar, "var": var, "digest": _digest(arrays)}
    if mesh.rank == 0:
        out["gate"] = _gate(pm, trace, ["mu_a"],
                            _baseline()["radon"]["moments"], wall,
                            f"multirank radon chains={MULTIRANK_CHAINS} "
                            f"over {mesh.world_size} ranks tune={tune} "
                            f"draws={draws}")
    return out


def _multirank_smc_gp(pm, gp_cov, mesh, particles=4096):
    """Phase 21's SMC on the GP with the particles sharded over the ranks:
    each rank's likelihood is one forward launch at (particles / ranks,
    200, 200, 1) per mutation step and one for the first evaluation. Rank 0
    gates the moments and the evidence as phase 21 does (the trace and
    the evidence are the same on every rank)."""
    from pymc3_tpu_torch.examples.suite import gp_regression
    ref = _reference_fits("smc_gp")
    base = _baseline()["gp"]["moments"]
    names = ["ls", "eta", "sigma"]
    model = gp_regression(pm)[0]
    _on_card(model, "multirank smc_gp")
    mesh.reset_counts()
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    with _LaunchShapes(gp_cov) as launched, _SMCCounts() as counts:
        torch.cuda.synchronize()
        t0 = time.time()
        trace = pm.sample_smc(draws=particles, model=model, random_seed=5,
                              devices=mesh)
        torch.cuda.synchronize()
        wall = time.time() - t0
    launches, shapes, steps = gp_cov.LAUNCHES, launched.forward, counts.steps
    backward = gp_cov.BACKWARD_LAUNCHES
    shape = (particles // mesh.world_size, 200, 200, 1)
    if launches != steps + 1 or set(shapes) != {shape}:
        fail(f"multirank smc_gp: {launches} forward launches at "
             f"{set(shapes)} for {steps} mutation steps, expected one each "
             f"at {shape} and one for the first evaluation")
    if backward != 0 or launched.backward:
        fail(f"multirank smc_gp: {backward} backward launches at "
             f"{set(launched.backward)}; SMC's likelihood takes no gradient")
    x = {v: np.asarray(trace[v], np.float64) for v in names}
    got = {"mean": {v: float(x[v].mean()) for v in names},
           "sd": {v: float(x[v].std()) for v in names},
           "smc_error": {v: ref["mean"][v]["sd"] for v in names}}
    lml = trace.report.log_marginal_likelihood
    out = {"particles": len(trace), "wall_s": wall, "stages": counts.stages,
           "mutation_steps": steps, "host_reads": counts.reads,
           "forward_launches": launches, "backward_launches": backward,
           "launch_shape": list(shape),
           "collectives": mesh.calls,
           "collective_host_ms": 1e3 * mesh.host_s,
           "log_marginal_likelihood": lml,
           "digest": _digest({v: x[v] for v in names})}
    if mesh.rank == 0:
        ref_base = {v: {"mean": base[v]["mean"][0], "sd": base[v]["sd"][0],
                        "mcse": base[v]["mcse"][0]} for v in names}
        gate = _smc_reference_gate(got, ref_base, names)
        lml_ref = ref["log_marginal_likelihood"]
        lml_z = abs(lml - lml_ref["mean"]) / (lml_ref["sd"] * np.sqrt(1.25))
        out.update(mean=got["mean"], sd=got["sd"], gate=gate,
                   evidence_z=lml_z)
        if not gate["pass"]:
            fail("multirank smc_gp posterior moments disagree with "
                 "BASELINE_CPU.json")
        if not lml_z < 4.0:
            fail(f"multirank smc_gp evidence {lml:.4f} is {lml_z:.2f} sds "
                 "from the JAX runs'")
    return out


def _multirank_advi(pm, mesh, warm=50):
    """Phase 17's d = 100 fit (``scripts/bench_advi_minibatch.py``'s model
    and data, ADVI with ``adagrad_window`` from the test point, 5,000
    steps) through ``sharded_step_function``: every rank draws its own
    batch of 500 rows and its Monte-Carlo noise from its own generator, and
    the gradients are averaged over the ranks. After ``warm`` steps on a
    copy of the parameters, the timed steps. Rank 0 gates the fit with
    phase 17's ``_fit_gate`` against two fits of the JAX package's
    ``sharded_step_function`` over two CPU devices, a batch of 500 each
    (``tests/torch_reference.py advi_sharded``): the average of two
    batches' gradients has half the noise of one, and after 5,000 steps
    the JAX package's own sharded fits lie 23.6 noise sds from its
    single-device fits of phase 17, so those are not this fit's
    reference."""
    from pymc3_tpu_torch.examples.suite import (advi_logistic_data,
                                                 advi_logistic_model)
    from pymc3_tpu_torch.parallel import rank_seed
    from pymc3_tpu_torch.variational.updates import adagrad_window
    cfg = _reference_fits("advi_sharded")
    if cfg["devices"] != mesh.world_size:
        fail(f"multirank advi: the reference fits ran on {cfg['devices']} "
             f"devices, this on {mesh.world_size} ranks")
    X, y, _ = advi_logistic_data(cfg["N"], cfg["d"])
    model = advi_logistic_model(pm, X, y, cfg["batch"])
    _on_card(model, "multirank advi")
    with model:
        inference = pm.ADVI()
    objective, approx = inference.objective, inference.approx
    step, opt = objective.sharded_step_function(
        mesh=mesh, obj_n_mc=1, obj_optimizer=adagrad_window())
    gen = torch.Generator(device=model.device)
    gen.manual_seed(rank_seed(1, mesh))
    params = approx.params
    state = opt.init(params)
    warm_params = params
    for _ in range(warm):
        warm_params, state, _ = step(warm_params, state,
                                     objective.draw_noise(gen, 1))
    gen.manual_seed(rank_seed(2, mesh))
    state = opt.init(params)
    steps = cfg["steps"]
    losses = torch.zeros(steps, device=model.device)
    mesh.reset_counts()
    torch.cuda.synchronize()
    t0 = time.time()
    for i in range(steps):
        params, state, losses[i] = step(params, state,
                                        objective.draw_noise(gen, 1))
    torch.cuda.synchronize()
    wall = time.time() - t0
    approx.params = params
    out = {"N": cfg["N"], "d": cfg["d"], "batch_per_rank": cfg["batch"],
           "steps": steps, "wall_s": wall, "steps_per_s": steps / wall,
           "collectives": mesh.calls,
           "collective_host_ms_per_step": 1e3 * mesh.host_s / steps,
           "last100_loss": float(losses[-100:].mean()),
           "jax_last100_loss": [f["last100_loss"] for f in cfg["fits"]],
           "digest": _digest({f"{g}.{k}": v.cpu().numpy()
                              for g, leaf in params.items()
                              for k, v in leaf.items()})}
    if mesh.rank == 0:
        out["gate"] = _fit_gate(approx.mean, approx.std, cfg["fits"])
        if not out["gate"]["pass"]:
            fail(f"multirank advi: the fit is {out['gate']['max_z']:.2f} "
                 "noise sds from the JAX package's sharded fits")
    return out


def _multirank_rank(args):
    """One rank of phase 27, started by ``parallel.launch``: ``pair
    BACKEND OUT`` runs the two-rank parts, ``schools BACKEND OUT`` the
    one-rank part; the results go to ``OUT/rank<r>.pt``. A failed gate
    exits non-zero."""
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch import parallel
    from pymc3_tpu_torch.ops import gp_cov
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(1)
    job, backend, where = args
    mesh = parallel.initialize_distributed()
    if mesh.backend != backend:
        fail(f"multirank: asked for {backend}, the group runs "
             f"{mesh.backend}")
    out = {"rank": mesh.rank, "device": str(mesh.device),
           "backend": mesh.backend}
    t0 = time.time()
    if job == "pair":
        out["collectives_checked"] = _collectives_check(mesh)
        print(f"multirank rank {mesh.rank}: {backend} SUM/MAX/MIN/broadcast "
              f"of {mesh.device.type} tensors right", flush=True)
        out["exact"] = _radon_transitions(pm, mesh)
        out["exact_s"] = time.time() - t0
        for name, fn in (("radon", lambda: _multirank_radon(pm, mesh)),
                         ("smc_gp", lambda: _multirank_smc_gp(pm, gp_cov,
                                                              mesh)),
                         ("advi", lambda: _multirank_advi(pm, mesh))):
            out[name] = fn()
            print(f"multirank rank {mesh.rank}: {name} done in "
                  f"{out[name]['wall_s']:.2f} s", flush=True)
    else:
        ref = _reference_fits("examples")
        row, failed, _ = _run_example(pm, gp_cov, "gelman_schools", "", ref,
                                      devices=mesh)
        if failed:
            fail(f"multirank schools ({backend}): " + "; ".join(failed))
        out["schools"] = dict(row, collectives=mesh.calls,
                              collective_host_ms=1e3 * mesh.host_s)
    out["rank_wall_s"] = time.time() - t0
    torch.save(out, os.path.join(where, f"rank{mesh.rank}.pt"))


def phase_multirank(pm, card):
    """Phase 27 (see the module's docstring): the one-process reference of
    the exactness check here, then the jobs of ``MULTIRANK_JOBS`` (two
    gloo ranks on the card, then one NCCL rank), each through
    ``parallel.launch``; compares what the ranks saved and prints the
    phase's JSON line. Two ranks on one card
    show that the multi-rank code runs right on the card, not how it
    scales. Returns the ranks' forward and backward launches in SMC on the
    GP."""
    import tempfile
    from pymc3_tpu_torch import parallel
    t_phase = time.time()
    ref = _radon_transitions(pm)
    t_ref = time.time() - t_phase
    results = {}
    with tempfile.TemporaryDirectory() as tmp:
        for job, backend, n in MULTIRANK_JOBS:
            where = os.path.join(tmp, job)
            os.makedirs(where)
            t0 = time.time()
            try:
                outs = parallel.launch(["-c", _RANK_CODE, job, backend,
                                        where], n,
                                       devices=[MULTIRANK_DEVICE] * n,
                                       backend=backend, timeout=900,
                                       cwd=ROOT)
            except parallel.RemoteWorkerError as e:
                fail(f"multirank {job}: {e}")
            for text in outs:
                sys.stdout.write(text)
            results[job] = {
                "launch_s": time.time() - t0, "backend": backend,
                "ranks": [torch.load(os.path.join(where, f"rank{r}.pt"),
                                     weights_only=False) for r in range(n)]}
    gloo = results["pair"]["ranks"]
    ranks = len(gloo)

    # 1. one process against two ranks, transition by transition
    errors = {}
    for i in (0, MULTIRANK_TRANSITIONS - 1):
        for k in ("q", "eps", "var"):
            got = np.concatenate([r["exact"][i][k] for r in gloo])
            want = ref[i][k]
            err = np.abs(got.astype(np.float64) - want)
            bound = MULTIRANK_TOL["atol"] + MULTIRANK_TOL["rtol"] * np.abs(
                want.astype(np.float64))
            errors[f"{k}@{i + 1}"] = float(err.max())
            if not np.all(err <= bound):
                fail(f"multirank: {k} after transition {i + 1} on {ranks} "
                     f"ranks differs from one process by {err.max():.3e} "
                     f"({int((err > bound).sum())} values beyond rtol "
                     f"{MULTIRANK_TOL['rtol']}, atol {MULTIRANK_TOL['atol']})")
    probes = [r["exact"]["probe_eps"] for r in gloo] + [ref["probe_eps"]]
    if len(set(probes)) != 1:
        fail(f"multirank: the step-size probes differ: {probes}")
    print(f"multirank exactness: {MULTIRANK_CHAINS} chains, "
          f"{MULTIRANK_TRANSITIONS} pooled tuning transitions, one process "
          f"against {ranks} ranks, max |err| " + json.dumps(errors), flush=True)

    # 2-4. the same on every rank
    radon = [r["radon"] for r in gloo]
    half = MULTIRANK_CHAINS // ranks
    for k in ("bar", "var"):
        x = radon[0][k]
        if not all(np.array_equal(x[j * half:(j + 1) * half],
                                  x[:half]) for j in range(ranks)) or \
                not np.array_equal(x, radon[1][k]):
            fail(f"multirank radon: the pooled {k} differs between ranks")
        if np.ptp(x, axis=0).max() != 0:
            fail(f"multirank radon: the pooled {k} differs between chains")
    for name in ("radon", "smc_gp", "advi"):
        digests = {r[name]["digest"] for r in gloo}
        if len(digests) != 1:
            fail(f"multirank {name}: the ranks returned different results")
    schools = results["schools"]["ranks"][0]["schools"]
    if schools["collectives"] == 0:
        fail("multirank schools: sample(devices=mesh) issued no collective")
    launches = {d: sum(r["smc_gp"][f"{d}_launches"] for r in gloo)
                for d in ("forward", "backward")}
    drop = ("bar", "var", "digest")
    out = {"phase": "multirank", "ranks": ranks,
           "backends": {j: results[j]["backend"] for j in results},
           "reference_s": t_ref, "exact_max_abs_err": errors,
           "tolerance": MULTIRANK_TOL,
           "launch_s": {p: results[p]["launch_s"] for p in results},
           "rank_walls_s": [r["rank_wall_s"] for r in gloo],
           "radon": [{k: v for k, v in r["radon"].items() if k not in drop}
                     for r in gloo],
           "smc_gp": [{k: v for k, v in r["smc_gp"].items()
                       if k not in drop} for r in gloo],
           "advi": [{k: v for k, v in r["advi"].items() if k not in drop}
                    for r in gloo],
           "schools_one_rank": schools, "wall_s": time.time() - t_phase,
           "card": card}
    print(json.dumps(out, default=float), flush=True)
    return launches


# phase 28: radon's chains and draws (phase 6's record: split R-hat - 1
# grows as 1 / draws whatever the chain count, about 1.0057 at 60 draws)
AEVB_RADON = {"chains": 256, "tune": 150, "draws": 60}
AEVB_GRAD_CHAINS = 2048
# the grad_vars subset against the full gradient: the same float32 sums
AEVB_GRAD_TOL = dict(rtol=1e-5, atol=1e-4)
# sum of the factors' logp against the model's: the same terms summed in
# another order, about 2,500 in float32
AEVB_LOGP_TOL = dict(rtol=1e-5, atol=1e-3)
AEVB_PRIOR_DRAWS = 100_000


def _aevb_tolerance(fits, optimum):
    """The tolerance of the amortized fit's ``w``, ``b`` and ``sigma``
    around their optimum, from the JAX package's five seeded fits of the
    same settings on the CPU: their mean's distance from the optimum (the
    bias of a constant-rate Adam fit on minibatches) plus 5 of their sds,
    widened by sqrt(1 + 1/5) for the sd's own error from five fits (as
    phase 17's ``_fit_gate`` widens by sqrt(1.5) for two)."""
    out = {}
    for k in ("w", "b", "sigma"):
        x = np.array([f[k] for f in fits], np.float64)
        out[k] = float(abs(x.mean() - optimum[k])
                       + 5.0 * x.std(ddof=1) * np.sqrt(1.0 + 1.0 / len(x)))
    return out


def _aevb_fit(pm, card):
    """Part 1: the amortized fit at the benchmark's width."""
    from pymc3_tpu_torch.examples.suite import (AEVB_OPTIMUM, AEVB_VAE,
                                                 aevb_vae_data,
                                                 aevb_vae_model)
    from pymc3_tpu_torch.model import RNG_ENV_KEY
    cfg = AEVB_VAE
    data = aevb_vae_data(cfg["N"])
    model, zs, x_mini = aevb_vae_model(pm, data, cfg["batch"])
    _on_card(model, "aevb")
    rows_all = torch.as_tensor(data, device=model.device)

    def encoder(aux, draw):
        rows = rows_all[x_mini.indices(draw)]
        return rows * aux["w"] + aux["b"], aux["rho"].expand(rows.shape)

    def fit(steps, seed):
        with model:
            inference = pm.ADVI(local_rv={zs: dict(encoder=encoder,
                                                   aux=cfg["aux0"])})
        t0 = time.time()
        approx = inference.fit(steps, obj_n_mc=cfg["obj_n_mc"],
                               progressbar=False, random_seed=seed,
                               obj_optimizer=pm.adam(
                                   learning_rate=cfg["learning_rate"]))
        torch.cuda.synchronize()
        return approx, time.time() - t0

    # the encoder and the likelihood read the same rows of one draw
    noise = fit(1, 0)[0].draw_noise(torch.Generator(
        device=model.device).manual_seed(3), 8)["minibatch"]
    for i in range(8):
        draw = {k: v[i] for k, v in noise.items()}
        if not torch.equal(x_mini._eval_default({RNG_ENV_KEY: draw}, {}),
                           rows_all[x_mini.indices(draw)]):
            fail(f"aevb: sample {i}'s encoder rows differ from the "
                 "likelihood's")
    fit(50, 0)                                   # warm
    approx, wall = fit(cfg["steps"], 1)
    if not np.isfinite(approx.hist).all():
        fail("aevb: a loss of the fit is not finite")
    aux = {k: float(v) for k, v in approx.params[0]["aux"].items()}
    got = {"w": aux["w"], "b": aux["b"],
           "sigma": float(np.logaddexp(aux["rho"], 0.0))}
    tol = _aevb_tolerance(_reference_fits("aevb_vae")["fits"], AEVB_OPTIMUM)
    err = {k: abs(got[k] - AEVB_OPTIMUM[k]) for k in got}
    print(f"aevb: amortized fit N={cfg['N']} batch={cfg['batch']} "
          f"steps={cfg['steps']}: {cfg['steps'] / wall:.2f} steps/s "
          f"({wall:.2f} s); " + ", ".join(
              f"{k} {got[k]:.6f} (optimum {AEVB_OPTIMUM[k]:.6f}, |err| "
              f"{err[k]:.6f}, tolerance {tol[k]:.6f})" for k in got),
          flush=True)
    for k in got:
        if not err[k] < tol[k]:
            fail(f"aevb: the encoder's {k} {got[k]:.6f} is {err[k]:.6f} "
                 f"from its optimum {AEVB_OPTIMUM[k]:.6f}, beyond "
                 f"{tol[k]:.6f}")
    return {"steps": cfg["steps"], "wall_s": wall,
            "steps_per_s": cfg["steps"] / wall, "fit": got,
            "abs_err": err, "tolerance": tol,
            "last100_loss": float(np.mean(approx.hist[-100:]))}


def _aevb_trainable(pm):
    """Part 2: ``tests/test_aevb.py::aevb_model``'s trainable local
    parameters through ADVI and full-rank ADVI."""
    out = {}
    for method in ("ADVI", "FullRankADVI"):
        with pm.Model() as model:
            x = pm.HalfNormal("x", shape=(2,), total_size=5)
            pm.Normal("y", shape=(2,))
        _on_card(model, "aevb trainable")
        with model:
            inference = getattr(pm, method)(
                local_rv={x: dict(mu=np.zeros(2), rho=np.zeros(2))})
        start = [{k: v.clone() for k, v in p.items()}
                 for p in inference.approx.params.values()]
        approx = inference.fit(200, obj_n_mc=2, progressbar=False,
                               random_seed=1)
        for i, p in approx.params.items():
            if all(torch.equal(p[k], start[i][k]) for k in p):
                fail(f"aevb trainable {method}: group {i} was not trained")
        draws = np.asarray(approx.sample(1000, random_seed=2)
                           .get_values("x"))
        if not (np.isfinite(draws).all() and (draws > 0).all()):
            fail(f"aevb trainable {method}: a draw of x is not positive")
        out[method] = {"groups": [type(g).__name__ for g in approx.groups],
                       "x_mean": draws.mean(0).tolist()}
    print("aevb: trainable local groups " + json.dumps(out), flush=True)
    return out


def _aevb_rowwise(pm):
    """Part 3: a rowwise full-rank group at (4, 3): 4,000 draws against
    N(0, s^2), s = softplus(1), with ``tests/test_aevb.py``'s tolerances,
    and the covariance exactly zero off its blocks at random factors."""
    from pymc3_tpu_torch.variational.approximations import FullRankGroup
    with pm.Model() as model:
        one = pm.Normal("one", shape=(4, 3))
    g = FullRankGroup([one], rowwise=True, model=model)
    gen = torch.Generator(device=model.device).manual_seed(0)
    z, logq = g.sample_q(g.init_params(), g.draw_noise(gen, 4000))
    z, logq = z.double().cpu().numpy(), logq.double().cpu().numpy()
    s = float(np.log1p(np.exp(1.0)))
    want = (-0.5 * (np.log(2 * np.pi) + 2 * np.log(s)
                    + (z / s) ** 2)).sum(-1)
    checks = {"mean": float(np.abs(z.mean(0)).max()),
              "sd": float(np.abs(z.std(0) - s).max()),
              "logq": float(np.max(np.abs(logq - want)
                                   / (2e-3 + 2e-3 * np.abs(want))))}
    if not (checks["mean"] < 0.1 and checks["sd"] < 0.12
            and checks["logq"] <= 1.0):
        fail(f"aevb rowwise: draws or logq off N(0, {s:.4f}^2): {checks}")
    params = g.init_params()
    params["L_tril"] = torch.randn(params["L_tril"].shape, generator=gen,
                                   device=model.device)
    cov = g.cov(params)
    L = g._L(params)
    mask = torch.block_diag(*[torch.ones(3, 3, device=cov.device)] * 4)
    if bool(cov[mask == 0].ne(0).any()) or not torch.equal(
            cov[:3, :3], L[0] @ L[0].T):
        fail("aevb rowwise: the covariance is not block diagonal")
    print("aevb: rowwise group (4, 3) " + json.dumps(checks), flush=True)
    return checks


def _aevb_radon(pm, card):
    """Part 4: radon with its county names (``examples/radon.py``,
    ``coords=True``) at ``AEVB_RADON``'s chains, pooled, into
    InferenceData; then each factor's logp at a posterior point against
    the model's, and a ``grad_vars`` subset at ``AEVB_GRAD_CHAINS``
    chains against the full gradient's columns."""
    from pymc3_tpu_torch.examples.radon import build_model, county_names
    from pymc3_tpu_torch.examples.suite import chain_moments, moment_check
    model = build_model(pm, coords=True)
    _on_card(model, "aevb radon")
    cfg = AEVB_RADON
    t0 = time.time()
    idata = pm.sample(draws=cfg["draws"], tune=cfg["tune"],
                      chains=cfg["chains"], model=model, progressbar=False,
                      target_accept=0.9, axis_name="chains_local",
                      random_seed=4, return_inferencedata=True,
                      compute_convergence_checks=False)
    torch.cuda.synchronize()
    wall = time.time() - t0
    post = idata.posterior
    names = county_names()
    for v in ("a", "b"):
        dims = ("chain", "draw") + tuple(str(d) for d in post.dims.get(v,
                                                                      ()))
        if dims != ("chain", "draw", "county") or post[v].shape != (
                cfg["chains"], cfg["draws"], len(names)):
            fail(f"aevb radon: {v} has dims {dims}, shape {post[v].shape}")
    if [str(c) for c in post.coords["county"]] != names:
        fail("aevb radon: the county coordinate is not the 85 names")
    a_range = post["a_range"]
    a = (post["mu_a"][..., None] + post["sigma_a"][..., None] * post["a"])
    if not np.allclose(a_range, a.max(-1) - a.min(-1), rtol=1e-5,
                       atol=1e-5):
        fail("aevb radon: a_range is not a.max() - a.min()")
    check = moment_check(chain_moments(pm, {"mu_a": post["mu_a"]}),
                         _baseline()["radon"]["moments"])
    rhat = float(np.max(pm.rhat(np.asarray(post["mu_a"]))["x"]))
    print(f"aevb radon: chains={cfg['chains']} tune={cfg['tune']} draws="
          f"{cfg['draws']} into InferenceData, dims (chain, draw, county) "
          f"with the 85 names; wall {wall:.2f} s, R-hat of mu_a {rhat:.4f}, "
          f"moment check {check}", flush=True)
    if not check["pass"]:
        fail("aevb radon: mu_a disagrees with BASELINE_CPU.json")
    if not rhat < 1.01:
        fail(f"aevb radon: R-hat of mu_a {rhat:.4f} >= 1.01")

    point = {rv.orig_name: np.asarray(post[rv.orig_name][0, -1])
             for rv in model.free_RVs}
    factors = model.free_RVs + model.observed_RVs
    total = sum(f.logp(point) for f in factors)
    want = model.logp(point)
    logp_err = abs(total - want)
    if not logp_err <= AEVB_LOGP_TOL["atol"] + AEVB_LOGP_TOL["rtol"] * abs(
            want):
        fail(f"aevb radon: the factors' logp sum {total} differs from the "
             f"model's {want}")

    subset = [model["mu_a"], model["mu_b"], model["a"]]
    part = model.logp_dlogp_function(grad_vars=subset)
    full = model.logp_dlogp_function()
    extra = part.get_extra_values()
    rng = np.random.RandomState(5)
    cols = np.concatenate([np.arange(model.ordering[v.name].slc.start,
                                     model.ordering[v.name].slc.stop)
                           for v in subset])
    q = np.tile(model.dict_to_array(dict(model.test_point, **extra)),
                (AEVB_GRAD_CHAINS, 1))
    q[:, cols] += 0.5 * rng.randn(AEVB_GRAD_CHAINS, cols.size)
    q = torch.as_tensor(q, device=model.device)
    fl, fg = full(q)
    sl, sg = part(q[:, torch.as_tensor(cols, device=q.device)])
    grad_err = {
        "logp": check_close("aevb radon grad_vars logp", sl, fl,
                            AEVB_GRAD_TOL),
        "grad": check_close("aevb radon grad_vars gradient", sg,
                            fg[:, torch.as_tensor(cols, device=q.device)],
                            AEVB_GRAD_TOL)}
    print(f"aevb radon: sum of {len(factors)} factors' logp {total:.4f} "
          f"against the model's {want:.4f} (|err| {logp_err:.2e}); "
          f"grad_vars={[v.name for v in subset]} at {AEVB_GRAD_CHAINS} "
          f"chains against the full gradient's columns, max |err| "
          + json.dumps(grad_err), flush=True)
    return {"wall_s": wall, "rhat": rhat, "moment_check": check,
            "logp_sum_err": logp_err, "grad_vars_err": grad_err}


def _aevb_host_generator(pm):
    """Part 5: a ``DensityDist`` whose ``random`` is PyMC3's
    ``generate_samples(stats.norm.rvs, loc=..., scale=..., size=size)``:
    ``AEVB_PRIOR_DRAWS`` prior draws, drawn on the host and copied to the
    card once, against N(2, 0.5^2) within 4 standard errors of the mean
    and of the sd."""
    from scipy import stats
    loc, scale = 2.0, 0.5

    def random(point=None, size=None):
        return pm.distributions.generate_samples(
            stats.norm.rvs, loc=loc, scale=scale, size=size)

    with pm.Model() as model:
        pm.DensityDist("d", lambda v: -0.5 * ((v - loc) / scale) ** 2,
                       random=random)
    np.random.seed(7)
    with model:
        draws = model.sample_forward(AEVB_PRIOR_DRAWS)["d"]
    if draws.device.type != "cuda" or tuple(draws.shape) != (
            AEVB_PRIOR_DRAWS,):
        fail(f"aevb host generator: draws of shape {tuple(draws.shape)} on "
             f"{draws.device}, not ({AEVB_PRIOR_DRAWS},) on the card")
    n = AEVB_PRIOR_DRAWS
    z = {"mean": abs(float(draws.double().mean()) - loc) / (scale
                                                            / np.sqrt(n)),
         "sd": abs(float(draws.double().std()) - scale) / (
             scale / np.sqrt(2 * n))}
    print(f"aevb host generator: {n} draws on {draws.device}, z "
          + json.dumps(z), flush=True)
    if not (z["mean"] < 4 and z["sd"] < 4):
        fail(f"aevb host generator: moments off N({loc}, {scale}^2): {z}")
    return z


def phase_aevb(pm, card):
    """Phase 28 (see the module's docstring): AEVB and the model-core
    surface on the card. Prints the phase's JSON line."""
    t0 = time.time()
    out = {"phase": "aevb", "amortized": _aevb_fit(pm, card),
           "trainable": _aevb_trainable(pm), "rowwise": _aevb_rowwise(pm),
           "radon": _aevb_radon(pm, card),
           "host_generator_z": _aevb_host_generator(pm)}
    out.update(wall_s=time.time() - t0, card=card)
    print(json.dumps(out, default=float), flush=True)


# phase 31's runs at float64: the GP's tune and draws (phase 4's tune;
# draws doubled, see phase_float64), radon's (phase 26's 150 + 30 + 30 as
# one run), SMC's particles (phase 20's first run)
FLOAT64_GP = {"chains": 4, "tune": 200, "draws": 1000}
FLOAT64_RADON = {"chains": 2048, "tune": 150, "draws": 60}
FLOAT64_SMC_PARTICLES = (65_536,)
# phase 24's pooled GLM at float64: draws cut from 150 (phase 24 read
# R-hat 1.0042 at 150 draws on the card; split R-hat - 1 grows as 1 /
# draws, so about 1.0063 at 100, under the limit 1.01; it read 1.0064)
FLOAT64_GLM = {"chains": 256, "tune": 100, "draws": 100}
# phase 9's switchpoint model at float64, tuned twice as long as phase 9
# and cut to 300 draws. At phase 9's 300 + 400 it failed on the card at
# float64: the switchpoint's R-hat 1.0619 (limit 1.05) and sd 22.7% off; on
# the CPU the same settings read 1.0499 at float64 and 1.0423 at float32,
# so the gate sits at its edge there whatever the width. Tuned 600 draws,
# the walk's scale is tuned six times, not three: on the CPU at float64
# its ESS rose from 1,604 to 9,626 and R-hat fell to 1.0204 at 400 draws;
# R-hat - 1 grows as 1 / draws, so about 1.027 at 300, and about 1.034 on
# the card if it reads 1.24x the CPU's excess again (1.0619 against
# 1.0499). On the card it read 1.0258 at 300 draws, ESS 8,365 (873 at
# 300 + 400), in three runs of one seed
FLOAT64_DISASTER = {"chains": 256, "tune": 600, "draws": 300}
# the ODE's CUDA graphs at float64: these batch sizes
FLOAT64_ODE_CHAINS = (2, 64)
# float32 VI steps timed in the worker beside the float64 fits' ms a step
FLOAT64_VI_F32_STEPS = 300


def phase_float64(pm, gp_cov, card):
    """Phase 31's model part: the port at ``floatX = "float64"`` through
    its usual entry points. In a full run it runs in a worker process
    started before phase 14 with ``PYMC3_TPU_FLOATX=float64`` in its
    environment, so the float width comes from there (the config must read
    float64 and int64 with no ``set_config``); under ``--only float64`` in
    the main process after ``set_config(floatX="float64")``.

    1. The GP of phase 4 (n = 200, 4 chains, tune 200) through both float64
       kernels: forward and backward launches counted, both above 0; the
       trace's values float64; ``moment_check`` against
       ``BASELINE_CPU.json`` and R-hat < 1.01. Draws are 1,000, twice phase
       4's: at 500 draws the 4 chains' split R-hat is expected at
       1.004-1.010 and scattered to 1.0146 (phase 4's docstring), so 1.01
       needs the doubled draws (R-hat - 1 falls as 1 / draws).
    2. Radon at 2048 chains, pooled, target 0.9, tune 150 + draws 60
       (phase 26's run in one piece): ``moment_check`` of ``mu_a`` against
       ``BASELINE_CPU.json`` and R-hat < 1.01.
    3. Phase 20's SMC on two bumps at 65,536 particles, against its
       closed-form evidence (phase 20's gates).
    4. Phase 17's d = 100 minibatch ADVI with four optimizers
       (:func:`_float64_vi`), the freefall ODE's CUDA graphs
       (:func:`_float64_ode`), phase 24's pooled GLM (:func:`_float64_glm`)
       and phases 9, 11 and 10 (:func:`_float64_metropolis`), each gated as
       its float32 phase, its draws or parameters float64.
    5. logp(+grad) ms of those models and of the GP at 4 chains and radon
       at 2048, at float64 and then, after ``set_config(floatX="float32")``
       in this process, at float32 on models built anew, so the two widths
       are timed side by side (:func:`_float32_ms`); the config goes back
       to float64 after.

    Returns the numbers (ESS/s, walls, launches, logp(+grad) ms, the
    phase's wall)."""
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.examples.suite import gp_regression
    config = pm.get_config()
    if (config.floatX, config.intX) != ("float64", "int64"):
        fail(f"float64: the config reads floatX {config.floatX}, intX "
             f"{config.intX}")
    out = {"phase": "float64", "card": card}
    t_phase = time.time()
    model, names, _ = gp_regression(pm)
    _on_card(model, "float64 gp")
    gp_cov.LAUNCHES = gp_cov.BACKWARD_LAUNCHES = 0
    t0 = time.time()
    trace = pm.sample(progressbar=False, random_seed=2, model=model,
                      compute_convergence_checks=False, **FLOAT64_GP)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {"forward": gp_cov.LAUNCHES,
                "backward": gp_cov.BACKWARD_LAUNCHES}
    print(f"float64 gp: {launches['forward']} forward and "
          f"{launches['backward']} backward float64 kernel launches during "
          "sample()", flush=True)
    if min(launches.values()) <= 0:
        fail(f"float64 gp: a float64 kernel was never launched: {launches}")
    dtypes = {v: str(np.asarray(trace.get_values(v)).dtype) for v in names}
    if set(dtypes.values()) != {"float64"}:
        fail(f"float64 gp: the trace holds {dtypes}")
    out["gp"] = _gate(pm, trace, names, _baseline()["gp"]["moments"], wall,
                      "float64 gp chains={chains} tune={tune} draws={draws}"
                      .format(**FLOAT64_GP))
    out["gp"]["launches"] = launches
    out["gp"]["logp_grad_ms"] = _logp_grad_ms(model, FLOAT64_GP["chains"])

    radon = build_model(pm)
    _on_card(radon, "float64 radon")
    t0 = time.time()
    rtrace = pm.sample(model=radon, progressbar=False, random_seed=2,
                       target_accept=0.9, axis_name="chains_local",
                       trace=["mu_a"], compute_convergence_checks=False,
                       **FLOAT64_RADON)
    torch.cuda.synchronize()
    wall = time.time() - t0
    out["radon"] = _gate(
        pm, rtrace, ["mu_a"], _baseline()["radon"]["moments"], wall,
        "float64 radon chains={chains} tune={tune} draws={draws}"
        .format(**FLOAT64_RADON))
    out["radon"]["logp_grad_ms"] = _logp_grad_ms(radon,
                                                 FLOAT64_RADON["chains"])
    del trace, rtrace

    out["smc"] = phase_smc_bimodal(pm, card,
                                   particle_counts=FLOAT64_SMC_PARTICLES)
    out["vi"] = _float64_vi(pm)
    out["ode"] = _float64_ode(pm)
    out["glm"] = _float64_glm(pm)
    out.update(_float64_metropolis(pm, card))

    out["float32_logp_grad_ms"] = _float32_ms(pm, gp_regression, build_model)
    out["wall_s"] = time.time() - t_phase
    print(json.dumps(out), flush=True)
    return out


def _float64_trace(dtypes, label):
    """Fails unless every variable's draws are float64, or int64 for a
    discrete one (``intX`` at float64)."""
    if not set(dtypes.values()) <= {"float64", "int64"}:
        fail(f"{label}: the trace holds {dtypes}")


def _float64_vi(pm):
    """Phase 17's d = 100 minibatch ADVI (50,000 rows, batches of 500)
    with each optimizer of ``reference_moments.json``'s
    ``advi_optimizers`` (adam, adamax, adagrad_window and sgd at the rates
    there) for its steps (1,000: the JAX fits of the gate ran as many, so
    the count is the gate's, not phase 17's 5,000), each a new ``ADVI``
    from the test point. The parameters must be float64 after the fit;
    the means and sds are gated by phase 17's ``_fit_gate`` against the two
    JAX fits of the same optimizer, steps and rate. Returns each fit's
    wall, ms a step and gate."""
    from pymc3_tpu_torch.examples.suite import (advi_logistic_data,
                                                 advi_logistic_model)
    ref = _reference_fits("advi_optimizers")
    X, y, _ = advi_logistic_data(ref["N"], ref["d"])
    model = advi_logistic_model(pm, X, y, ref["batch"])
    _on_card(model, "float64 vi")
    rows = {}
    for name, cfg in ref["optimizers"].items():
        with model:
            inference = pm.ADVI()
        torch.cuda.synchronize()
        t0 = time.time()
        approx = inference.fit(n=ref["steps"], random_seed=2,
                               progressbar=False,
                               obj_optimizer=getattr(pm, name)(
                                   **cfg["kwargs"]))
        torch.cuda.synchronize()
        wall = time.time() - t0
        dtypes = sorted({str(t.dtype) for group in approx.params.values()
                         for t in group.values()} | {
            str(np.asarray(approx.mean).dtype),
            str(np.asarray(approx.std).dtype)})
        gate = _fit_gate(approx.mean, approx.std, cfg["fits"])
        rows[name] = {"steps": ref["steps"], "wall_s": wall,
                      "ms_per_step": 1e3 * wall / ref["steps"],
                      "last100_loss": float(np.mean(approx.hist[-100:])),
                      "jax_last100_loss": [f["last100_loss"]
                                           for f in cfg["fits"]],
                      "dtypes": dtypes, "gate": gate}
        print(f"float64 vi {name}: " + json.dumps(rows[name]), flush=True)
        if dtypes != ["float64", "torch.float64"]:
            fail(f"float64 vi {name}: the parameters are {dtypes}")
        if not gate["pass"]:
            fail(f"float64 vi {name}: the fit is {gate['max_z']:.2f} noise "
                 "sds from the JAX fits")
    return rows


def _float64_ode(pm):
    """The freefall ODE's logp+grad at float64 through the solve's CUDA
    graphs and eagerly, at ``FLOAT64_ODE_CHAINS`` points
    (:func:`_ode_graphs_check`): the same numbers within float64
    tolerance, graphs of the batch size captured in float64."""
    from pymc3_tpu_torch.examples import suite
    ode = suite.freefall_ode(pm)
    model, _ = suite.ode_model(pm, ode)
    _on_card(model, "float64 ode")
    return {str(n): _ode_graphs_check(model, ode, chains=n,
                                      label=f"float64 ode {n} chains")
            for n in FLOAT64_ODE_CHAINS}


def _float64_glm(pm):
    """Phase 24's pooled radon GLM at ``FLOAT64_GLM`` (jittered starts, a
    pooled diagonal mass matrix), gated as phase 24 against the JAX
    package's runs (``reference_moments.json``'s ``glm_radon``), R-hat <
    1.01, the draws float64."""
    from pymc3_tpu_torch.examples import suite
    ref = _reference_fits("glm_radon")["pooled"]["moments"]
    model, names = suite.glm_radon_pooled(pm)
    _on_card(model, "float64 glm")
    keep = [rv.name for rv in model.free_RVs] + names
    t0 = time.time()
    trace = pm.sample(model=model, init="jitter+adapt_diag",
                      progressbar=False, random_seed=2,
                      axis_name="chains_local",
                      trace=list(dict.fromkeys(keep)),
                      compute_convergence_checks=False, **FLOAT64_GLM)
    torch.cuda.synchronize()
    wall = time.time() - t0
    dtypes = _trace_dtypes(trace, names)
    _float64_trace(dtypes, "float64 glm")
    out = _gate(pm, trace, names, ref, wall,
                "float64 glm pooled chains={chains} tune={tune} "
                "draws={draws}".format(**FLOAT64_GLM),
                against="the JAX package's reference runs")
    out.update(dtypes=dtypes,
               logp_grad_ms=_logp_grad_ms(model, FLOAT64_GLM["chains"]))
    return out


def _float64_metropolis(pm, card):
    """Phases 9, 11 and 10 at float64 with their own gates: the switchpoint
    model by NUTS + ``Metropolis`` at ``FLOAT64_DISASTER``, the
    ``DEMetropolis`` population and the ``BinaryGibbsMetropolis`` scan at
    their phases' depths; each trace float64 (int64 for the switchpoint and
    the indicators)."""
    out = {"disaster": phase_disaster(pm, card, **FLOAT64_DISASTER),
           "population": phase_population(pm, card),
           "binary": phase_binary(pm, card)}
    for name, row in out.items():
        _float64_trace(row["dtypes"], f"float64 {name}")
    return out


def _float32_ms(pm, gp_regression, build_model):
    """The float32 side of phase 31's comparisons, timed in the same
    process after ``set_config(floatX="float32")`` on models built anew
    (the config goes back to float64 after): logp+grad ms of the GP at 4
    chains, radon at 2048, the pooled GLM at 256 and the switchpoint model
    at 256 (and its logp-only ms), logp-only ms of the population's normal
    at 2048 and the indicators at 1024, the ODE's graphs at
    ``FLOAT64_ODE_CHAINS``, and ms a step of ``FLOAT64_VI_F32_STEPS`` d =
    100 ADVI steps with adam."""
    from pymc3_tpu_torch.examples import disaster_model, suite
    pm.set_config(floatX="float32")
    try:
        disaster = disaster_model.build_model()
        ode = suite.freefall_ode(pm)
        ode_model, _ = suite.ode_model(pm, ode)
        out = {"gp": _logp_grad_ms(gp_regression(pm)[0],
                                   FLOAT64_GP["chains"]),
               "radon": _logp_grad_ms(build_model(pm),
                                      FLOAT64_RADON["chains"]),
               "glm": _logp_grad_ms(suite.glm_radon_pooled(pm)[0],
                                    FLOAT64_GLM["chains"]),
               "disaster": _logp_grad_ms(disaster,
                                         FLOAT64_DISASTER["chains"]),
               "disaster_logp_only": _logp_ms(disaster,
                                              FLOAT64_DISASTER["chains"]),
               "population_logp_only": _logp_ms(
                   suite.correlated_normal_model(pm)[0], 2048),
               "binary_logp_only": _logp_ms(suite.indicator_model(pm)[0],
                                            1024),
               "ode_graphs": {str(n): _ode_graphs_check(
                   ode_model, ode, chains=n,
                   label=f"float32 ode {n} chains")["graphs_ms"]
                   for n in FLOAT64_ODE_CHAINS}}
        X, y, _ = suite.advi_logistic_data(50_000, 100)
        with suite.advi_logistic_model(pm, X, y, 500):
            inference = pm.ADVI()
        torch.cuda.synchronize()
        t0 = time.time()
        inference.fit(n=FLOAT64_VI_F32_STEPS, random_seed=2,
                      progressbar=False, obj_optimizer=pm.adam(
                          learning_rate=0.01))
        torch.cuda.synchronize()
        out["vi_ms_per_step"] = 1e3 * (time.time() - t0) / \
            FLOAT64_VI_F32_STEPS
    finally:
        pm.set_config(floatX="float64")
    return out


# phase 31's worker starts before this phase of the full run, once the
# earlier workers are done (they finished during phases 9-13)
FLOAT64_STARTS_BEFORE = "garch"
# phase 24's worker starts before this phase (when phase 31's worker has
# about finished) and runs beside phases 19-23
GLM_STARTS_BEFORE = "svgd_map"


def _float64_only(pm, gp_cov, card):
    """Phase 31 in the main process (``--only float64``): the config set to
    float64 for the phase and back to float32 after."""
    pm.set_config(floatX="float64")
    try:
        return _float64_beside(phase_float64(pm, gp_cov, card))
    finally:
        pm.set_config(floatX="float32")


def _float64_beside(out):
    """Phase 31's numbers at float64 beside the float32 runs of the same
    script: ESS/s of phase 4's GP and phase 26's radon, the walls of phases
    9-11 and of phase 24's pooled GLM, phase 17's d = 100 ms a step and
    phase 23's graphs (None where that phase did not run), and the float32
    logp(+grad) ms and VI ms a step that phase 31 timed in its own
    process."""
    RESULTS["float64"] = out
    f32_ms = out["float32_logp_grad_ms"]
    row = {}
    for name in ("gp", "radon"):
        f32 = RESULTS.get(name)
        row[name] = {
            "ess_per_s_float64": out[name]["ess_per_s"],
            "ess_per_s_float32": None if f32 is None else f32["ess_per_s"],
            "logp_grad_ms_float64": out[name]["logp_grad_ms"],
            "logp_grad_ms_float32": f32_ms[name]}
    glm32 = PHASE_OUT.get("glm")
    row["glm"] = {
        "wall_s_float64": out["glm"]["wall_s"],
        "draws_float64": FLOAT64_GLM["draws"],
        "wall_s_float32": None if glm32 is None else glm32["pooled"]["wall_s"],
        "ess_per_s_float64": out["glm"]["ess_per_s"],
        "ess_per_s_float32": None if glm32 is None
        else glm32["pooled"]["ess_per_s"],
        "logp_grad_ms_float64": out["glm"]["logp_grad_ms"],
        "logp_grad_ms_float32": f32_ms["glm"]}
    for name, ms in (("disaster", "disaster_logp_only"),
                     ("population", "population_logp_only"),
                     ("binary", "binary_logp_only")):
        f32 = PHASE_OUT.get(name)
        row[name] = {
            "wall_s_float64": out[name]["wall_s"],
            "wall_s_float32": None if f32 is None else f32["wall_s"],
            "logp_ms_float32": f32_ms[ms]}
    row["disaster"].update(
        logp_ms_float64=out["disaster"]["logp_ms"],
        logp_grad_ms_float64=out["disaster"]["logp_grad_ms"],
        logp_grad_ms_float32=f32_ms["disaster"])
    vi32 = PHASE_OUT.get("advi_minibatch")
    row["vi"] = {
        "ms_per_step_float64": {k: v["ms_per_step"]
                                for k, v in out["vi"].items()},
        "ms_per_step_float32_adam": f32_ms["vi_ms_per_step"],
        "ms_per_step_float32_phase17": None if vi32 is None
        else vi32["d100"]["host_ms_per_step"]}
    ode32 = PHASE_OUT.get("ode")
    row["ode"] = {
        "graphs_ms_float64": {k: v["graphs_ms"]
                              for k, v in out["ode"].items()},
        "eager_ms_float64": {k: v["eager_ms"] for k, v in out["ode"].items()},
        "graphs_ms_float32": f32_ms["ode_graphs"],
        "graphs_ms_float32_phase23": None if ode32 is None else {
            "2": ode32["logp_grad"][2]["logp_grad_ms"],
            "64": ode32["graphs"]["graphs_ms"]}}
    print("float64 beside float32: " + json.dumps(row), flush=True)
    return row


def _gp_wall(other):
    """Phase 4 alone in four fresh processes: other, this, this, other."""
    code = ("import sys, torch; sys.path[:0] = ['.', 'scripts']; "
            "import chip_smoke, pymc3_tpu_torch as pm; "
            "from pymc3_tpu_torch.ops import gp_cov; "
            "chip_smoke.phase_device(); chip_smoke.phase_gp(pm, gp_cov)")
    for where in (other, ROOT, ROOT, other):
        out = subprocess.run([sys.executable, "-c", code], cwd=where,
                             capture_output=True, text=True)
        lines = [ln for ln in out.stdout.splitlines()
                 if ln.startswith(("gp:", "card:"))]
        print(f"gp-wall in {os.path.relpath(where, ROOT)}: "
              + " || ".join(lines), flush=True)
        if out.returncode != 0:
            fail(f"phase 4 failed in {where}:\n{out.stdout}\n{out.stderr}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--quick", action="store_true",
                        help="phases 1-3 and prediction at the test point")
    parser.add_argument("--against", metavar="DIR",
                        help="with --quick: time DIR's kernels too")
    parser.add_argument("--gp-wall", metavar="DIR",
                        help="phase 4 alone: DIR, this, this, DIR")
    parser.add_argument("--only", metavar="NAMES",
                        help="phases 1-3, then only these of phases 6-31 "
                        "(comma-separated: " + ",".join(
                            LATER_PHASES + ("plots",)) + ")")
    args = parser.parse_args()

    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
    # a time limit's SIGTERM still runs the exit handlers that stop workers
    signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    sys.path.insert(0, ROOT)
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch.ops import gp_cov

    if args.gp_wall:
        _gp_wall(os.path.abspath(args.gp_wall))
        return
    card = phase_device()
    phase_build(gp_cov)
    other = _load_other(os.path.abspath(args.against)) if args.against else None
    max_err, timings = phase_kernel(gp_cov, card, other)
    max_err64, timings64 = phase_kernel_f64(gp_cov, card, other)
    if args.quick:
        from pymc3_tpu_torch.examples.suite import gp_regression
        model, _, gp = gp_regression(pm)
        _on_card(model, "gp")
        phase_predict(gp_cov, model, gp, model.test_point,
                      "predict (test point)")
        print(f"quick: ok in {time.time() - t_start:.1f} s", flush=True)
        return
    runners = {
        "best": lambda: phase_best(pm),
        "mixture": lambda: phase_mixture(pm),
        "disaster": lambda: phase_disaster(pm, card),
        "binary": lambda: phase_binary(pm, card),
        "population": lambda: phase_population(pm, card),
        "lkj": lambda: phase_lkj(pm, card), "sv": lambda: phase_sv(pm, card),
        "garch": lambda: phase_garch(pm, card),
        "es": lambda: phase_es(pm, gp_cov, card),
        "labels": lambda: phase_labels(pm, card),
        "advi_minibatch": lambda: phase_advi_minibatch(pm, card),
        "advi_gp": lambda: phase_advi_gp(pm, gp_cov, card),
        "svgd_map": lambda: phase_svgd_map(pm, card),
        "api": lambda: phase_api(pm, card),
        "smc_bimodal": lambda: phase_smc_bimodal(pm, card),
        "smc_gp": lambda: phase_smc_gp(pm, gp_cov, card),
        "gp_sparse": lambda: phase_gp_sparse(pm, gp_cov, card),
        "ode": lambda: phase_ode(pm, gp_cov, card),
        "glm": lambda: phase_glm(pm, gp_cov, card),
        "examples": lambda: phase_examples(card, started[0]),
        "traces": lambda: phase_traces(pm, card),
        "plots": lambda: phase_plots(pm, card, *phase_traces(pm, card)),
        "multirank": lambda: phase_multirank(pm, card),
        "aevb": lambda: phase_aevb(pm, card),
        "float64": lambda: _float64_only(pm, gp_cov, card)}
    # phase 6's radon run is the first part of phase 26
    runners["radon"] = runners["traces"]
    started = [None]
    if args.only:
        if "examples" in args.only.split(","):
            started[0] = start_workers(card, traces=False)
        for name in args.only.split(","):
            t0 = time.time()
            PHASE_STARTS.append((name, t0))
            PHASE_OUT[name] = runners[name]()
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
        print(f"only: ok in {time.time() - t_start:.1f} s", flush=True)
        return
    launches, (model, gp, trace) = phase_gp(pm, gp_cov)
    predict_launches = phase_predict(gp_cov, model, gp,
                                     _posterior_mean_point(model, trace))
    gp_dist_launches, gp_dist_shape = phase_gp_dist(pm, gp_cov, model, gp,
                                                    trace)
    del model, gp, trace
    # phases 25-26 run in worker processes beside phases 7-24 (see
    # phase_examples and read_worker_phase)
    started[0] = start_workers(card)
    runners["traces"] = lambda: RESULTS.update(
        radon=read_worker_phase(started[0], "traces")["radon"])
    runners["multirank"] = lambda: read_worker_phase(
        started[0], "multirank")["launches"]
    runners["aevb"] = lambda: read_worker_phase(started[0], "aevb")
    runners["float64"] = lambda: _float64_beside(
        read_worker_phase(started[0], "float64"))
    runners["glm"] = lambda: read_worker_phase(started[0], "glm")
    walls = {}
    for name in LATER_PHASES:
        if name == FLOAT64_STARTS_BEFORE:
            start_float64_worker(card, started[0])
        if name == GLM_STARTS_BEFORE:
            start_glm_worker(card, started[0])
        t0 = time.time()
        PHASE_STARTS.append((name, t0))
        out = runners[name]()
        PHASE_OUT[name] = out
        walls[name] = round(time.time() - t0, 1)
        print(f"{name}: {walls[name]} s", flush=True)
        if name == "es":
            es_launches = out
        if name == "advi_gp":
            vi_launches = out
        if name == "smc_gp":
            smc_launches = out
        if name == "gp_sparse":
            fitc_launches = out
        if name == "examples":
            example_launches = out
        if name == "multirank":
            multirank_launches = out
    print(f"phases 1-31: {time.time() - t_start:.1f} s; each of 7-31 "
          f"{json.dumps(walls)}", flush=True)

    replaces = {"forward": "pymc3_tpu/ops/pallas/gp_cov.py:110",
                "backward": "pymc3_tpu/ops/pallas/gp_cov.py:215"}
    kernels = []
    for direction, name in (("forward", "stationary_cov"),
                            ("backward", "stationary_cov_backward")):
        row = timings[direction][MAIN_SHAPE]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[direction],
            "launches": launches[direction],
            # predict, es and smc_gp fail unless their backward count was 0
            "launches_predict": predict_launches if direction == "forward"
            else 0,
            # gp_dist fails unless its backward count was 0
            "launches_gp_dist": gp_dist_launches if direction == "forward"
            else 0,
            "gp_dist_samples_shape": gp_dist_shape,
            "launches_es": es_launches if direction == "forward" else 0,
            "launches_advi_gp": vi_launches[direction],
            "launches_smc_gp": smc_launches if direction == "forward"
            else 0,
            "launches_gp_sparse_smc": fitc_launches["smc"][direction],
            "launches_gp_sparse_logp_grad": fitc_launches["logp_grad"][
                direction],
            "launches_examples": example_launches[direction],
            "launches_multirank_smc_gp": multirank_launches[direction],
            "max_abs_err": max_err[direction],
            "ms": row["device_ms"], "device_ms": row["device_ms"],
            "issue_ms": row["issue_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "dtype": "float32",
            "entry": f"gp_cov_{direction}_f32",
            # the other timed shapes, e.g. "at_64x20x2000x1_matern52"
            **{"at_" + "x".join(map(str, shape)) + (
                f"_{TIMED_KIND[shape]}" if shape in TIMED_KIND else ""): {
                    k: timings[direction][shape][k] for k in (
                        "device_ms", "issue_ms", "plain_ms", "bound_ms",
                        "bound_by")}
               for shape in TIMED_SHAPES if shape != MAIN_SHAPE},
        })
    f64 = RESULTS["float64"]
    for direction, name in (("forward", "stationary_cov_f64"),
                            ("backward", "stationary_cov_backward_f64")):
        row = timings64[direction][MAIN_SHAPE]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE,
            "replaces": replaces[direction],
            "launches": f64["gp"]["launches"][direction],
            "max_abs_err": max_err64[direction],
            "ms": row["device_ms"], "device_ms": row["device_ms"],
            "issue_ms": row["issue_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "bound_bytes_ms": row["bound_bytes_ms"],
            "bound_ops_ms": row["bound_ops_ms"],
            "device_ms_runs": row["device_ms_runs"],
            "library_ms": None, "dtype": "float64",
            "entry": f"gp_cov_{direction}_f64",
            **{"at_" + "x".join(map(str, shape)): {
                k: timings64[direction][shape][k] for k in (
                    "device_ms", "issue_ms", "plain_ms", "bound_ms",
                    "bound_by", "bound_bytes_ms", "bound_ops_ms",
                    "device_ms_runs")}
               for shape in F64_TIMED if shape != MAIN_SHAPE},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
