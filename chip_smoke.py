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
   (4096, 20, 20, 1) forward, and a batch of 70,000 that the wrappers cut
   into two launches, each checked the same way;
4. GP marginal regression (``pymc3_tpu_torch/examples/suite.py``, n = 200,
   200 tune + 500 draws, 4 chains; tune cut from 500, then 300) sampled by NUTS
   through both kernels; moment check against ``BASELINE_CPU.json`` and
   R-hat < 1.02 (the phase's docstring says why);
5. GP prediction on the sampled model at the posterior mean:
   ``predict(diag=True, pred_noise=True)`` at 16,384 new inputs (a 200 x
   16,384 launch) and ``predict(diag=False)`` at 4,096 (200 x 4,096 and
   4,096 x 4,096 launches); launch counts, finiteness, positive variance,
   symmetry, the two calls' variances against each other, the same calls
   through the plain version, and the fit at the training inputs;
6. the radon model of ``bench.py`` at 2048 chains with pooled adaptation,
   150 tune + 60 draws (tune cut from 1000 and draws from 500, then 120
   and 90, to keep the whole run inside its limit as phases were added;
   at 110 tune, 9 draws after the first adaptation window closes, R-hat
   was 1.0251;
   split R-hat - 1 grows as 1 / draws whatever the chain count: 1.0019 at
   200 draws, 1.0027 at 120, 1.0038 at 90, so about 1.0057 at 60;
   ``PERF.md``); moment check of ``mu_a`` and R-hat < 1.01;
7. BEST (47 + 42 rows, StudentT likelihoods) at 256 chains, pooled, 150
   tune + 150 draws; moment check of ``difference_of_means`` and R-hat <
   1.01; then the posterior predictive of both groups at all 38,400 draws
   on the card: shapes, finiteness, and the median of the ``drug`` draws
   against the posterior median of ``group1_mean`` within four Monte-Carlo
   standard errors;
8. the 3-component mixture (1000 rows, Dirichlet weights, ordered means,
   Gamma precisions) at 512 chains, pooled, 150 tune + 70 draws (120 until
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
   depth cap 8, 30 tune + 40 draws: ``sigma`` and ``nu`` against the
   reference, R-hat of ``nu`` < 1.15;
14. GARCH(1,1) (``examples/garch_example.py``) at 256 chains, depth cap 5,
   100 tune + 100 draws (cut from 200): the three parameters against the
   reference, R-hat < 1.25 (two of them trade off and mix slowly);
15. a latent GP of 100 inputs (``examples/suite.py::es_model``: its prior
   covariance is one launch of the forward kernel) under
   ``EllipticalSlice`` at 256 chains, 300 tune (cut from 1000) + 1300
   draws, against the
   exact Gaussian posterior; R-hat < 1.25;
16. six labels of known component means with Dirichlet weights under
   ``[ElemwiseCategorical, NUTS]`` at 1024 chains, 30 tune + 170 draws,
   against the enumeration of all 729 states; R-hat < 1.02;
17. minibatch ADVI on the JAX package's benchmark
   (``scripts/bench_advi_minibatch.py``): logistic regression on 50,000
   rows at d = 100 with batches of 500 (10,000 steps) and at d = 512 with
   batches of 8192 (2,000 steps), each after a short warm fit; steps/s,
   host ms per step, the device's busy share over 20 steps, the ELBO and
   the coefficient RMSE; means and sds against two JAX fits
   (``examples/reference_moments.json``);
18. ADVI and full-rank ADVI on the GP (n = 200) through both covariance
   kernels, one forward and one backward launch per step, against two JAX
   fits; then ``sample(init="advi+adapt_diag")`` on BEST at 256 chains,
   gated as phase 7;
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
   host's;
25. a JSON line describing every kernel, then the result line
   ``{"ok": true, "device": {...}}``.

Phases 9-24 each print a JSON line of their own (each with the card's name
and power limit, and its ms per logp+grad or logp-only call or per VI
step). Every model is built with no device argument and must come out on
the card: that is the port's default.

Three shorter runs serve measurement; none prints the result line:

    python3 chip_smoke.py --quick [--against DIR]
    python3 chip_smoke.py --gp-wall DIR
    python3 chip_smoke.py --only lkj,sv,garch,es,labels

``--quick`` runs phases 1-3 and phase 5 at the model's test point (no
sampling). With ``--against DIR``, a checkout of another commit, it also
times that commit's forward kernel in the same call, in turns (other, this,
this, other). ``--gp-wall DIR`` runs phase 4 alone in four fresh processes
(DIR, this, this, DIR) and prints each wall. ``--only NAMES`` runs phases
1-3 and then the named ones of phases 6-24 (radon, best, mixture, disaster,
binary, population, lkj, sv, garch, es, labels, advi_minibatch, advi_gp,
svgd_map, smc_bimodal, smc_gp, gp_sparse, ode, glm).

Imports nothing of JAX or of the JAX package.
"""
import argparse
import importlib.util
import json
import os
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

# NVIDIA H100 SXM data sheet: device memory rate, float32 rate outside the
# tensor cores
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SOURCE = "pymc3_tpu_torch/csrc/gp_cov.cu"
LATER_PHASES = ("radon", "best", "mixture", "disaster", "binary",
                "population", "lkj", "sv", "garch", "es", "labels",
                "advi_minibatch", "advi_gp", "svgd_map", "smc_bimodal",
                "smc_gp", "gp_sparse", "ode", "glm")
MAIN_SHAPE = (4, 200, 200, 1)
# the GP's sample(), predict's two widths, ADVI's fifty Monte-Carlo samples
# a step (phase 18), SMC's 4,096 particles on the GP (phase 21), and FITC's
# cross-covariance and inducing covariance (matern52) over 64 chains and
# over 4,096 particles (phase 22)
VI_SHAPE = (50, 200, 200, 1)
FITC_SHAPE = (64, 20, 2000, 1)
SMC_SHAPE = (4096, 200, 200, 1)
FITC_SHAPES = (FITC_SHAPE, (64, 20, 20, 1), (4096, 20, 2000, 1),
               (4096, 20, 20, 1))
TIMED_SHAPES = (MAIN_SHAPE, (1, 4096, 4096, 4), (1, 200, 16384, 1),
                (1, 200, 4096, 1), VI_SHAPE, SMC_SHAPE) + FITC_SHAPES
TIMED_KIND = {shape: "matern52" for shape in FITC_SHAPES}
# a batch above the 65,535 blocks of gridDim.z: the wrappers cut it
CHUNKED_SHAPE = (70_000, 8, 8, 1)


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


def phase_build(gp_cov):
    path, seconds, log = gp_cov.build()
    ptxas = " | ".join(line.strip() for line in log.splitlines()
                       if "registers" in line or "spill" in line)
    print(f"build: {path.name} in {seconds:.1f} s", flush=True)
    print(f"ptxas: {ptxas}", flush=True)


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


def _bound_ms(direction, shape):
    """The least time the card could take: each input read once and each
    output written once at the memory rate, or the float32 operations at
    their peak, whichever is larger. Returns (ms, "bytes" | "operations")."""
    B, n, m, d = shape
    small = B * (n + m) * d
    if direction == "forward":
        nbytes = 4 * (B * n * m + small)        # K out; X, Xs in
        flops = B * n * m * (3 * d + 4)         # differences, f(d2)
    else:
        nbytes = 4 * (B * n * m + 2 * small)    # g, X, Xs in; dX, dXs out
        flops = B * n * m * (7 * d + 6)         # d2, f'(d2), two sums
    by_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    by_ops = 1e3 * flops / PEAK_F32_FLOPS
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
            if other is not None and direction == "forward":
                old = lambda: other._launch("expquad", X, Xs)  # noqa: E731
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

    # the shapes of phases 21-22 (SMC's particles run the forward only):
    # FITC's Kuf and Kuu at 64 points both ways and at 4,096 particles
    # forward (Kuu there takes the tiled kernel); and a batch above 65,535,
    # cut into two launches that count as one call
    for i, (kind, shape, backward) in enumerate((
            ("matern52", FITC_SHAPES[0], True),
            ("matern52", FITC_SHAPES[1], True),
            ("expquad", SMC_SHAPE, False),
            ("matern52", FITC_SHAPES[2], False),
            ("matern52", FITC_SHAPES[3], False),
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
    _gate(pm, trace, names, _baseline()["gp"]["moments"], wall, "gp",
          rhat_limit=1.02)
    return launches, (model, gp, trace)


def _timed_predict(gp_cov, model, gp, Xnew, point, expect, label, **kwargs):
    """One ``predict`` call on the card: its results, and a failure unless
    the forward kernel was launched ``expect`` times."""
    gp_cov.LAUNCHES = 0
    torch.cuda.synchronize()
    t0 = time.time()
    with model:
        mu, cov = gp.predict(Xnew, point=point, **kwargs)
    wall = time.time() - t0
    if gp_cov.LAUNCHES != expect:
        fail(f"{label}: {gp_cov.LAUNCHES} forward launches, expected "
             f"{expect}")
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


def _posterior_mean_point(model, trace):
    """The mean of every free variable's draws, in the sampler's
    (transformed) space."""
    return {rv.name: np.asarray(trace.get_values(rv.name, combine=True),
                                dtype=np.float64).mean(0)
            for rv in model.free_RVs}


def phase_radon(pm, draws=60, tune=150, chains=2048):
    from pymc3_tpu_torch.examples.radon import build_model
    model = build_model(pm)
    _on_card(model, "radon")
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


def phase_best(pm, draws=150, tune=150, chains=256):
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


def phase_mixture(pm, draws=70, tune=150, chains=512,
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

    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains), device=model.device)
    logp_fn, vag = model.make_logp_fn(), model.logp_dlogp_function()
    out.update(phase="disaster", chains=chains, tune=tune, draws=draws,
               switchpoint_mode=mode,
               switchpoint_dtype=str(s.dtype),
               metropolis_accept=float(np.mean(
                   trace.get_sampler_stats("accept"))),
               logp_ms=_synced_ms(lambda: logp_fn(q)),
               logp_grad_ms=_synced_ms(lambda: vag(q)), card=card)
    print(json.dumps(out), flush=True)


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
           "card": card}
    print(json.dumps(out), flush=True)
    if not zscore.max() < 4.0:
        fail(f"binary: an inclusion probability is {zscore.max():.2f} "
             "standard errors off the enumeration")


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
               card=card)
    print(json.dumps(out), flush=True)
    if not sd_rel < 0.10:
        fail(f"population: a marginal sd is {100 * sd_rel:.1f}% off")


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


def phase_sv(pm, card, draws=40, tune=30, chains=256):
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

    R-hat < 1.15 for ``nu``: 60 + 80 on the card drew 1.0630 and 30 + 50
    drew 1.0729, about 0.2 effective draws per draw with the capped trees,
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


def phase_garch(pm, card, draws=100, tune=100, chains=256):
    """``examples/garch_example.py``: 100 returns, three ``Uniform``
    priors, ``GARCH11`` (its volatility one Toeplitz product with powers of
    beta, not a loop), NUTS pooled over 256 chains at the example's
    target_accept 0.8, the tree depth capped at 5 (31 leapfrogs). A first
    run on the card (tune 200, no cap) took 279.72 s: mean depth 3.39, but
    every draw waited for a lane at depth 6 (most lanes need 3-4 and the
    lanes that diverged during tuning run at a halved step).

    R-hat < 1.25: the reference's chains hold 0.019-0.020 effective draws
    of ``beta1`` and ``omega`` per draw (the two trade off against each
    other), so a half chain of 100 draws holds about 2 and split R-hat is
    about sqrt(1 + 1/2) = 1.22; the port's chains do better (1.0398 on the
    card with 300 draws, 1.0719 without the depth cap); ``alpha1`` (0.16
    per draw) is near 1.03. Draws are 100 (cut from 200) for the run's
    budget: R-hat 1.0698 on the card at 150 draws, so about 1.10 at 100."""
    from pymc3_tpu_torch.examples import garch_example
    out, _ = _nuts_phase(pm, card, "garch", garch_example.build_model(),
                         ["alpha1", "beta1", "omega"], draws, tune, chains,
                         1.25, max_treedepth=5)
    print(json.dumps(out), flush=True)


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
    gp_cov.LAUNCHES = 0
    model, K = es_model(pm)
    launches = gp_cov.LAUNCHES
    _on_card(model, "es")
    if launches != 1:
        fail(f"es: {launches} forward launches building K, expected 1")
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
    with batches of 500 for 10,000 steps, and at d = 512 with batches of
    8192 for 2,000 steps. Each timed fit follows a warm fit of ``warm``
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
                  n_init=1000, warm=20):
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
    most ``n_init`` steps, stopped early by the convergence callbacks), 50
    tune + 150 draws (the ADVI fit gives the mass matrix its start), gated
    as phase 7 against ``BASELINE_CPU.json`` (R-hat 1.0046 at 200 draws on
    the card, so about 1.006 at 150).
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
    gp_cov.LAUNCHES = 0
    with _LaunchShapes(gp_cov) as launched, _SMCCounts() as counts:
        torch.cuda.synchronize()
        t0 = time.time()
        trace = pm.sample_smc(draws=particles, model=model, random_seed=5)
        wall = time.time() - t0
    launches, shapes, steps = gp_cov.LAUNCHES, launched.forward, counts.steps
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


def _ode_graphs_check(model, ode, chains=64):
    """logp+grad of ``model`` at ``chains`` points near the test point
    through the CUDA graphs of the solve and eagerly: the same numbers, a
    forward and a backward graph of ``chains`` lanes captured (a capture
    that fails raises), and each path's host ms per synced call."""
    from pymc3_tpu_torch.ode import graphs
    rng = np.random.RandomState(23)
    q0 = model.dict_to_array(model.test_point)
    q = torch.as_tensor((q0[None] + 0.1 * rng.randn(chains, q0.size))
                        .astype(np.float32), device=model.device)
    vag = model.logp_dlogp_function()
    res, ms = {}, {}
    for enabled in (False, True):
        graphs.ENABLED = enabled
        ms[enabled] = _synced_ms(lambda: vag(q), calls=10, warmup=2)
        res[enabled] = [x.cpu().numpy() for x in vag(q)]
    used = all(any(key[1][0] == chains for key in cache)
               for cache in (ode._graphs.forward, ode._graphs.backward))
    same = all(np.array_equal(a, b) for a, b in zip(res[False], res[True]))
    out = {"eager_ms": ms[False], "graphs_ms": ms[True], "captured": used,
           "same_numbers": same}
    print("ode graphs: " + json.dumps(out), flush=True)
    if not (used and same):
        fail("ode: the solve's CUDA graphs were not captured or do not give "
             "the eager path's numbers")
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
                        help="with --quick: time DIR's forward kernel too")
    parser.add_argument("--gp-wall", metavar="DIR",
                        help="phase 4 alone: DIR, this, this, DIR")
    parser.add_argument("--only", metavar="NAMES",
                        help="phases 1-3, then only these of phases 6-24 "
                        "(comma-separated: " + ",".join(LATER_PHASES) + ")")
    args = parser.parse_args()

    t_start = time.time()
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false")
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
    if args.quick:
        from pymc3_tpu_torch.examples.suite import gp_regression
        model, _, gp = gp_regression(pm)
        _on_card(model, "gp")
        phase_predict(gp_cov, model, gp, model.test_point,
                      "predict (test point)")
        print(f"quick: ok in {time.time() - t_start:.1f} s", flush=True)
        return
    runners = {
        "radon": lambda: phase_radon(pm), "best": lambda: phase_best(pm),
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
        "smc_bimodal": lambda: phase_smc_bimodal(pm, card),
        "smc_gp": lambda: phase_smc_gp(pm, gp_cov, card),
        "gp_sparse": lambda: phase_gp_sparse(pm, gp_cov, card),
        "ode": lambda: phase_ode(pm, gp_cov, card),
        "glm": lambda: phase_glm(pm, gp_cov, card)}
    if args.only:
        for name in args.only.split(","):
            t0 = time.time()
            runners[name]()
            print(f"{name}: {time.time() - t0:.1f} s", flush=True)
        print(f"only: ok in {time.time() - t_start:.1f} s", flush=True)
        return
    launches, (model, gp, trace) = phase_gp(pm, gp_cov)
    predict_launches = phase_predict(gp_cov, model, gp,
                                     _posterior_mean_point(model, trace))
    del model, gp, trace
    walls = {}
    for name in LATER_PHASES:
        t0 = time.time()
        out = runners[name]()
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
    print(f"phases 1-24: {time.time() - t_start:.1f} s; each of 6-24 "
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
            "launches_predict": predict_launches if direction == "forward"
            else 0,
            "launches_es": es_launches if direction == "forward" else 0,
            "launches_advi_gp": vi_launches[direction],
            "launches_smc_gp": smc_launches if direction == "forward"
            else 0,
            "launches_gp_sparse_smc": fitc_launches["smc"][direction],
            "launches_gp_sparse_logp_grad": fitc_launches["logp_grad"][
                direction],
            "max_abs_err": max_err[direction],
            "ms": row["device_ms"], "device_ms": row["device_ms"],
            "issue_ms": row["issue_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            # the other timed shapes, e.g. "at_64x20x2000x1_matern52"
            **{"at_" + "x".join(map(str, shape)) + (
                f"_{TIMED_KIND[shape]}" if shape in TIMED_KIND else ""): {
                    k: timings[direction][shape][k] for k in (
                        "device_ms", "issue_ms", "plain_ms", "bound_ms",
                        "bound_by")}
               for shape in TIMED_SHAPES if shape != MAIN_SHAPE},
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
