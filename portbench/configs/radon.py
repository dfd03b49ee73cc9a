"""Radon: ``bench.py:build_model`` in the port's DSL, its work count, and
its comparison with ``reference/radon.py``."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import radon as ref


def build_model(pm, cfg):
    """The hierarchical regression of the benchmark of record, non-centred
    county intercepts and floor slopes, on the frozen 919 rows."""
    county, floor, y = ref.load_data()
    with pm.Model() as model:
        mu_a = pm.Normal("mu_a", mu=0.0, sigma=cfg["prior_sd"])
        sigma_a = pm.HalfCauchy("sigma_a", cfg["cauchy_beta"])
        mu_b = pm.Normal("mu_b", mu=0.0, sigma=cfg["prior_sd"])
        sigma_b = pm.HalfCauchy("sigma_b", cfg["cauchy_beta"])
        a_raw = pm.Normal("a", mu=0.0, sigma=1.0, shape=cfg["counties"])
        b_raw = pm.Normal("b", mu=0.0, sigma=1.0, shape=cfg["counties"])
        a = mu_a + sigma_a * a_raw
        b = mu_b + sigma_b * b_raw
        eps = pm.HalfCauchy("eps", cfg["cauchy_beta"])
        pm.Normal("radon_like", mu=a[county.astype("int32")] + b[
            county.astype("int32")] * floor, sigma=eps,
            observed=y.astype(np.float32))
    return model


def work(cfg, chains):
    """One batched logp+grad's count (``cfg["work"]`` derives it): FLOPs
    a row and a coordinate, bytes of the points read and the gradients and
    densities written, at the configuration's precision."""
    w = cfg["work"]
    flops = chains * (w["flops_per_row"] * cfg["rows"]
                      + w["flops_per_coordinate"] * cfg["free_coordinates"])
    item = 4 if cfg["precision"] == "float32" else 8
    nbytes = item * (chains * (2 * cfg["free_coordinates"] + 1)
                     + 3 * cfg["rows"])
    return {"flops": flops, "bytes": nbytes, "peak": cfg["precision"]}


def _named(values, keys, lo, hi, device):
    return {k: torch.as_tensor(values[k][lo:hi], dtype=torch.float64,
                               device=device) for k in keys}


def numbers(values, model_logp, points, program_grad, device,
            block=65536):
    """The numbers compared, from the window's draws ``values`` (name ->
    ``(chains, draws, ...)``) and recorded ``model_logp``, and the
    program's gradient at ``points``:

    - ``logp_gap``: the largest |recorded model_logp - reference logp| over
      every draw of the window, in nats;
    - ``grad_gap``: over the chains' last draws, the largest gap of a
      gradient coordinate divided by the largest reference coordinate of
      that point;
    - ``transform_gap``: the largest relative gap of a recorded scale
      against exp of its recorded log;
    - ``cond_shift``: the largest mean, over every draw of the window, of a
      county coordinate standardised by its conditional posterior given
      the draw's hyperparameters, in units of that posterior's sd;
    - ``cond_spread``: the largest |mean of that standardised coordinate's
      square - 1|, the second moment beside the first;
    - ``still_share``: the share of consecutive window draws, over every
      chain, at which the chain's whole point did not change: a chain that
      stops moving keeps a posterior draw, whose moments pass the two
      numbers above.
    """
    data = ref.Data(torch.float64, device)
    chains, draws = model_logp.shape
    flat = {k: np.asarray(values[k]).reshape((chains * draws,)
                                             + np.shape(values[k])[2:])
            for k in ref.FREE}
    lp = np.asarray(model_logp, dtype=np.float64).reshape(-1)
    n = lp.shape[0]
    logp_gap = 0.0
    z_sum = torch.zeros(2, data.n_counties, dtype=torch.float64,
                        device=device)
    z2_sum = torch.zeros_like(z_sum)
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        p = _named(flat, ref.FREE, lo, hi, device)
        r = ref.logp(p, data)
        got = torch.as_tensor(lp[lo:hi], dtype=torch.float64, device=device)
        logp_gap = max(logp_gap, float((got - r).abs().max()))
        za, zb = ref.conditional_z(p, data)
        z_sum[0] += za.sum(0)
        z_sum[1] += zb.sum(0)
        z2_sum[0] += (za * za).sum(0)
        z2_sum[1] += (zb * zb).sum(0)
    cond_shift = float((z_sum / n).abs().max())
    cond_spread = float((z2_sum / n - 1.0).abs().max())
    transform_gap = 0.0
    for name, log_name in ref.SCALES:
        s = np.asarray(values[name], dtype=np.float64)
        e = np.exp(np.asarray(values[log_name], dtype=np.float64))
        transform_gap = max(transform_gap, float(np.max(np.abs(s - e) / e)))
    pts = {k: torch.as_tensor(np.asarray(points[k]), dtype=torch.float64,
                              device=device) for k in ref.FREE}
    g_ref = ref.grad(pts, data)
    scale = torch.stack([g.abs().reshape(g.shape[0], -1).max(1).values
                         for g in g_ref.values()]).max(0).values
    grad_gap = 0.0
    for k in ref.FREE:
        gp = torch.as_tensor(np.asarray(program_grad[k]), dtype=torch.float64,
                             device=device).reshape(g_ref[k].shape[0], -1)
        gap = (gp - g_ref[k].reshape(gp.shape)).abs().max(1).values / scale
        grad_gap = max(grad_gap, float(gap.max()))
    return {"logp_gap": logp_gap, "grad_gap": grad_gap,
            "transform_gap": transform_gap, "cond_shift": cond_shift,
            "cond_spread": cond_spread, "still_share": still_share(values)}


def still_share(values, block=4096):
    """Share of the consecutive pairs of window draws, over every chain, at
    which every free coordinate of the chain stayed as it was; NaN where
    the window holds fewer than two draws."""
    chains, draws = np.shape(values[ref.FREE[0]])[:2]
    if draws < 2:
        return math.nan
    still = 0
    for lo in range(0, chains, block):
        same = None
        for k in ref.FREE:
            v = np.asarray(values[k][lo:lo + block])
            v = v.reshape(v.shape[0], draws, -1)
            eq = (v[:, 1:] == v[:, :-1]).all(-1)
            same = eq if same is None else same & eq
        still += int(same.sum())
    return still / (chains * (draws - 1))


def check(ctx):
    """The numbers compared beside the cell's limits."""
    got = numbers(ctx.values, ctx.model_logp, ctx.points, ctx.program_grad,
                  ctx.device)
    return [{"name": k, "value": v, "limit": ctx.limits[k]}
            for k, v in got.items()]


def control(values, model_logp, points, program_grad, seed, device,
            dtype=torch.bfloat16, block=65536):
    """The reference computed in ``dtype`` (bfloat16, the precision below
    the configuration's float32) put in the program's place: the recorded
    logp, the scales, the gradient and the county coordinates of the
    window's draws (drawn from the conditional posterior given the
    program's hyperparameters) are the low-precision reference's. Returns
    :func:`numbers` of the result."""
    data = ref.Data(dtype, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    chains, draws = model_logp.shape
    flat = {k: np.asarray(values[k]).reshape((chains * draws,)
                                             + np.shape(values[k])[2:])
            for k in ref.FREE}
    n = chains * draws
    lp, a_out, b_out = np.empty(n), np.empty((n, data.n_counties)), \
        np.empty((n, data.n_counties))
    for lo in range(0, n, block):
        hi = min(n, lo + block)
        p = {k: torch.as_tensor(flat[k][lo:hi], device=device).to(dtype)
             for k in ref.FREE}
        a, b = ref.conditional_draw(p, data, gen)
        p["a"], p["b"] = a, b
        lp[lo:hi] = ref.logp(p, data).double().cpu().numpy()
        a_out[lo:hi] = a.double().cpu().numpy()
        b_out[lo:hi] = b.double().cpu().numpy()
    swapped = dict(values)
    swapped["a"] = a_out.reshape(chains, draws, -1)
    swapped["b"] = b_out.reshape(chains, draws, -1)
    for name, log_name in ref.SCALES:
        u = torch.as_tensor(np.asarray(values[log_name]), device=device)
        swapped[name] = torch.exp(u.to(dtype)).double().cpu().numpy()
    pts = {k: torch.as_tensor(np.asarray(points[k]), device=device).to(dtype)
           for k in ref.FREE}
    low_grad = {k: v.double().cpu().numpy()
                for k, v in ref.grad(pts, data).items()}
    return numbers(swapped, lp.reshape(chains, draws), points, low_grad,
                   device)


def frozen(values, model_logp, share):
    """The window as a transition that returns its state unchanged would
    leave it, in the consistent form that records the density of the
    point it keeps: the first ``share`` of the chains hold their first
    window draw, and its recorded density, for the rest of the window.
    Returns ``(values, model_logp)``; the fault's reading is
    :func:`numbers` of them."""
    k = int(round(share * np.shape(model_logp)[0]))
    out = {}
    for name, v in values.items():
        v = np.array(v)
        v[:k] = v[:k, :1]
        out[name] = v
    lp = np.array(model_logp)
    lp[:k] = lp[:k, :1]
    return out, lp
