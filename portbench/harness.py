"""One run of one cell: build the configuration's model with the port's
DSL, call ``pymc3_tpu_torch.sample`` once, time the window from its block
callback, judge the window's draws against the plain reference, and read
the cell's metrics.

Everything that belongs to one configuration, traffic mix or metric is in
a file of its own, found by name:

- ``configs/<config>.json``, the configuration as it is run, and
  ``configs/<module>.py`` (``module`` in the JSON, the configuration's
  name where it has none), its model in the port's DSL, its work count
  and its comparison with the plain reference in ``reference/``;
- ``traffic/<traffic>.json``, the sampler's settings;
- ``limits/<workload>.json``, the limit of each number compared;
- ``metrics/<metric>.py``, one ``read(ctx)`` for each metric.
"""
from __future__ import annotations

import importlib.util
import json
import math
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def find_cell(bench, workload):
    """The workload's entry, its configuration's entry and the metrics it
    reports: ``(cell, config_entry, end_to_end, per_layer)``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"known: {sorted(cells)}")
    cell = cells[workload]
    config = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def mine(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]
    return cell, config, mine(bench["end_to_end"]), mine(bench["per_layer"])


def load_cell(bench, workload, root=ROOT, pkg=PKG):
    """Everything a run of ``workload`` reads, found by name under
    ``pkg``."""
    cell, entry, e2e, layers = find_cell(bench, workload)
    cfg = load_json(root / entry["file"])
    # configurations of one model share its module: ``"module"`` names it
    module = cfg.get("module", cell["config"])
    return SimpleNamespace(
        name=workload, chips=cell["chips"], entry=entry, pkg=pkg, cfg=cfg,
        config=load_module(pkg / "configs" / f"{module}.py",
                           f"portbench_config_{module}"),
        traffic=load_json(pkg / "traffic" / f"{cell['traffic']}.json"),
        limits=load_json(pkg / "limits" / f"{workload}.json"),
        end_to_end=e2e, per_layer=layers)


def metric_reader(name, pkg=PKG):
    path = pkg / "metrics" / f"{name}.py"
    return load_module(path, "portbench_metric_" + name.replace(".", "_"))


class Window:
    """The block callback of ``sample()``: set-up ends at the first block
    end at or after the last tuning draw, and the window at the first block
    end at or after ``seconds`` past it, where a ``KeyboardInterrupt`` ends
    the run with the draws of the blocks done. A traced run opens the
    profiler at the first of those block ends and starts its window at the
    next; the traced span runs from the window's start to the first block
    end ``tracer.seconds`` past it."""

    def __init__(self, tune, seconds, tracer=None):
        self.tune = tune
        self.seconds = seconds
        self.tracer = tracer
        self.t_start = self.t_end = None
        self.kept_start = self.kept_end = None

    def __call__(self, trace=None, draw=None):
        now = time.perf_counter()
        if self.t_start is None:
            if draw.draw_idx >= self.tune:
                if self.tracer is not None and self.tracer.prof is None:
                    # a traced run opens the profiler here and starts its
                    # window a block later
                    self.tracer.open()
                    return
                self.t_start = now
                self.kept_start = draw.draw_idx - self.tune
                if self.tracer is not None:
                    self.tracer.start()
            return
        if self.tracer is not None and not self.tracer.done and \
                now - self.t_start >= self.tracer.seconds:
            self.tracer.stop()
        if now - self.t_start >= self.seconds:
            self.t_end = now
            self.kept_end = draw.draw_idx - self.tune
            if self.tracer is not None and not self.tracer.done:
                self.tracer.stop()
            raise KeyboardInterrupt

    @property
    def seconds_measured(self):
        return self.t_end - self.t_start


def _stack(per_chain, lo, hi):
    return np.stack([np.asarray(v)[lo:hi] for v in per_chain])


def run_cell(cell, seed, seconds, trace, device, t_process, log,
             break_step=None, keep=None):
    """One run of ``cell`` (from :func:`load_cell`). Returns the result
    line's dictionary. ``break_step``, for the fault tests only, wraps the
    NUTS transition; ``keep``, a dict, receives what the comparison read,
    for the control's readings."""
    import torch
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch.config import torch_floatX
    from pymc3_tpu_torch.step_methods.hmc.nuts import NUTS
    from . import devtrace
    from .ess import bulk_ess

    cfg, traffic, config = cell.cfg, cell.traffic, cell.config
    # the run's entry sets PYMC3_TPU_FLOATX before the port is imported;
    # this holds the precision where one process runs several cells
    pm.set_config(device=device, floatX=cfg["precision"])
    model = config.build_model(pm, cfg)
    tracer = devtrace.Tracer(traffic["trace_seconds"]) if trace else None
    window = Window(traffic["tune"], seconds, tracer)
    original = NUTS.kernel_step
    if break_step is not None:
        NUTS.kernel_step = break_step(original)
    try:
        mtrace = pm.sample(
            draws=traffic["draws"], tune=traffic["tune"],
            chains=traffic["chains"], model=model,
            target_accept=traffic["target_accept"], axis_name="chains",
            init="jitter+adapt_diag", progressbar=False,
            compute_convergence_checks=False, random_seed=seed,
            callback=window, block_size=traffic.get("block_size"))
    finally:
        NUTS.kernel_step = original
    t_returned = time.perf_counter()
    if window.t_end is None:
        raise RuntimeError("sample() ended before the window closed: raise "
                           "the traffic's draws")
    setup_s = window.t_start - t_process
    window_s = window.seconds_measured
    lo, hi = window.kept_start, window.kept_end
    log(f"set-up {setup_s:.4f} s, window {window_s:.4f} s, draws "
        f"{lo}..{hi} a chain, sample() returned {t_returned - window.t_end:.4f}"
        f" s after the window")

    values = {n: _stack(mtrace.get_values(n, combine=False), lo, hi)
              for n in mtrace.varnames}
    stats = {k: _stack(mtrace.get_sampler_stats(k, combine=False), lo, hi)
             for k in ("tree_size", "model_logp")}
    del mtrace

    # the program's logp+grad at the cell's batch, at each chain's last draw
    fn = model.logp_dlogp_function()
    q = np.zeros((traffic["chains"], fn.size), dtype=np.float64)
    for vm in model.ordering.vmap:
        q[:, vm.slc] = values[vm.var][:, -1].reshape(q.shape[0], -1)
    qt = torch.as_tensor(q, dtype=torch_floatX(), device=model.device)
    calls = traffic["logp_grad_calls"]
    for _ in range(2):
        fn(qt)
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(calls):
        logp_p, grad_p = fn(qt)
    _sync(device)
    logp_grad_ms = 1e3 * (time.perf_counter() - t0) / calls
    program_grad = {vm.var: grad_p[:, vm.slc].double().cpu().numpy()
                    .reshape((q.shape[0],) + tuple(vm.shp))
                    for vm in model.ordering.vmap}
    points = {vm.var: values[vm.var][:, -1] for vm in model.ordering.vmap}
    memory_peak = (torch.cuda.max_memory_allocated()
                   if device != "cpu" else 0)
    events = tracer.reduce() if tracer is not None else None
    del fn, qt, logp_p, grad_p, model
    if device != "cpu":
        torch.cuda.empty_cache()

    ess = {v: bulk_ess(values[v]) for v in cfg["gated"]}
    ctx = SimpleNamespace(
        cfg=cfg, traffic=traffic, chains=traffic["chains"],
        window_draws=hi - lo, window_s=window_s, setup_s=setup_s,
        tree_size=stats["tree_size"], ess=ess,
        ess_min=min(ess.values()), logp_grad_ms=logp_grad_ms,
        work=config.work(cfg, traffic["chains"]), dtype=cfg["precision"],
        config=config, events=events)

    judged = SimpleNamespace(
        cfg=cfg, values=values, model_logp=stats["model_logp"],
        points=points, program_grad=program_grad, seed=seed, device=device, limits=cell.limits)
    if keep is not None:
        keep["judged"] = judged
    checks = config.check(judged)
    attempted = ctx.chains * ctx.window_draws
    bad = ~np.isfinite(stats["model_logp"])
    for v in values.values():
        bad |= ~np.isfinite(v.reshape(v.shape[0], v.shape[1], -1)).all(-1)
    failed = int(bad.sum())
    correct = bool(ctx.window_draws > 0 and failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks))

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = metric_reader(m["name"], cell.pkg).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": _device(device, cell.chips,
                                                    memory_peak)}
    if events is not None:
        summary = devtrace.breakdown(events)
        result["device"]["busy_s"] = summary["busy_s"]
        result["device"]["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = checks
    return result


def _sync(device):
    if device != "cpu":
        import torch
        torch.cuda.synchronize()


def _device(device, chips, memory_peak):
    import torch
    if device == "cpu":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": memory_peak}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips, "memory_peak_bytes": int(memory_peak)}
