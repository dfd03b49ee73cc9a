"""Readings that set the limits of ``correct``, run on the card apart from
the benchmark's own runs:

    python3 -m portbench.readings --workload <name> --seeds 11 12 13 \\
        --seconds <s> [--control] [--tune N] [--chains N] [--trace]

runs the cell once for each seed in one process and prints one JSON line a
run: the numbers compared (the lower readings) and the metrics. With
``--control`` it also prints, on the same window, the numbers that the
configuration's ``control`` gives (the reference in the precision below
the configuration's, put in the program's place) and those of its
``frozen`` window, as a transition that returns its state unchanged would
leave it, for every chain (``unchanged``) and for half of them
(``half``). ``--tune``, ``--chains`` and ``--block-size`` override the
traffic, for the sweeps that chose it and for runs on the CPU at a small
size.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT, load_cell, load_json, run_cell  # noqa: E402
from .run import configure_env, forbidden_modules  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--tune", type=int)
    p.add_argument("--chains", type=int)
    p.add_argument("--block-size", type=int)
    p.add_argument("--trace", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    cell = load_cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    for key in ("tune", "chains", "block_size"):
        if getattr(args, key) is not None:
            cell.traffic = dict(cell.traffic, **{key: getattr(args, key)})
    configure_env(cell.cfg)
    import torch
    t0 = T_PROCESS
    for seed in args.seeds:
        keep = {}
        if args.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        result = run_cell(cell, seed, args.seconds, args.trace, args.device,
                          t0, lambda m: print(m, file=sys.stderr, flush=True),
                          keep=keep)
        line = {"workload": args.workload, "seed": seed,
                "precision": cell.cfg["precision"],
                "tune": cell.traffic["tune"], "chains": cell.traffic["chains"],
                "correct": result["correct"],
                "numbers": {c["name"]: c["value"] for c in result["checks"]},
                "metrics": {k: v["value"] for k, v in
                            result["metrics"].items()},
                "device": result["device"],
                "breakdown": result.get("breakdown")}
        if args.control:
            j = keep["judged"]
            t1 = time.perf_counter()
            line["control"] = cell.config.control(
                j.values, j.model_logp, j.points, j.program_grad, seed,
                args.device)
            line["control_s"] = time.perf_counter() - t1
            for name, share in (("unchanged", 1.0), ("half", 0.5)):
                v, lp = cell.config.frozen(j.values, j.model_logp, share)
                line[name] = cell.config.numbers(
                    v, lp, j.points, j.program_grad, args.device)
                del v, lp
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        t0 = time.perf_counter()
    print(json.dumps({"forbidden_modules": forbidden_modules()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
