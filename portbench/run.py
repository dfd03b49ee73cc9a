"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``pymc3_tpu_torch``. The cell's
configuration, traffic, limits and metrics are found by name from
``BENCHMARK.json``. The run needs as many CUDA cards as the cell asks for
and exits with 2, printing no result, where there are fewer. With
``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and traced seconds
and the breakdown. The last lines on standard error, and the result's
last key, give each number compared beside its limit.
"""
from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from .harness import ROOT, load_cell, load_json, run_cell  # noqa: E402

# modules that a run of the port must not load: the JAX stack and the JAX
# package, compared by whole top-level name (the port's own name begins
# with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "pymc3_tpu")


def forbidden_modules(modules=None):
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def configure_env(cfg, root=ROOT):
    """The precision before the port is imported, and every build and
    kernel cache at a fixed path inside the checkout."""
    os.environ["PYMC3_TPU_FLOATX"] = cfg["precision"]
    cache = root / "build" / "portbench_cache"
    for key, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[key] = str(cache / sub)


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    bench = load_json(ROOT / "BENCHMARK.json")
    cell = load_cell(bench, args.workload)
    configure_env(cell.cfg)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"{args.workload} needs {cell.chips} CUDA card(s); torch finds "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
             ": no result")
        return 2
    try:
        import pymc3_tpu_torch  # noqa: F401
    except ImportError as e:
        _log(f"the port pymc3_tpu_torch is not in this checkout ({e}): "
             "no result")
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      "cuda", T_PROCESS, _log)
    found = forbidden_modules()
    if found:
        _log(f"the run loaded {found}, which the port must not load: "
             "no result")
        return 3
    for c in result["checks"]:
        _log(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
