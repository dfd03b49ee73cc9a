"""The benchmark's cell cut to a size the CPU runs in seconds, for the
tests: 8 chains, 30 tuning draws, blocks of 2 draws."""
from portbench.harness import ROOT, load_cell, load_json

SMALL_TRAFFIC = {"chains": 8, "tune": 30, "block_size": 2,
                 "logp_grad_calls": 2, "trace_seconds": 1}
SMALL_ARGS = ["--chains", "8", "--tune", "30", "--block-size", "2",
              "--device", "cpu"]


def small_cell(workload, bench=None, **kwargs):
    cell = load_cell(bench or load_json(ROOT / "BENCHMARK.json"), workload,
                     **kwargs)
    cell.traffic = dict(cell.traffic, **SMALL_TRAFFIC)
    return cell


def run_small(cell, seed=2147483901, seconds=1.5, trace=False, **kwargs):
    from portbench.harness import run_cell
    return run_cell(cell, seed, seconds, trace, "cpu", 0.0, lambda m: None,
                    **kwargs)
