"""The harness on the CPU at small sizes: files found by name, the result
line, no fallback to the CPU, the control and the faults that the
comparison has to catch, and the modules a run loads."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import peaks
from portbench.harness import PKG, ROOT, load_cell, load_json
from portbench.run import FORBIDDEN, forbidden_modules
from portbench.tests.small import SMALL_ARGS, run_small, small_cell

BENCH = load_json(ROOT / "BENCHMARK.json")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env.pop("JAX_PLATFORMS", None)
    return env


@pytest.mark.parametrize("workload", WORKLOADS)
def test_every_file_of_a_cell_is_found_by_name(workload):
    cell = load_cell(BENCH, workload)
    w = {x["name"]: x for x in BENCH["workloads"]}[workload]
    assert cell.cfg["name"] == w["config"]
    assert cell.config.__file__.endswith(f"configs/{w['config']}.py")
    for key in ("chains", "tune", "draws", "target_accept"):
        assert key in cell.traffic
    assert set(cell.limits) == {c for c in cell.limits}
    for m in cell.end_to_end + cell.per_layer:
        assert (PKG / "metrics" / f"{m['name']}.py").exists()


def test_a_cell_and_a_metric_are_added_by_files_and_entries_only(tmp_path):
    pkg = tmp_path / "portbench"
    shutil.copytree(PKG, pkg, ignore=shutil.ignore_patterns("tests",
                                                            "__pycache__"))
    (pkg / "traffic" / "nuts.c4.json").write_text(json.dumps(
        dict(load_json(PKG / "traffic" / "nuts.c65536.json"), chains=4)))
    (pkg / "limits" / "radon.nuts.c4.json").write_text(
        (PKG / "limits" / "radon.nuts.c65536.json").read_text())
    (pkg / "metrics" / "extra.chains.py").write_text(
        "def read(ctx):\n    return ctx.chains\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "radon.nuts.c4", "config": "radon",
                               "traffic": "nuts.c4", "chips": 1,
                               "why": "a test cell"})
    bench["end_to_end"].append({"name": "extra.chains", "unit": "chains",
                                "better": "higher", "bound": 0.01,
                                "source": "host_clock",
                                "workloads": ["radon.nuts.c4"]})
    cell = small_cell("radon.nuts.c4", bench=bench, pkg=pkg)
    cell.traffic = dict(cell.traffic, chains=4)
    result = run_small(cell)
    assert result["metrics"]["extra.chains"]["value"] == 4
    assert "extra.chains" not in [m["name"] for m in load_cell(
        bench, "radon.nuts.c65536", pkg=pkg).end_to_end]


@pytest.mark.parametrize("trace", [False, True])
def test_result_line_keys(trace):
    """The keys the driver reads, then the numbers compared beside their
    limits, last, as the benchmark's contract asks."""
    cell = small_cell(WORKLOADS[0])
    result = run_small(cell, trace=trace)
    want = KEYS + (["breakdown"] if trace else []) + ["checks"]
    assert list(result) == want
    assert isinstance(result["correct"], bool)
    names = [m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)]
    if trace:
        # no card here: the device reader finds nothing to read
        names = [n for n in names if n != "device_idle"]
        assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["metrics"]) == set(names)
    assert [c["name"] for c in result["checks"]] == list(cell.limits)
    for c in result["checks"]:
        assert set(c) == {"name", "value", "limit"}


def test_a_run_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is here")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", WORKLOADS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=300)
    assert out.returncode == 2
    assert out.stdout.strip() == ""
    assert "no result" in out.stderr


def test_forbidden_names_are_compared_whole():
    assert forbidden_modules(["pymc3_tpu_torch", "pymc3_tpu_torch.model",
                              "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["pymc3_tpu.model", "jax.numpy", "jaxlib",
                              "flax"]) == sorted(FORBIDDEN)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_loads_neither_jax_nor_the_jax_package(workload):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.readings", "--workload", workload,
         "--seeds", "7", "--seconds", "1"] + SMALL_ARGS,
        cwd=ROOT, env=_env(), capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "forbidden_modules": []}


def test_the_reference_imports_nothing_of_the_program():
    code = ("import sys, portbench.reference.radon; "
            "print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'pymc3_tpu_torch', 'pymc3_tpu', "
            "'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr


# -- the control and the faults -------------------------------------------

def _fault(kind):
    """A NUTS transition broken as ``kind`` says, from the window's first
    draw on (tuning runs sound): every chain's state returned unchanged
    (``unchanged``) or half of the chains' (``half``), each with the
    density of the point it keeps, so that the recorded numbers agree with
    the draws; or a coordinate of each returned point moved by 0.1 after
    its density was recorded (``altered``)."""
    def wrap(step):
        def broken(self, q, state, tctx, noise):
            q2, s2, stats = step(self, q, state, tctx, noise)
            if tctx.tune:
                return q2, s2, stats
            if kind in ("unchanged", "half"):
                h = 0 if kind == "unchanged" else q.shape[0] // 2
                q2 = torch.cat([q2[:h], q[h:]])
                s2 = s2._replace(
                    q=torch.cat([s2.q[:h], state.q[h:]]),
                    logp=torch.cat([s2.logp[:h], state.logp[h:]]),
                    grad=torch.cat([s2.grad[:h], state.grad[h:]]))
                stats = dict(stats, model_logp=s2.logp)
                return q2, s2, stats
            q2 = q2.clone()
            q2[:, 0] += 0.1
            return q2, s2, stats
        return broken
    return wrap


FAULT_NUMBER = {"unchanged": "still_share", "half": "still_share",
                "altered": "logp_gap"}


@pytest.mark.parametrize("workload", WORKLOADS)
@pytest.mark.parametrize("kind", ["unchanged", "half", "altered"])
def test_a_broken_step_is_not_correct(workload, kind):
    """Each fault a single-card sampler can have (no exchange between
    cards here) turns ``correct`` false through the number that sees it,
    which a sound run at the same size passes."""
    cell = small_cell(workload)
    name = FAULT_NUMBER[kind]
    sound = {c["name"]: c for c in run_small(cell, seconds=3.0)["checks"]}
    assert sound[name]["value"] <= sound[name]["limit"]
    result = run_small(cell, seconds=3.0, break_step=_fault(kind))
    assert result["correct"] is False
    got = {c["name"]: c for c in result["checks"]}
    assert got[name]["value"] > got[name]["limit"]


@pytest.mark.parametrize("share, want", [(1.0, 1.0), (0.5, 0.5)])
def test_a_frozen_window_reads_as_still(share, want):
    """The fault readings taken on the card: the window's draws with the
    first ``share`` of the chains held at their first window draw."""
    cell = small_cell(WORKLOADS[0])
    keep = {}
    run_small(cell, seconds=3.0, keep=keep)
    j = keep["judged"]
    values, lp = cell.config.frozen(j.values, j.model_logp, share)
    got = cell.config.numbers(values, lp, j.points, j.program_grad, "cpu")
    assert got["still_share"] == pytest.approx(want)
    assert got["logp_gap"] <= cell.limits["logp_gap"]
    assert cell.config.still_share(j.values) < want


def test_radon_control_fails_where_the_program_passes():
    """bfloat16, the precision below radon's float32, put in the program's
    place fails the density, gradient and transform numbers that the
    program passes at the same window."""
    cell = small_cell("radon.nuts.c65536")
    keep = {}
    result = run_small(cell, keep=keep)
    j = keep["judged"]
    program = {c["name"]: c["value"] for c in result["checks"]}
    control = cell.config.control(j.values, j.model_logp, j.points,
                                  j.program_grad, 5, "cpu")
    for name in ("logp_gap", "grad_gap", "transform_gap"):
        assert program[name] <= cell.limits[name] < control[name]


# -- work counts against hand counts ----------------------------------------

def test_radon_work_count():
    cell = load_cell(BENCH, "radon.nuts.c65536")
    w = cell.config.work(cell.cfg, 2)
    assert w["flops"] == 2 * (14 * 919 + 6 * 175)
    assert w["bytes"] == 4 * (2 * 351 + 3 * 919)
    w = cell.config.work(cell.cfg, 65536)
    assert w["bytes"] == 92_023_572
    assert peaks.least_seconds(w) == pytest.approx(92_023_572 / 3.35e12)


@pytest.mark.chip
def test_each_cell_runs_correct_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for workload in WORKLOADS:
        out = subprocess.run(
            [sys.executable, "-m", "portbench.run", "--workload", workload,
             "--seed", "2147483911", "--seconds", "10", "--trace", "0"],
            cwd=ROOT, env=_env(), capture_output=True, text=True,
            timeout=1200)
        assert out.returncode == 0, out.stderr[-2000:]
        assert json.loads(out.stdout.splitlines()[-1])["correct"] is True
