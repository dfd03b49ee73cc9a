"""The port's multi-device chain parallelism (``pymc3_tpu_torch.parallel``)
against the JAX package's and against one process over every chain.

The port's ranks are CPU processes of one gloo group, started by
``parallel.launch`` (``tests/torch_parallel_jobs.py`` is their side); the
JAX side runs here on two devices of the root conftest's 8-device CPU mesh.
One 2-rank job serves every case that shares its models; every launch has
a timeout of at most 120 s.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.parallel import CHAIN_AXIS, LOCAL_CHAIN_AXIS, pooled_axes
from pymc3_tpu.step_methods.hmc import quadpotential as jqp
from pymc3_tpu_torch import parallel
from pymc3_tpu_torch.step_methods.hmc import nuts as tnuts
from pymc3_tpu_torch.variational.opvi import value_and_grad
from pymc3_tpu_torch.variational.updates import tree_map

from . import torch_parallel_jobs as jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 120


def _launch(job, nprocs, where):
    parallel.launch(["-m", "tests.torch_parallel_jobs", job, str(where)],
                    nprocs, devices=["cpu"] * nprocs, backend="gloo",
                    timeout=TIMEOUT, cwd=REPO)
    return [torch.load(os.path.join(where, f"rank{r}.pt"),
                       weights_only=False) for r in range(nprocs)]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The 2-rank job: merges, the rescue, NUTS transitions, eight-schools
    sharded and resumed, SMC and ADVI (``torch_parallel_jobs.pair``)."""
    return _launch("pair", 2, tmp_path_factory.mktemp("pair"))


@pytest.fixture(scope="module")
def divide(tmp_path_factory):
    return _launch("divide", 4, tmp_path_factory.mktemp("divide"))


def _jax_merged(kind):
    """The JAX package's psum merge of each chain's accumulator under
    ``shard_map`` on two devices, the chains vmapped within each."""
    data = jnp.asarray(jobs.welford_data())
    n = data.shape[-1]
    init, add, merge = (
        (jqp.welford_init, jqp.welford_add, jqp.welford_merge_psum)
        if kind == "diag" else
        (jqp.welford_cov_init, jqp.welford_cov_add,
         jqp.welford_cov_merge_psum))

    def chain(xs):
        st, _ = jax.lax.scan(lambda s, x: (add(s, x), None), init(n), xs)
        return merge(st, pooled_axes(CHAIN_AXIS))

    mesh = Mesh(np.asarray(jax.devices()[:2]), (CHAIN_AXIS,))
    run = jax.shard_map(jax.vmap(chain, axis_name=LOCAL_CHAIN_AXIS),
                        mesh=mesh, in_specs=P(CHAIN_AXIS),
                        out_specs=P(CHAIN_AXIS), check_vma=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(run)(data))


@pytest.mark.parametrize("kind", ["diag", "dense", "diag_psum",
                                  "dense_psum"])
def test_welford_merge_over_ranks_matches_jax_psum(pair, kind):
    """2 ranks x 4 chains merged over the group equal the JAX psum over
    2 devices x 4 vmapped chains, on every chain (float32; rtol 2e-5,
    atol 1e-5: the port sums in float64, JAX in float32). ``_psum``: the
    port's ``welford_merge_psum``/``welford_cov_merge_psum`` over
    ``pooled_axes(CHAIN_AXIS)``, the JAX package's names."""
    want = _jax_merged(kind.split("_")[0])
    for field in ("w", "mean", "m2"):
        got = np.concatenate([np.broadcast_to(
            getattr(r[kind], field).numpy(),
            (4,) + getattr(r[kind], field).shape[1:]) for r in pair])
        np.testing.assert_allclose(got, getattr(want, field), rtol=2e-5,
                                   atol=1e-5, err_msg=field)


def test_rescue_takes_the_first_best_lane_by_global_index(pair):
    """The stuck lanes of both ranks jump to chain 5 (rank 1), as one
    process's rescue over the 8 chains has them do; exactly."""
    want = tnuts._rescue(*jobs.rescue_inputs())
    for got_field, want_field in zip(zip(*[r["rescue"] for r in pair]),
                                     want):
        assert torch.equal(torch.cat(got_field), want_field)
    assert torch.equal(want[0][2], jobs.rescue_inputs()[3][5])


@pytest.mark.parametrize("transition", [0, jobs.NUTS_TRANSITIONS - 1],
                         ids=["first", "thirtieth"])
def test_pooled_nuts_over_ranks_equals_one_process(pair, transition):
    """Pooled NUTS on 2 ranks x 4 chains, with the global chains' noise,
    against one process over the 8 chains: the step-size probe, then 30
    tuning transitions with windows of 10 (promotions at 10, 20, 30).
    Tolerance rtol = atol = 1e-6 (float32); the runs agree to the bit here,
    since the pooled sums run in float64 and a doubling goes on while a
    lane of either rank grows."""
    want = jobs.nuts_transitions(None)
    assert pair[0]["nuts"]["probe_eps"] == pair[1]["nuts"]["probe_eps"] \
        == want["probe_eps"]
    for k in ("q", "eps", "var", "log_step", "depth"):
        got = torch.cat([r["nuts"][transition][k] for r in pair])
        np.testing.assert_allclose(got.numpy(),
                                   want[transition][k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_sharded_sample_matches_the_jax_package_sharded(pair):
    """Eight-schools, 8 chains over 2 ranks, pooled (``devices`` and
    ``axis_name``), against the JAX package's ``sample(devices=2 devices,
    axis_name=...)``: means within 5 conservative MCSEs (ESS floor 200),
    sds within 50% (``test_parallel.py``'s comparison)."""
    with jobs.eight_schools(pj):
        want = pj.sample(draws=300, tune=300, chains=8, progressbar=False,
                         random_seed=42, devices=jax.devices()[:2],
                         axis_name=CHAIN_AXIS,
                         compute_convergence_checks=False)
    for var in ("mu", "tau"):
        a = np.asarray(want.get_values(var), dtype=np.float64)
        b = pair[0]["schools"][var].astype(np.float64)
        mcse = a.std() / np.sqrt(200.0)
        assert abs(a.mean() - b.mean()) < 5 * mcse, (var, a.mean(), b.mean())
        assert abs(a.std() - b.std()) < 0.5 * a.std()


def test_sharded_trace_is_the_same_on_every_rank(pair):
    for k, v in pair[0]["schools"].items():
        assert v.shape == (8, 300)
        assert np.array_equal(v, pair[1]["schools"][k]), k
    assert [sorted(w) for w in pair[0]["warm"]] == \
        [sorted(w) for w in pair[1]["warm"]]


def test_sharded_decode_roundtrip(pair):
    tau = pair[0]["schools"]["tau"]
    np.testing.assert_allclose(tau, np.exp(pair[0]["schools"]["tau_log__"]),
                               rtol=1e-5)
    assert np.all(tau > 0)


def test_sharded_resume_continues_with_the_checkpointed_step_size(pair):
    """``resume_from`` a sharded run, sharded again with ``tune=0``: each
    chain's first step size is its checkpoint's (the pooled one of the
    last draw), on both ranks (float32, rtol 1e-6)."""
    last = pair[0]["schools_step_size"][:, -1]
    for r in pair:
        np.testing.assert_allclose(r["resumed_step_size"][:, 0], last,
                                   rtol=1e-6)
    assert np.ptp(last) == 0.0


@pytest.mark.parametrize("axis_name", [
    None, CHAIN_AXIS, (CHAIN_AXIS,), (LOCAL_CHAIN_AXIS, CHAIN_AXIS),
    LOCAL_CHAIN_AXIS])
def test_pooled_axes_name_the_jax_packages_axes(axis_name):
    assert parallel.CHAIN_AXIS == CHAIN_AXIS
    assert parallel.LOCAL_CHAIN_AXIS == LOCAL_CHAIN_AXIS
    assert parallel.pooled_axes(axis_name) == pooled_axes(axis_name)


def test_sharded_file_backend_is_written_by_rank_zero_alone(pair):
    """``sample(devices=..., trace="text")`` on two ranks in one directory:
    rank 0 returns the text backend's traces, rank 1 the same draws in
    memory, and the files rank 0 wrote hold them (the text backend keeps
    float32 exactly)."""
    assert [r["text"]["backend"] for r in pair] == ["Text", "NDArray"]
    with jobs.eight_schools(pt) as model:
        loaded = pt.backends.text.load(pair[0]["text"]["dir"], model=model)
    assert sorted(loaded.chains) == list(range(8))
    for var in ("mu", "th"):
        got = np.asarray(loaded.get_values(var, combine=False))
        for r in pair:
            np.testing.assert_array_equal(r["text"]["values"][var], got)


@pytest.mark.parametrize("which", ["sample", "smc"])
def test_counts_that_do_not_divide_among_ranks_raise(divide, which):
    for r in divide:
        assert "must be a multiple of the device count" in r[which]


def test_sharded_smc_evidence(pair):
    """Beta-Bernoulli, 2048 particles over 2 ranks: the log evidence within
    1.0 of the closed form, as the JAX package's sharded test allows, and
    of the JAX package's run over 2 devices; the same on both ranks."""
    from scipy.special import betaln
    expected = betaln(51, 51) - betaln(1, 1)
    got = pair[0]["smc_lml"]
    assert got == pair[1]["smc_lml"]
    assert np.array_equal(pair[0]["smc_a"], pair[1]["smc_a"])
    assert pair[0]["smc_a"].shape[0] == 2048
    want = pj.sample_smc(2048, model=jobs.beta_bernoulli(pj), random_seed=2,
                         devices=jax.devices()[:2])
    assert abs(got - expected) < 1.0
    assert abs(want.report.log_marginal_likelihood - expected) < 1.0
    assert abs(got - want.report.log_marginal_likelihood) < 1.0


def test_sharded_advi_step_is_the_mean_of_the_ranks_gradients(pair):
    """One ``sharded_step_function`` step equals the optimizer applied to
    the mean of the two ranks' gradients on their own noise (rtol 1e-6,
    atol 1e-7, float32)."""
    approx = pt.MeanField(model=jobs.minibatch_model(pt))
    objective = pt.variational.operators.KL(approx)()
    _, opt = objective.step_function(obj_n_mc=2)
    loss = objective.loss_fn(2)
    params0 = pair[0]["advi"]["params"][0]
    grads = [value_and_grad(loss, params0, r["advi"]["noise"][0])[1]
             for r in pair]
    mean = tree_map(lambda a, b: (a + b) / 2, grads[0], grads[1])
    want, _ = opt.update(mean, opt.init(params0), params0)
    for r in pair:
        for k, leaf in want.items():
            for name in leaf:
                np.testing.assert_allclose(
                    r["advi"]["params"][1][k][name].numpy(),
                    leaf[name].numpy(), rtol=1e-6, atol=1e-7)


def test_sharded_advi_parameters_are_equal_on_every_rank(pair):
    a, b = (r["advi"]["params"][5] for r in pair)
    for k in a:
        for name in a[k]:
            assert torch.equal(a[k][name], b[k][name])
    assert np.isfinite(pair[0]["advi"]["loss"])


@pytest.mark.parametrize("nproc", [2, 4])
def test_multihost_sim(nproc):
    env = dict(os.environ, MULTIHOST_NPROC=str(nproc))
    proc = subprocess.run(
        [sys.executable, "-m", "pymc3_tpu_torch.parallel.multihost_sim"],
        env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "MULTIHOST SIM OK" in proc.stdout
    assert proc.stdout.count("sharded NUTS block ok") == nproc


def test_killed_rank_raises_remote_worker_error_naming_it():
    """Rank 1 raises between two blocks while rank 0 waits in a collective:
    ``launch`` terminates rank 0 and names rank 1, with its traceback."""
    env = dict(os.environ, MULTIHOST_FAIL_RANK="1")
    with pytest.raises(parallel.RemoteWorkerError) as info:
        parallel.launch(
            ["-m", "pymc3_tpu_torch.parallel.multihost_sim", "--rank"], 2,
            devices=["cpu"] * 2, backend="gloo", env=env, cwd=REPO,
            timeout=TIMEOUT)
    assert info.value.rank == 1
    assert "injected mid-block failure on rank 1" in str(info.value)


def test_dryrun_multichip_two_ranks():
    from pymc3_tpu_torch.parallel.dryrun import dryrun_multichip
    outs = dryrun_multichip(2, devices=["cpu"] * 2, timeout=TIMEOUT)
    assert all("ok" in o for o in outs)


def test_several_devices_outside_a_process_group_raise():
    model = jobs.eight_schools(pt)
    with pytest.raises(ValueError, match="one process each"):
        pt.sample(draws=5, tune=5, chains=2, model=model,
                  devices=["cpu", "cpu"], progressbar=False)
    with pytest.raises(ValueError, match="one process each"):
        pt.sample_smc(100, model=model, devices=["cpu", "cpu"])


def test_one_device_outside_a_process_group_is_this_process():
    """``devices`` of one device samples here, as without it."""
    model = jobs.eight_schools(pt)
    kw = dict(draws=5, tune=5, chains=2, model=model, progressbar=False,
              random_seed=1, compute_convergence_checks=False)
    a = pt.sample(devices=["cpu"], **kw)
    b = pt.sample(**kw)
    assert np.array_equal(a.get_values("mu"), b.get_values("mu"))


# -- the JAX package's signatures ----------------------------------------------
@pytest.mark.parametrize("name", ["initialize_distributed", "make_mesh",
                                  "shard_chain_fn", "shard_block_fn"])
def test_parameters_start_with_the_jax_packages(name):
    """The JAX parameters come first, in order, under the same names; the
    port's own ``torch.distributed`` ones follow."""
    import inspect
    from pymc3_tpu import parallel as jparallel
    want = list(inspect.signature(getattr(jparallel, name)).parameters)
    got = list(inspect.signature(getattr(parallel, name)).parameters)
    assert got[:len(want)] == want


def test_make_mesh_names_its_axis_as_the_jax_packages():
    from pymc3_tpu import parallel as jparallel
    want = jparallel.make_mesh(jax.devices()[:1], axis_name="rows")
    got = parallel.make_mesh(["cpu"], axis_name="rows")
    assert got.axis_names == tuple(want.axis_names)
    assert parallel.make_mesh(["cpu"]).axis_names == (CHAIN_AXIS,)


@pytest.mark.parametrize("call", [
    lambda f: parallel.shard_chain_fn(f, "chains"),
    lambda f: parallel.shard_chain_fn(f, axis_name="chains",
                                      devices=["cpu"]),
    lambda f: parallel.shard_chain_fn(f, mesh=parallel.make_mesh(["cpu"])),
], ids=["axis_name", "devices", "mesh"])
def test_shard_chain_fn_with_the_jax_arguments_in_one_process(call):
    """``shard_chain_fn(f, "chains")`` is the JAX call: one process is
    every chain."""
    q = torch.arange(12.0).reshape(4, 3)
    out = call(lambda x: (x * 2, x.sum(1)))(q)
    torch.testing.assert_close(out[0], q * 2)
    torch.testing.assert_close(out[1], q.sum(1))


def test_shard_block_fn_with_the_jax_arguments_in_one_process():
    carry = torch.arange(6.0).reshape(3, 2)
    idxs = torch.arange(4)
    for run in (parallel.shard_block_fn(lambda c, i: (c + len(i), c * 0)),
                parallel.shard_block_fn(lambda c, i: (c + len(i), c * 0),
                                        ["cpu"]),
                parallel.shard_block_fn(lambda c, i: (c + len(i), c * 0),
                                        mesh=parallel.make_mesh())):
        new, out = run(carry, idxs)
        torch.testing.assert_close(new, carry + 4)
        assert out.shape == carry.shape


def test_a_mesh_in_the_axis_name_slot_raises():
    with pytest.raises(TypeError, match="mesh="):
        parallel.shard_chain_fn(lambda x: x, parallel.make_mesh(["cpu"]))


def test_initialize_distributed_takes_the_jax_arguments():
    """``initialize_distributed(coordinator_address, num_processes,
    process_id)`` joins a one-rank gloo group through a TCP store on
    localhost, in a fresh process."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    code = ("from pymc3_tpu_torch import parallel\n"
            f"m = parallel.initialize_distributed('127.0.0.1:{port}', 1, 0, "
            "backend='gloo', device='cpu')\n"
            "print('mesh', m.world_size, m.rank, m.backend, m.axis_names)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=TIMEOUT)
    assert out.returncode == 0, out.stderr
    assert "mesh 1 0 gloo ('chains',)" in out.stdout
