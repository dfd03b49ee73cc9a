"""The port's ``sample()`` end to end on the CPU: GP regression at n = 20,
4 chains, against a JAX-package run of the same model and seed.

Random streams differ between the packages (Philox against threefry), so
the posteriors are compared by ``scripts/bench_suite.py::moment_check``:
|Δmean| / combined MCSE < 4 and sds within 20%.
"""
import os
import sys

import numpy as np
import pytest
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt

from .torch_models import gp_model

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))
from bench_suite import moment_check, posterior_moments  # noqa: E402

torch.set_num_threads(2)
NAMES = ["ls", "eta", "sigma"]
CFG = dict(draws=250, tune=250, chains=4, random_seed=5, progressbar=False,
           compute_convergence_checks=False)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture(scope="module")
def traces():
    jax_trace = pj.sample(model=gp_model(pj, n=20), **CFG)
    port_trace = pt.sample(model=gp_model(pt, n=20), **CFG)
    return jax_trace, port_trace


def test_gp_posterior_matches_jax_package(traces):
    jax_trace, port_trace = traces
    check = moment_check(posterior_moments(pt, port_trace, NAMES),
                         posterior_moments(pj, jax_trace, NAMES))
    assert check["pass"], check


def test_trace_layout_and_diagnostics(traces):
    _, tr = traces
    assert tr.nchains == 4 and len(tr) == CFG["draws"]
    assert tr["ls"].shape == (4 * CFG["draws"],)
    assert set(tr.stat_names) == set(pt.NUTS.stats_dtypes[0])
    assert not tr.get_sampler_stats("tune").any()
    rhat = pt.rhat(tr, var_names=NAMES)
    ess = pt.ess(tr, var_names=NAMES)
    for v in NAMES:
        assert np.isfinite(rhat[v]) and rhat[v] < 1.1
        assert ess[v] > 100
    assert list(pt.summary(tr, var_names=NAMES).index) == NAMES


def test_trace_list_and_record_stats():
    tr = pt.sample(model=gp_model(pt, n=20), draws=20, tune=20, chains=2,
                   random_seed=1, progressbar=False,
                   compute_convergence_checks=False, trace=["ls"],
                   record_stats=["depth"])
    assert tr.varnames == ["ls"]
    assert tr.stat_names == {"depth", "diverging"}
    assert tr.get_sampler_stats("depth").shape == (40,)


def test_same_seed_same_draws():
    kw = dict(draws=5, tune=5, chains=2, random_seed=3, progressbar=False,
              compute_convergence_checks=False)
    a = pt.sample(model=gp_model(pt, n=20), **kw)
    b = pt.sample(model=gp_model(pt, n=20), **kw)
    np.testing.assert_array_equal(a["ls"], b["ls"])


# -- the report's warnings and sample()'s keywords ---------------------------
def _normal_model(pm):
    with pm.Model() as m:
        pm.Normal("mu", 0.0, 1.0)
        pm.HalfNormal("sigma", 1.0)
    return m


def test_treedepth_warning_per_chain_at_the_cap():
    """A depth cap of 1 is reached by every draw: each chain warns."""
    from pymc3_tpu_torch.backends.report import WarningType
    tr = pt.sample(draws=30, tune=10, chains=2, model=_normal_model(pt),
                   random_seed=2, progressbar=False,
                   compute_convergence_checks=False,
                   nuts={"max_treedepth": 1})
    for chain in tr.chains:
        kinds = [w.kind for w in tr.report._chain_warnings.get(chain, [])]
        assert WarningType.TREEDEPTH in kinds, kinds


def test_bad_energy_warning_names_the_offending_term():
    """``tests/test_inferencedata.py:50-70`` on the port's trace."""
    from pymc3_tpu_torch.backends.base import MultiTrace
    from pymc3_tpu_torch.backends.ndarray import NDArray
    from pymc3_tpu_torch.backends.report import SamplerReport, WarningType
    from pymc3_tpu_torch.sampling import _attach_sample_stats_warnings
    m = _normal_model(pt)
    strace = NDArray(model=m)
    strace.setup(3, 0, [{"model_logp": np.float64, "diverging": bool,
                         "depth": np.int64}])
    pts = [m.test_point, m.test_point,
           {"mu": np.array(np.nan, np.float32),
            "sigma_log__": np.array(0.0, np.float32)}]
    for pt_ in pts:
        strace.record(pt_, [{"model_logp": m.logp(pt_), "diverging": False,
                             "depth": 1}])
    mtrace = MultiTrace([strace])
    mtrace._report = SamplerReport()
    step = pt.NUTS(model=m)
    _attach_sample_stats_warnings(mtrace, step, 0, m)
    bad = [w for w in mtrace.report._chain_warnings.get(0, [])
           if w.kind == WarningType.BAD_ENERGY]
    assert bad and "mu" in bad[0].message and "sigma" not in bad[0].message
    assert bad[0].step == 2


def test_sample_accepts_the_jax_packages_keywords():
    calls = []
    tr = pt.sample(draws=12, tune=8, chains=2, model=_normal_model(pt),
                   random_seed=1, progressbar=False, block_size=5,
                   mp_ctx="spawn", pickle_backend="dill",
                   callback=lambda trace, draw: calls.append(draw),
                   compute_convergence_checks=False)
    assert len(tr) == 12
    assert [d.draw_idx for d in calls] == [5, 10, 15, 20]
    assert calls[-1].is_last and not calls[0].is_last
    assert calls[0].tuning and not calls[-1].tuning


def test_callback_can_cancel_with_a_partial_trace():
    """``tests/test_sampling_args.py:160-185``: a KeyboardInterrupt from
    the callback ends the run at a block's end."""
    def cancel(trace, draw):
        if draw.draw_idx >= 5:
            raise KeyboardInterrupt()
    m = _normal_model(pt)
    tr = pt.sample(draws=20, tune=0, chains=1, model=m, step=pt.Metropolis(
        model=m), progressbar=False, random_seed=1, block_size=5,
        callback=cancel, compute_convergence_checks=False)
    assert len(tr) == 5
    with pytest.raises(KeyboardInterrupt):
        pt.sample(draws=20, tune=10, chains=1, model=m,
                  step=pt.Metropolis(model=m), progressbar=False,
                  random_seed=1, block_size=5, callback=cancel,
                  compute_convergence_checks=False)


@pytest.mark.parametrize("name,value,slice_", [
    ("devices", ["cpu", "cpu"], "one process each")])
def test_later_keywords_name_their_slice(name, value, slice_):
    """``devices`` is ported (``test_torch_parallel.py``); outside a
    process group more than one device raises, naming the way to start one
    process per device."""
    with pytest.raises(ValueError, match=slice_):
        pt.sample(draws=5, tune=5, model=_normal_model(pt), progressbar=False,
                  **{name: value})


class TestWarmResume:
    """``tests/test_sampling_args.py::TestWarmResume`` on the port: a run
    continued with ``resume_from`` and ``tune=0`` starts from each chain's
    checkpointed kernel state (step size and mass matrix), also after
    ``save_trace``/``load_trace``."""

    KW = dict(progressbar=False, compute_convergence_checks=False)

    @pytest.fixture(scope="class")
    def first(self):
        model = _normal_model(pt)
        return model, pt.sample(draws=40, tune=80, chains=4, model=model,
                                random_seed=1, **self.KW)

    @staticmethod
    def _eps(trace, at):
        return np.asarray(trace.get_sampler_stats(
            "step_size", combine=False))[:, at]

    def test_resume_carries_the_step_size(self, first):
        model, tr1 = first
        tr2 = pt.sample(draws=30, tune=0, chains=4, model=model,
                        random_seed=2, resume_from=tr1, **self.KW)
        np.testing.assert_allclose(self._eps(tr2, 0), self._eps(tr1, -1),
                                   rtol=1e-6)
        assert len(tr2) == 30

    def test_resume_carries_the_mass_matrix(self, first):
        """With ``tune=0`` the potential's variance does not move: the
        resumed run's own checkpoint holds the first run's."""
        model, tr1 = first
        tr2 = pt.sample(draws=10, tune=0, chains=4, model=model,
                        random_seed=2, resume_from=tr1, **self.KW)
        var1 = _diag(tr1)
        np.testing.assert_array_equal(_diag(tr2), var1)
        assert not np.allclose(var1, 1.0)

    def test_resume_after_save_and_load(self, first, tmp_path):
        model, tr1 = first
        loaded = pt.load_trace(pt.save_trace(tr1, str(tmp_path / "ckpt")),
                               model=model)
        tr2 = pt.sample(draws=20, tune=0, chains=4, model=model,
                        random_seed=4, resume_from=loaded, **self.KW)
        np.testing.assert_allclose(self._eps(tr2, 0), self._eps(tr1, -1),
                                   rtol=1e-6)
        np.testing.assert_array_equal(_diag(tr2), _diag(tr1))

    def test_resume_chain_count_mismatch_raises(self, first):
        model, tr1 = first
        with pytest.raises(ValueError, match="chains"):
            pt.sample(draws=10, tune=0, chains=8, model=model,
                      resume_from=tr1, **self.KW)

    def test_a_trace_without_every_free_variable_cannot_resume(self, first):
        model, _ = first
        tr = pt.sample(draws=5, tune=5, chains=2, model=model, random_seed=1,
                       trace=["mu"], **self.KW)
        with pytest.raises(ValueError, match="sigma_log__"):
            pt.sample(draws=5, tune=0, chains=2, model=model,
                      resume_from=tr, **self.KW)

    def test_a_mismatched_checkpoint_warns_and_starts_fresh(self, first,
                                                            caplog):
        """A checkpoint of NUTS given to a Metropolis run: the JAX
        package's warning, and the fresh state."""
        model, tr1 = first
        with caplog.at_level("WARNING", logger="pymc3_tpu_torch"):
            tr2 = pt.sample(draws=5, tune=0, chains=4, model=model,
                            step=pt.Metropolis(model=model), random_seed=3,
                            resume_from=tr1, **self.KW)
        assert any("does not match the current kernel state" in r.message
                   for r in caplog.records)
        assert len(tr2) == 5 and tr2.nchains == 4

    def test_a_trace_without_checkpoints_resumes_from_its_points(self,
                                                                 caplog):
        model = _normal_model(pt)
        points = [{"mu": np.float32(0.2), "sigma_log__": np.float32(0.1)}]
        tr = pt.point_list_to_multitrace(points, model=model)
        with caplog.at_level("WARNING", logger="pymc3_tpu_torch"):
            tr2 = pt.sample(draws=5, tune=5, model=model, random_seed=3,
                            resume_from=tr, **self.KW)
        assert tr2.nchains == 1
        assert any("no warmup-state checkpoint" in r.message
                   for r in caplog.records)


def _diag(trace):
    """Each chain's adapted mass-matrix diagonal, from its checkpoint: the
    tensor of the NUTS state that holds the potential's ``var``."""
    from torch.utils._pytree import tree_flatten
    from pymc3_tpu_torch.sampling import checkpoint_leaves
    model = trace._straces[0].model
    state = pt.NUTS(model=model).kernel_init(torch.zeros(1, model.ndim))
    index = next(i for i, leaf in enumerate(tree_flatten(state)[0])
                 if leaf is state.pot.var)
    return checkpoint_leaves(state, [trace._straces[c].warmup_state
                                     for c in trace.chains])[index]


def test_return_inferencedata_gives_the_jax_packages_groups():
    """``tests/test_inferencedata.py::test_return_inferencedata`` on the
    port, with ``idata_kwargs``."""
    with pt.Model() as model:
        mu = pt.Normal("mu", 0.0, 1.0)
        sigma = pt.HalfNormal("sigma", 1.0)
        pt.Normal("y", mu, sigma, observed=np.array([0.1, -0.3, 0.5, 0.2]))
    idata = pt.sample(draws=30, tune=30, chains=2, model=model,
                      random_seed=1, progressbar=False,
                      compute_convergence_checks=False,
                      return_inferencedata=True,
                      idata_kwargs={"log_likelihood": True})
    assert idata.groups() == ["posterior", "sample_stats", "log_likelihood",
                              "observed_data"]
    assert np.asarray(idata.posterior["mu"]).shape == (2, 30)
    assert "sigma_log__" not in idata.posterior
    assert "acceptance_rate" in idata.sample_stats
    assert np.asarray(idata.log_likelihood["y"]).shape == (2, 30, 4)
    np.testing.assert_allclose(np.asarray(idata.observed_data["y"]),
                               [0.1, -0.3, 0.5, 0.2], rtol=1e-6)
    assert idata.report is not None
