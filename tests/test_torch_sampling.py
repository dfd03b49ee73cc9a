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
