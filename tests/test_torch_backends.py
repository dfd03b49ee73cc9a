"""The port's trace backends against the JAX package's, on the CPU.

Round trips of ``NDArray`` (``save_trace``/``load_trace`` with sampler
statistics and the warmup-state checkpoint), ``Text``, ``SQLite`` and
``HDF5``; ``merge_traces``, ``point_list_to_multitrace``, ``add_values``
and ``remove_values``. Files written by one package load in the other:
a ``save_trace`` directory (values and statistics) and a ``Text``
directory. ``trace_to_dataframe``'s columns and ``to_inference_data``'s
groups equal the JAX package's. Values read back exactly: npz, SQLite's
blobs and HDF5 keep the bytes, and the text files hold each float's
shortest repr, which reads back to the same float.
"""
import os
import warnings

import numpy as np
import pytest
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.backends import text as jtext
from pymc3_tpu_torch.backends import text as ttext
from pymc3_tpu_torch.backends.sqlite import SQLite, load as sqlite_load
from pymc3_tpu_torch.backends.hdf5 import HDF5, load as hdf5_load
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)


def _model(pm):
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 1.0, shape=2)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Deterministic("mu2", mu * 2.0)
        pm.Normal("y", mu[0] + mu[1], sigma,
                  observed=np.array([0.3, -0.1, 0.6, 0.2]))
    return model


@pytest.fixture(scope="module")
def sampled():
    model = _model(pt)
    trace = pt.sample(draws=25, tune=30, chains=3, model=model,
                      random_seed=4, progressbar=False,
                      compute_convergence_checks=False)
    return model, trace


def _same_values(a, b, names):
    assert a.nchains == b.nchains and len(a) == len(b)
    for name in names:
        for c in a.chains:
            np.testing.assert_array_equal(
                np.asarray(b.get_values(name, chains=[c])),
                np.asarray(a.get_values(name, chains=[c])))


def _same_stats(a, b):
    assert a.stat_names == b.stat_names
    for name in a.stat_names:
        np.testing.assert_array_equal(b.get_sampler_stats(name),
                                      a.get_sampler_stats(name))


def test_save_and_load_keep_values_stats_and_checkpoint(sampled, tmp_path):
    model, trace = sampled
    directory = pt.save_trace(trace, str(tmp_path / "t"))
    assert sorted(os.listdir(directory)) == ["chain-0", "chain-1", "chain-2"]
    assert sorted(os.listdir(os.path.join(directory, "chain-0"))) == [
        "metadata.json", "samples.npz", "stats.npz", "warmup_state.npz"]
    loaded = pt.load_trace(directory, model=model)
    _same_values(trace, loaded, trace.varnames)
    _same_stats(trace, loaded)
    for c in trace.chains:
        want = trace._straces[c].warmup_state
        got = loaded._straces[c].warmup_state
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(OSError, match="overwrite"):
        pt.save_trace(trace, directory)
    pt.save_trace(trace, directory, overwrite=True)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_saved_trace_loads_in_the_other_package(writer, tmp_path):
    """Values and statistics of a ``save_trace`` directory written by one
    package, read by the other."""
    pkgs = {"jax": pj, "port": pt}
    reader = pt if writer == "jax" else pj
    source = _recorded(pkgs[writer], _model(pkgs[writer]))
    directory = pkgs[writer].save_trace(source, str(tmp_path / "t"))
    loaded = reader.load_trace(directory, model=_model(reader))
    _same_values(source, loaded, source.varnames)
    _same_stats(source, loaded)


def _recorded(pm, model, chains=2, draws=6, stats=True):
    """A trace of ``draws`` seeded points per chain, recorded through the
    package's own ``NDArray.record`` (no sampling)."""
    from importlib import import_module
    NDArray = import_module(pm.__name__ + ".backends.ndarray").NDArray
    MultiTrace = import_module(pm.__name__ + ".backends.base").MultiTrace
    rng = np.random.RandomState(7)
    straces = []
    for c in range(chains):
        strace = NDArray(model=model)
        strace.setup(draws, c, [{"depth": np.int64, "diverging": bool,
                                 "energy": np.float64}] if stats else None)
        for i in range(draws):
            point = {"mu": rng.randn(2).astype(np.float32),
                     "sigma_log__": np.float32(rng.randn())}
            strace.record(point, [{"depth": i, "diverging": i % 3 == 0,
                                   "energy": rng.randn()}] if stats
                          else None)
        strace.close()
        straces.append(strace)
    return MultiTrace(straces)


def test_text_round_trip(sampled, tmp_path):
    model, trace = sampled
    ttext.dump(str(tmp_path / "t"), trace)
    loaded = ttext.load(str(tmp_path / "t"), model=model)
    _same_values(trace, loaded, trace.varnames)
    first = loaded._straces[0]
    assert first.flat_names["mu"] == ["mu__0", "mu__1"]
    np.testing.assert_array_equal(first.point(3)["mu"],
                                  trace.point(3, chain=0)["mu"])
    assert len(loaded[5:]) == len(trace) - 5


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_text_trace_loads_in_the_other_package(writer, tmp_path):
    pkgs = {"jax": (pj, jtext), "port": (pt, ttext)}
    pm, mod = pkgs[writer]
    rpm, rmod = pkgs["port" if writer == "jax" else "jax"]
    source = _recorded(pm, _model(pm), stats=False)
    with _model(pm):
        mod.dump(str(tmp_path / "t"), source)
    loaded = rmod.load(str(tmp_path / "t"), model=_model(rpm))
    for name in ("mu", "sigma_log__"):
        for c in source.chains:
            np.testing.assert_array_equal(
                np.asarray(loaded.get_values(name, chains=[c])),
                np.asarray(source.get_values(name, chains=[c])))


def test_sample_into_text_records_the_draws(tmp_path, monkeypatch):
    """``trace="text"`` writes ``mcmc/chain-<n>.csv`` under the working
    directory; the draws equal an NDArray run of the same seed, exactly,
    and the statistics are dropped."""
    monkeypatch.chdir(tmp_path)
    model = _model(pt)
    kw = dict(draws=15, tune=20, chains=2, model=model, random_seed=6,
              progressbar=False, compute_convergence_checks=False)
    ref = pt.sample(**kw)
    tr = pt.sample(trace="text", **kw)
    assert sorted(os.listdir("mcmc")) == ["chain-0.csv", "chain-1.csv"]
    assert tr.stat_names == set()
    _same_values(ref, ttext.load("mcmc", model=model), ref.varnames)


def test_sqlite_round_trip(sampled, tmp_path):
    model, trace = sampled
    name = str(tmp_path / "t.sqlite")
    for c in trace.chains:
        strace = SQLite(name, model=model)
        strace.setup(len(trace), c)
        strace.record_batch({v: trace.get_values(v, chains=[c])
                             for v in strace.varnames}, len(trace))
        strace.close()
    loaded = sqlite_load(name, model=model)
    _same_values(trace, loaded, trace.varnames)
    np.testing.assert_array_equal(loaded.point(-1, chain=1)["mu"],
                                  trace.point(-1, chain=1)["mu"])


def test_sample_into_sqlite_drops_the_stats(tmp_path):
    model = _model(pt)
    kw = dict(draws=15, tune=20, chains=2, model=model, random_seed=6,
              progressbar=False, compute_convergence_checks=False)
    backend = pt.backends.SQLite(str(tmp_path / "s.sqlite"), model=model)
    with pytest.raises(ValueError, match="multiple chains"):
        pt.sample(trace=backend, **kw)
    kw["chains"] = 1
    ref = pt.sample(**kw)
    tr = pt.sample(trace=backend, **kw)
    assert tr.stat_names == set()
    _same_values(ref, sqlite_load(str(tmp_path / "s.sqlite"), model=model),
                 ref.varnames)


def test_hdf5_round_trip_with_stats(sampled, tmp_path):
    model, trace = sampled
    name = str(tmp_path / "t.h5")
    for c in trace.chains:
        src = trace._straces[c]
        strace = HDF5(name, model=model)
        strace.setup(len(trace), c, src.sampler_vars)
        strace.record_batch({v: src.get_values(v) for v in strace.varnames},
                            len(trace), src._stats)
        strace.close()
    loaded = hdf5_load(name, model=model)
    _same_values(trace, loaded, trace.varnames)
    _same_stats(trace, loaded)


def test_shortcuts_name_the_three_backends():
    from pymc3_tpu.backends import _shortcuts as jshort
    from pymc3_tpu_torch.backends import _shortcuts as tshort
    assert {k: (v["backend"].__name__, v["name"]) for k, v in tshort.items()} \
        == {k: (v["backend"].__name__, v["name"]) for k, v in jshort.items()}
    with pytest.raises(ValueError, match="Unknown trace backend"):
        pt.sample(draws=5, tune=5, model=_model(pt), trace="parquet",
                  progressbar=False)


def test_merge_traces_and_points_as_the_jax_package():
    merged = {}
    for pm in (pj, pt):
        a = _recorded(pm, _model(pm))
        b = _recorded(pm, _model(pm))
        m = pm.merge_traces([a, b])
        merged[pm.__name__] = (m.chains, len(m),
                               np.asarray(m.get_values("mu")),
                               [p["sigma_log__"] for p in m.points()])
    j, t = merged["pymc3_tpu"], merged["pymc3_tpu_torch"]
    assert t[0] == j[0] and t[1] == j[1]
    np.testing.assert_array_equal(t[2], j[2])
    np.testing.assert_array_equal(t[3], j[3])
    with pytest.raises(ValueError, match="unequal"):
        pt.merge_traces([_recorded(pt, _model(pt), draws=6),
                         _recorded(pt, _model(pt), draws=5)])
    assert issubclass(pt.backends.BackendError, Exception)


def test_point_list_to_multitrace_as_the_jax_package():
    points = [{"mu": np.array([0.1 * i, -0.2], np.float32),
               "sigma_log__": np.float32(0.05 * i)} for i in range(4)]
    tj = pj.point_list_to_multitrace(points, model=_model(pj))
    tt = pt.point_list_to_multitrace(points, model=_model(pt))
    assert tt.varnames == tj.varnames and len(tt) == len(tj) == 4
    np.testing.assert_array_equal(tt["mu"], tj["mu"])


def test_add_and_remove_values():
    trace = _recorded(pt, _model(pt))
    trace.add_values({"twice": 2 * trace.get_values("sigma_log__")})
    assert "twice" in trace.varnames
    np.testing.assert_array_equal(trace.get_values("twice", chains=[1]),
                                  2 * trace.get_values("sigma_log__",
                                                       chains=[1]))
    with pytest.raises(ValueError, match="already exists"):
        trace.add_values({"twice": trace.get_values("sigma_log__")})
    trace.remove_values("twice")
    assert "twice" not in trace.varnames
    with pytest.raises(KeyError):
        trace.remove_values("twice")


def test_trace_to_dataframe_columns_equal_the_jax_packages():
    tj = _recorded(pj, _model(pj))
    tt = _recorded(pt, _model(pt))
    dj = pj.trace_to_dataframe(tj)
    dt = pt.trace_to_dataframe(tt)
    assert list(dt.columns) == list(dj.columns)
    # sigma = exp(sigma_log__) may differ by an ulp between the packages
    np.testing.assert_allclose(dt.values, dj.values, rtol=1e-6)
    assert list(pt.trace_to_dataframe(tt, include_transformed=True)
                .columns) == list(pj.trace_to_dataframe(
                    tj, include_transformed=True).columns)


def test_inference_data_groups_equal_the_jax_packages():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tj = _recorded(pj, _model(pj))
        tt = _recorded(pt, _model(pt))
        ij = pj.to_inference_data(tj, model=tj._straces[0].model,
                                  log_likelihood=True)
        it = pt.to_inference_data(tt, model=tt._straces[0].model,
                                  log_likelihood=True)
    assert it.groups() == ij.groups()
    for group in it.groups():
        gt, gj = getattr(it, group), getattr(ij, group)
        assert sorted(gt.keys()) == sorted(gj.keys()), group
        for k in gj.keys():
            np.testing.assert_allclose(np.asarray(gt[k]), np.asarray(gj[k]),
                                       rtol=1e-5, atol=1e-6)
    with pytest.raises(TypeError, match="Unsupported idata_kwargs"):
        pt.to_inference_data(tt, model=tt._straces[0].model, bogus=1)
