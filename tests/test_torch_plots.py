"""The port's plots against the JAX package's, figure by figure, on the
Agg backend.

The same numpy draws and sampler statistics go into each package's
NDArray trace (2 and 4 chains, 300 draws; a scalar, a vector, a
log-transformed scalar, a discrete scalar drawn as a histogram and one of
many integers drawn as a KDE). Each plot is called in both packages, with
``np.random`` seeded alike for the two that pick lines at random, and the
figures are compared artist by artist: titles, axis and tick labels,
texts and legends equal; ``Line2D`` data, ``fill_between`` vertices,
``vlines``/``hlines`` segments and scatter offsets within ``rtol = 1e-4``
of each artist's largest magnitude. The KDEs differ from scipy's by the
order of float64 sums (about 1e-15); the autocorrelations by the JAX
package's float32 ``np.correlate`` against the port's float64 FFT (about
1e-6 of lag 0, which is 1).

``energyplot`` is the one exception: the JAX package differences the
energies of all chains joined (``pymc3_tpu/plots/__init__.py:154``), the
port within each chain. Its test pins the port's transition values to the
JAX package's with the chain-boundary entries removed, and the rest of
the figure to the JAX package's.
"""
import matplotlib
matplotlib.use("Agg")
import matplotlib.pyplot as plt

import numpy as np
import pandas as pd
import pytest
import torch
from scipy.stats import gaussian_kde

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu_torch import plots
from pymc3_tpu_torch.gp import util as tgp_util
from pymc3_tpu.gp import util as jgp_util
from . import torch_models  # noqa: F401  (asks the port for the CPU)

RTOL = 1e-4
DRAWS = 300


def _draws(chains, seed=0):
    rng = np.random.default_rng(seed)
    sd_log = rng.normal(-0.5, 0.3, (chains, DRAWS)).astype(np.float32)
    values = {
        "mu": rng.normal(1.0, 0.5, (chains, DRAWS)).astype(np.float32),
        "theta": rng.normal(0.0, 1.0, (chains, DRAWS, 3)).astype(
            np.float32) * np.float32([1.0, 2.0, 0.5]),
        "sd_log__": sd_log,
        "sd": np.exp(sd_log),
        "k": rng.poisson(3.0, (chains, DRAWS)),
        "many": rng.poisson(60.0, (chains, DRAWS)),
    }
    stats = {"energy": rng.normal(0.0, 2.0, (chains, DRAWS)).cumsum(1)
             * 0.1 + 5.0 * np.arange(chains)[:, None],
             "diverging": rng.uniform(size=(chains, DRAWS)) < 0.05}
    return values, stats


def _trace(pm, values, stats):
    """The draws as a ``MultiTrace`` of ``pm``'s NDArray chains."""
    with pm.Model() as model:
        pm.Normal("mu", 0.0, 1.0)
        pm.Normal("theta", 0.0, 1.0, shape=3)
        pm.HalfNormal("sd", 1.0)
        pm.Poisson("k", 3.0)
        pm.Poisson("many", 60.0)
    chains, draws = values["mu"].shape
    straces = []
    for c in range(chains):
        s = pm.backends.ndarray.NDArray(model=model)
        s.setup(draws, c, sampler_vars=[{"energy": np.float64,
                                         "diverging": bool}])
        s.samples = {k: v[c] for k, v in values.items()}
        s._stats = [{k: v[c] for k, v in stats.items()}]
        s.draw_idx = draws
        straces.append(s)
    return pm.backends.base.MultiTrace(straces)


@pytest.fixture(scope="module", params=[2, 4], ids=["2chains", "4chains"])
def traces(request):
    values, stats = _draws(request.param)
    return _trace(pj, values, stats), _trace(pt, values, stats)


def _close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    if a.size:
        scale = max(float(np.nanmax(np.abs(b))), 1e-12)
        np.testing.assert_allclose(a, b, rtol=0, atol=RTOL * scale,
                                   err_msg=what)


def _texts(ax):
    legend = ax.get_legend()
    return {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(),
        "ylabel": ax.get_ylabel(),
        "xticklabels": [t.get_text() for t in ax.get_xticklabels()],
        "yticklabels": [t.get_text() for t in ax.get_yticklabels()],
        "texts": [t.get_text() for t in ax.texts],
        "legend": None if legend is None else
        [t.get_text() for t in legend.get_texts()],
    }


def _collection_data(coll):
    name = type(coll).__name__
    if name == "LineCollection":
        return name, [np.asarray(s) for s in coll.get_segments()]
    if name == "PathCollection":
        return name, [np.asarray(coll.get_offsets())]
    return name, [p.vertices for p in coll.get_paths()]


def _assert_axes_equal(ax_t, ax_j, where, skip_lines=(),
                       skip_collections=()):
    assert _texts(ax_t) == _texts(ax_j), where
    lines_t = [l for i, l in enumerate(ax_t.lines) if i not in skip_lines]
    lines_j = [l for i, l in enumerate(ax_j.lines) if i not in skip_lines]
    assert len(lines_t) == len(lines_j), where
    for i, (lt, lj) in enumerate(zip(lines_t, lines_j)):
        _close(lt.get_xdata(), lj.get_xdata(), f"{where} line {i} x")
        _close(lt.get_ydata(), lj.get_ydata(), f"{where} line {i} y")
        assert lt.get_drawstyle() == lj.get_drawstyle(), where
    colls_t = [c for i, c in enumerate(ax_t.collections)
               if i not in skip_collections]
    colls_j = [c for i, c in enumerate(ax_j.collections)
               if i not in skip_collections]
    assert len(colls_t) == len(colls_j), where
    for i, (ct, cj) in enumerate(zip(colls_t, colls_j)):
        (nt, dt), (nj, dj) = _collection_data(ct), _collection_data(cj)
        assert nt == nj and len(dt) == len(dj), (where, i, nt, nj)
        for k, (a, b) in enumerate(zip(dt, dj)):
            _close(a, b, f"{where} collection {i} ({nt}) part {k}")
    for i, (tt, tj) in enumerate(zip(ax_t.texts, ax_j.texts)):
        _close(tt.get_position(), tj.get_position(), f"{where} text {i}")


def _figures_equal(fig_t, fig_j):
    assert len(fig_t.axes) == len(fig_j.axes)
    for i, (at, aj) in enumerate(zip(fig_t.axes, fig_j.axes)):
        _assert_axes_equal(at, aj, f"axes {i}")


def _fig(out):
    return np.ravel(out)[0].figure


@pytest.mark.parametrize("name, kwargs", [
    ("traceplot", {}),
    ("traceplot", {"var_names": ["theta", "k"]}),
    ("plot_posterior", {}),
    ("plot_posterior", {"var_names": ["mu"], "ref_val": 1.0,
                        "credible_interval": 0.5}),
    ("forestplot", {}),
    ("forestplot", {"var_names": ["sd"], "credible_interval": 0.5}),
    ("autocorrplot", {"max_lag": 20}),
    ("autocorrplot", {"var_names": ["mu"], "max_lag": 1000}),
    ("densityplot", {}),
    ("kdeplot", {"var_names": ["theta"]}),
    ("pairplot", {"var_names": ["mu", "theta"]}),
    ("pairplot", {"var_names": ["mu", "sd"], "divergences": True}),
])
def test_plot_matches_jax(traces, name, kwargs):
    trace_j, trace_t = traces
    try:
        fig_j = _fig(getattr(pj, name)(trace_j, **kwargs))
        fig_t = _fig(getattr(pt, name)(trace_t, **kwargs))
        _figures_equal(fig_t, fig_j)
    finally:
        plt.close("all")


def test_kdeplot_is_densityplot():
    assert pt.kdeplot is pt.densityplot


def test_energyplot_differences_within_chains(traces):
    """The port's energy transitions are the JAX package's differences
    with the chain-boundary entries removed; the marginal, the legend and
    the axes are the JAX package's."""
    trace_j, trace_t = traces
    energy = np.asarray(trace_j.get_sampler_stats("energy"))
    chains, draws = trace_j.nchains, len(trace_j)
    jax_diff = np.diff(energy)
    boundaries = np.arange(1, chains) * draws - 1
    within = np.delete(jax_diff, boundaries)
    got = plots._energy_data(trace_t)["transition_values"]
    np.testing.assert_array_equal(got, within)
    try:
        ax_j = pj.energyplot(trace_j)
        ax_t = pt.energyplot(trace_t)
        # line 1 and collection 1 are the transitions
        _assert_axes_equal(ax_t, ax_j, "energyplot", skip_lines=(1,),
                           skip_collections=(1,))
        x, y = ax_t.lines[1].get_data()
        _close(y, gaussian_kde(within)(x), "transition KDE")
        np.testing.assert_array_equal(
            x, np.linspace(within.min(), within.max(), 200))
    finally:
        plt.close("all")


def test_compareplot_matches_jax():
    comp = pd.DataFrame({
        "rank": [0, 1], "waic": [10.0, 12.0], "p_waic": [1.0, 1.5],
        "d_waic": [0.0, 2.0], "weight": [0.7, 0.3], "se": [1.0, 1.2],
        "dse": [0.0, 0.5], "warning": [False, False],
    }, index=["m1", "m2"])
    try:
        _figures_equal(pt.compareplot(comp).figure,
                       pj.compareplot(comp).figure)
    finally:
        plt.close("all")


def test_plot_posterior_predictive_glm_matches_jax(traces):
    trace_j, trace_t = traces
    figs = []
    try:
        for pm, trace in ((pj, trace_j), (pt, trace_t)):
            plt.figure()
            np.random.seed(11)
            pm.plots.plot_posterior_predictive_glm(
                trace, eval=np.linspace(0, 1, 10),
                lm=lambda x, s: s["mu"] + s["sd"] * x, samples=12)
            figs.append(plt.gcf())
        assert len(figs[0].axes[0].lines) == 12
        _figures_equal(figs[1], figs[0])
    finally:
        plt.close("all")


@pytest.mark.parametrize("draws", [5, 500])
def test_plot_gp_dist_matches_jax(draws):
    rng = np.random.default_rng(3)
    x = np.linspace(0, 1, 40)[:, None]
    samples = (np.sin(6 * x[:, 0]) + rng.normal(0, 0.3, (draws, 40))
               ).astype(np.float32)
    axes = []
    try:
        for fn, data in ((jgp_util.plot_gp_dist, samples),
                         (tgp_util.plot_gp_dist, samples),
                         (tgp_util.plot_gp_dist, torch.as_tensor(samples))):
            _, ax = plt.subplots()
            np.random.seed(5)
            axes.append(fn(ax, data, x))
        assert len(axes[0].collections) == 40
        for ax in axes[1:]:
            _assert_axes_equal(ax, axes[0], "plot_gp_dist")
            for ct, cj in zip(ax.collections, axes[0].collections):
                np.testing.assert_array_equal(ct.get_facecolor(),
                                              cj.get_facecolor())
    finally:
        plt.close("all")


def test_gp_dist_ribbons_are_numpy_percentiles():
    samples = np.random.default_rng(4).gamma(2.0, size=(301, 17))
    upper, lower = tgp_util._gp_dist_data(samples.astype(np.float32))
    for i, p in enumerate(np.linspace(51, 99, 40)[::-1]):
        np.testing.assert_array_equal(
            upper[i], np.percentile(samples.astype(np.float32).T, p, axis=1))
        np.testing.assert_array_equal(
            lower[i],
            np.percentile(samples.astype(np.float32).T, 100 - p, axis=1))


@pytest.mark.parametrize("n", [2, 7, 60, 301])
def test_kde_is_scipys(n):
    rng = np.random.default_rng(n)
    series = rng.standard_t(3, size=(5, n)).astype(np.float32)
    series[2] = 1.5  # a constant row: the one point (1.5, 1.0)
    x, y, const = plots._kde(torch.as_tensor(series))
    assert const.tolist() == [False, False, True, False, False]
    for row, xr, yr in zip(series, x.numpy(), y.numpy()):
        if row.min() == row.max():
            assert (xr[0], yr[0]) == (1.5, 1.0)
            continue
        grid = np.linspace(row.min(), row.max(), 200)
        np.testing.assert_array_equal(xr, grid)
        np.testing.assert_allclose(yr, gaussian_kde(row)(grid), rtol=1e-10)


def test_autocorrelation_is_numpys(traces):
    _, trace_t = traces
    d = plots._autocorr_data(trace_t, var_names=["mu", "theta"], max_lag=50)
    values = np.stack(trace_t.get_values("mu", combine=False)).astype(
        np.float64)
    for c, series in enumerate(values):
        xc = series - series.mean()
        acf = np.correlate(xc, xc, "full")[len(xc) - 1:]
        np.testing.assert_allclose(d["acf"][0, c], acf[:50] / acf[0],
                                   rtol=1e-10, atol=1e-12)
    assert d["acf"].shape == (4, values.shape[0], 50)


def test_data_functions_in_several_chunks(traces, monkeypatch):
    """A chunk budget of three pooled series (or 13 per-chain ones) a
    chunk gives the same arrays as one chunk."""
    _, trace_t = traces
    calls = {
        "trace": lambda: plots._trace_data(trace_t),
        "posterior": lambda: plots._posterior_data(trace_t),
        "density": lambda: plots._density_data(trace_t),
        "pair": lambda: plots._pair_data(trace_t, ["mu", "theta"], True),
        "energy": lambda: plots._energy_data(trace_t),
    }
    whole = {k: f() for k, f in calls.items()}
    monkeypatch.setattr(plots, "KDE_CHUNK_BYTES", 8 * 200 * DRAWS * 13)
    for key, f in calls.items():
        chunked = f()
        for field, want in whole[key].items():
            got = chunked[field]
            if isinstance(want, tuple):
                for a, b in zip(got, want):
                    np.testing.assert_allclose(a, b, rtol=1e-12)
            elif isinstance(want, np.ndarray):
                np.testing.assert_allclose(got, want, rtol=1e-12,
                                           err_msg=f"{key} {field}")


def test_trace_data_discrete_counts(traces):
    """The discrete scalar's distinct values and each chain's counts are
    ``np.unique``'s; the many-valued one is a KDE."""
    _, trace_t = traces
    d = plots._trace_data(trace_t, var_names=["k", "many", "mu"])
    assert d["discrete"].tolist() == [True, False, False]
    k = np.stack(trace_t.get_values("k", combine=False))
    for c in range(k.shape[0]):
        vals, counts = np.unique(k[c], return_counts=True)
        seen = d["counts"][0, c] > 0
        np.testing.assert_array_equal(d["unique"][0][seen], vals)
        np.testing.assert_array_equal(d["counts"][0, c][seen], counts)

