"""The port's diagnostics and model comparison against the JAX package's,
on the same arrays and the same draws.

- ``hpd``, ``geweke``, ``bfmi`` and ``r2_score``: the same numpy code, so
  equal to rtol 1e-12; the rank-normalised ``rhat`` (ties, integers, too
  few draws, constant chains) to rtol 1e-12.
- ``rhat_device`` / ``ess_device`` against the JAX package's, which reduce
  in float32 where the port reduces in float64: rtol 1e-5 for R-hat and 1e-4
  for ESS (float32 FFTs and sums over 4,000 draws); and against a float64
  numpy evaluation of the same plain formulas, rtol 1e-10.
- The pointwise log-likelihood matrix of two small models on the same
  draws, compared directly (both float32: rtol 1e-6, atol 1e-5); then, with
  both packages in float64, ``waic``, ``loo`` (pointwise too) and
  ``compare`` within 1e-6 relative. In float32 the two matrices differ in
  the last bits, and ``p_waic``, a sum of variances of float32 values
  taken in float32 by the JAX package, moves by about 1e-6 with them.
  The JAX package's ``_gpdfit`` takes the Pareto scale after the prior has
  moved k (``pymc3_tpu/stats/__init__.py:418-419``): where that moves k
  across zero the scale is negative, the smoothed weights NaN and ``loo``
  NaN. The port takes the scale first, as ArviZ does. So ``loo`` and
  ``compare`` are held against the JAX package's with its ``_gpdfit``
  replaced by that order, and a test shows the fault and holds the port's
  fit to a float64 evaluation of Zhang and Stephens' estimate.
"""
import numpy as np
import pytest
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu import stats as jstats
from pymc3_tpu_torch import stats as tstats
from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .torch_reference import arviz_gpdfit as _arviz_gpdfit

torch.set_num_threads(2)
REL = 1e-6


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _ar1(chains=4, draws=1000, dim=3, rho=0.6, seed=0):
    rng = np.random.RandomState(seed)
    x = np.zeros((chains, draws, dim))
    eps = rng.randn(chains, draws, dim)
    for t in range(1, draws):
        x[:, t] = rho * x[:, t - 1] + eps[:, t]
    return x + np.arange(dim) + 0.05 * rng.randn(chains, 1, dim)


@pytest.mark.parametrize("shape", [(500,), (500, 3), (4, 250, 2)])
@pytest.mark.parametrize("alpha", [0.05, 0.2])
def test_hpd(shape, alpha):
    x = np.random.RandomState(1).standard_t(5, size=shape)
    np.testing.assert_allclose(tstats.hpd(x, alpha=alpha),
                               jstats.hpd(x, alpha=alpha), rtol=1e-12)


def test_geweke_bfmi_r2():
    rng = np.random.RandomState(2)
    x = rng.randn(2000).cumsum() * 0.01 + rng.randn(2000)
    np.testing.assert_allclose(tstats.geweke(x, intervals=15),
                               jstats.geweke(x, intervals=15), rtol=1e-12)
    with pytest.raises(ValueError, match="Geweke"):
        tstats.geweke(x, first=0.6, last=0.5)
    energy = rng.randn(4, 300).cumsum(axis=1)
    np.testing.assert_allclose(tstats.bfmi(energy), jstats.bfmi(energy),
                               rtol=1e-12)
    y = rng.randn(50)
    pred = y[None] + 0.5 * rng.randn(200, 50)
    for yp in (pred, pred[0]):
        assert tuple(tstats.r2_score(y, yp, round_to=6)) == tuple(
            jstats.r2_score(y, yp, round_to=6))


RHAT_CASES = {
    "continuous": lambda rng: rng.randn(4, 101, 3),
    "ties": lambda rng: rng.randint(0, 5, (6, 80, 2)).astype(float),
    "apart": lambda rng: rng.randn(3, 50) + np.arange(3)[:, None],
    "constant": lambda rng: np.ones((2, 20)),
    "too_short": lambda rng: rng.randn(2, 3),
    "integers": lambda rng: rng.randint(0, 3, (4, 60)),
}


@pytest.mark.parametrize("case", sorted(RHAT_CASES))
def test_rank_normalised_rhat(case):
    """The port ranks every element of a variable in one sort on the
    device; the JAX package ranks each with scipy. Equal to rtol 1e-12,
    NaN where the JAX package gives NaN."""
    x = RHAT_CASES[case](np.random.RandomState(0))
    got, want = tstats.rhat(x)["x"], jstats.rhat(x)["x"]
    assert np.shape(got) == np.shape(want)
    np.testing.assert_allclose(got, want, rtol=1e-12)


def _rhat_np(x):
    """Split R-hat in float64 numpy, the plain formula."""
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]])
    n = x.shape[1]
    within = x.var(axis=1, ddof=1).mean(axis=0)
    between = n * x.mean(axis=1).var(axis=0, ddof=1)
    return np.sqrt(((n - 1) / n * within + between / n) / within)


def _ess_np(x):
    """Bulk ESS in float64 numpy: Geyer's pairs, kept while positive,
    monotone by a running minimum."""
    half = x.shape[1] // 2
    x = np.concatenate([x[:, :half], x[:, half:2 * half]])
    m, n, _ = x.shape
    mpad = 2 ** int(np.ceil(np.log2(2 * n)))
    c = x - x.mean(axis=1, keepdims=True)
    f = np.fft.rfft(c, mpad, axis=1)
    acov = np.fft.irfft(f * np.conj(f), mpad, axis=1)[:, :n] / n
    mean_var = acov[:, 0].mean(axis=0) * n / (n - 1)
    var_plus = mean_var * (n - 1) / n + x.mean(axis=1).var(axis=0, ddof=1)
    rho = 1 - (mean_var - acov.mean(axis=0)) / var_plus
    rho[0] = 1.0
    pair = rho[:2 * (n // 2)].reshape(n // 2, 2, -1).sum(axis=1)
    keep = np.cumprod(pair > 0, axis=0).astype(bool)
    pair = np.where(keep, np.minimum.accumulate(np.where(keep, pair, np.inf),
                                                axis=0), 0.0)
    return m * n / np.maximum(-1 + 2 * pair.sum(axis=0), 1.0)


def test_device_diagnostics():
    x = _ar1()
    r, e = tstats.rhat_device(x), tstats.ess_device(x)
    assert r.shape == e.shape == (3,)
    np.testing.assert_allclose(r, jstats.rhat_device(x), rtol=1e-5)
    np.testing.assert_allclose(e, jstats.ess_device(x), rtol=1e-4)
    np.testing.assert_allclose(r, _rhat_np(x), rtol=1e-10)
    np.testing.assert_allclose(e, _ess_np(x), rtol=1e-10)
    # (chains, draws, ...) keeps the trailing shape; tensors stay put
    y = x.reshape(4, 1000, 3, 1)
    assert tstats.rhat_device(y).shape == (3, 1)
    np.testing.assert_allclose(tstats.ess_device(torch.from_numpy(y))[:, 0],
                               e, rtol=1e-12)


class _Trace:
    """Draws as ``{name: (chains, draws, ...)}``, with the parts of the
    MultiTrace interface both packages' ``loo``/``waic``/``ess`` read."""

    def __init__(self, values):
        self.values = values
        first = next(iter(values.values()))
        self.chains = list(range(first.shape[0]))
        self.nchains = len(self.chains)
        self._n = first.shape[1]
        self.varnames = list(values)

    def __len__(self):
        return self._n

    def point(self, i, chain):
        return {k: v[chain, i] for k, v in self.values.items()}

    def get_values(self, name, chains=None, combine=True, squeeze=True):
        chains = self.chains if chains is None else chains
        per = [self.values[name][c] for c in chains]
        if combine:
            return np.concatenate(per)
        return per


def _normal_model(pm):
    rng = np.random.RandomState(3)
    y = (1.0 + 0.8 * rng.standard_t(3, size=30)).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 10.0)
        sigma = pm.HalfNormal("sigma", 2.0)
        pm.Normal("y", mu=mu, sigma=sigma, observed=y)
    return model


def _student_model(pm):
    rng = np.random.RandomState(3)
    y = (1.0 + 0.8 * rng.standard_t(3, size=30)).astype(np.float32)
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 10.0)
        sigma = pm.HalfNormal("sigma", 2.0)
        pm.StudentT("y", nu=3.0, mu=mu, sigma=sigma, observed=y[:20])
        pm.Normal("z", mu=mu, sigma=2.0, observed=y[20:])
    return model


def _draws(seed, chains=4, draws=200):
    rng = np.random.RandomState(seed)
    mu = (1.0 + 0.15 * rng.randn(chains, draws)).astype(np.float32)
    slog = (np.log(0.9) + 0.12 * rng.randn(chains, draws)).astype(np.float32)
    return _Trace({"mu": mu, "sigma_log__": slog,
                   "sigma": np.exp(slog)})


@pytest.fixture
def f64():
    prev = jax.config.jax_enable_x64, pj.get_config().floatX
    pj.set_config(floatX="float64")
    pt.set_config(floatX="float64")
    yield
    pt.set_config(floatX="float32")
    pj.set_config(floatX=prev[1])
    jax.config.update("jax_enable_x64", prev[0])


@pytest.fixture
def jax_gpdfit_fixed(monkeypatch):
    """The JAX package's ``loo`` with ArviZ's order in ``_gpdfit``, by the
    independent float64 evaluation above."""
    monkeypatch.setattr(jstats, "_gpdfit", _arviz_gpdfit)


@pytest.mark.parametrize("build", [_normal_model, _student_model],
                         ids=["normal", "student"])
def test_log_likelihood_matrix_float32(build):
    trace = _draws(4)
    llt = tstats._log_likelihood_matrix(trace, build(pt))
    llj = jstats._log_likelihood_matrix(trace, build(pj))
    assert llt.shape == llj.shape == (800, 30)
    assert llt.dtype == llj.dtype == np.float32
    np.testing.assert_allclose(llt, llj, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("build", [_normal_model, _student_model],
                         ids=["normal", "student"])
def test_waic_loo_match(build, f64, jax_gpdfit_fixed):
    mt, mj = build(pt), build(pj)
    trace = _draws(4)
    llt = tstats._log_likelihood_matrix(trace, mt)
    np.testing.assert_allclose(llt, jstats._log_likelihood_matrix(trace, mj),
                               rtol=1e-12)
    for fn in ("waic", "loo"):
        for scale in ("deviance", "log", "negative_log"):
            got = getattr(tstats, fn)(trace, mt, pointwise=True, scale=scale)
            want = getattr(jstats, fn)(trace, mj, pointwise=True,
                                       scale=scale)
            assert np.isfinite(got[0])
            for a, b in zip(got, want):
                np.testing.assert_allclose(a, b, rtol=REL, atol=1e-12)
    # the exports
    assert pt.loo(trace, mt).loo == tstats.loo(trace, mt).loo
    assert pt.waic(trace, mt).waic == tstats.waic(trace, mt).waic


def test_compare_matches(f64, jax_gpdfit_fixed):
    pytest.importorskip("pandas")
    tt, tj = _draws(5), _draws(5)
    for ic in ("loo", "waic"):
        got = pt.compare({"normal": (tt, _normal_model(pt)),
                          "student": (tt, _student_model(pt))}, ic=ic)
        want = pj.compare({"normal": (tj, _normal_model(pj)),
                           "student": (tj, _student_model(pj))}, ic=ic)
        assert list(got.index) == list(want.index)
        assert list(got.columns) == list(want.columns)
        for col in got.columns:
            np.testing.assert_allclose(got[col].to_numpy(float),
                                       want[col].to_numpy(float),
                                       rtol=REL, atol=1e-9)


def test_gpdfit_scale_before_the_prior():
    """A tail whose k estimate is slightly negative: the prior moves it
    above zero. The JAX package's scale then has the wrong sign and its
    smoothed quantiles are NaN; the port's fit is Zhang and Stephens'
    (ArviZ's order) and its quantiles finite."""
    tail = np.sort(np.random.RandomState(4).exponential(size=64))
    k_j, s_j = jstats._gpdfit(tail)
    k_t, s_t = tstats._gpdfit(tail)
    k_ref, s_ref = _arviz_gpdfit(tail)
    assert k_j == pytest.approx(k_t, rel=1e-12) and k_t > 0
    np.testing.assert_allclose([k_t, s_t], [k_ref, s_ref], rtol=1e-12)
    assert s_j < 0 < s_t
    probs = np.arange(0.5, 64) / 64
    assert np.isnan(jstats._gpinv(probs, k_j, s_j)).all()
    assert np.isfinite(tstats._gpinv(probs, k_t, s_t)).all()


def test_loo_finite_where_the_reference_is_nan():
    trace = _draws(6)
    mt, mj = _normal_model(pt), _normal_model(pj)
    got, want = tstats.loo(trace, mt), jstats.loo(trace, mj)
    if np.isnan(want.loo):
        assert np.isfinite(got.loo)
    w = tstats.waic(trace, mt)
    # LOO and WAIC agree closely on a model this well specified
    assert abs(got.loo - w.waic) < 0.05 * abs(w.waic)


def test_deprecated_aliases():
    x = _ar1(draws=200)
    with pytest.warns(DeprecationWarning):
        e = tstats.effective_n(x[..., 0])
    with pytest.warns(DeprecationWarning):
        r = tstats.gelman_rubin(x[..., 0])
    assert e["x"] == tstats.ess(x[..., 0])["x"]
    assert r["x"] == tstats.rhat(x[..., 0])["x"]

    @tstats.map_args
    def f(var_names=None):
        return var_names
    with pytest.warns(DeprecationWarning):
        assert f(varnames=["a"]) == ["a"]
