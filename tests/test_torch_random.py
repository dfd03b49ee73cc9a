"""The port's forward draws: every family against scipy, the shapes of the
JAX package's ``random``, explicit seeding, and draws at batched points.

Each family draws 20,000 values on the CPU from a seeded generator. Gates,
with their z (the statistic over its standard error):

- quantiles at p = 0.05, 0.25, 0.5, 0.75, 0.95 against scipy's ``ppf``:
  |q_hat - q| / se < 4.5, with se = sqrt(p (1 - p) / n) / pdf(q);
- the mean where the variance is finite: |mean - m| / (sd / sqrt(n)) < 4;
- the sd where the fourth moment is finite: relative error within 4 of its
  standard errors, sqrt((kurtosis + 2) / (4 n)).

Heavy-tailed families (Cauchy, HalfCauchy, StudentT with nu <= 4) are held
by their quantiles only.
"""
import numpy as np
import pytest
import scipy.stats as st
import scipy.special as sp
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
N = 20000
PROBS = np.array([0.05, 0.25, 0.5, 0.75, 0.95])
Z_QUANTILE = 4.5
Z_MOMENT = 4.0


class _Ref:
    """The few methods of a scipy frozen distribution the gates use, for a
    family scipy does not have."""

    def __init__(self, ppf, pdf, mean=None, var=None):
        self.ppf, self.pdf = ppf, pdf
        self._mean, self._var = mean, var

    def stats(self, moments="mvk"):
        return self._mean, self._var, np.nan


def _kumaraswamy(a, b):
    ppf = lambda p: (1 - (1 - p) ** (1 / b)) ** (1 / a)  # noqa: E731
    pdf = lambda x: a * b * x ** (a - 1) * (1 - x ** a) ** (b - 1)  # noqa
    m1 = b * sp.beta(1 + 1 / a, b)
    m2 = b * sp.beta(1 + 2 / a, b)
    return _Ref(ppf, pdf, m1, m2 - m1 ** 2)


def _half_t(nu, sigma):
    t = st.t(nu, scale=sigma)
    return _Ref(lambda p: t.ppf((1 + p) / 2), lambda x: 2 * t.pdf(x))


def _vonmises(kappa):
    """scipy's VonMises density with its quantiles read off a fine CDF
    grid (scipy's own ppf is slow at large kappa)."""
    d = st.vonmises(kappa)
    x = np.linspace(-np.pi, np.pi, 200001)
    cdf = np.cumsum(d.pdf(x))
    cdf /= cdf[-1]
    mean, var = d.stats(moments="mv")
    return _Ref(lambda p: np.interp(p, cdf, x), d.pdf, mean, var)


def _logitnormal(mu, sigma):
    n = st.norm(mu, sigma)
    return _Ref(lambda p: sp.expit(n.ppf(p)),
                lambda x: n.pdf(sp.logit(x)) / (x * (1 - x)))


_TRI_X = np.linspace(0.0, 3.0, 61)

# (id, port distribution, reference)
CELLS = [
    ("uniform", pt.Uniform.dist(lower=-1.0, upper=2.0), st.uniform(-1, 3)),
    ("normal", pt.Normal.dist(mu=1.0, sigma=2.0), st.norm(1, 2)),
    ("truncnormal", pt.TruncatedNormal.dist(mu=0.5, sigma=1.5, lower=-1.0,
                                            upper=2.0),
     st.truncnorm(-1.0, 1.0, 0.5, 1.5)),
    ("truncnormal-tail", pt.TruncatedNormal.dist(mu=0.0, sigma=1.0,
                                                 lower=2.5),
     st.truncnorm(2.5, np.inf)),
    ("halfnormal", pt.HalfNormal.dist(sigma=2.0), st.halfnorm(scale=2)),
    ("wald", pt.Wald.dist(mu=1.5, lam=2.0), st.invgauss(0.75, scale=2)),
    ("beta", pt.Beta.dist(alpha=2.0, beta=3.0), st.beta(2, 3)),
    ("beta-small", pt.Beta.dist(alpha=0.5, beta=0.5), st.beta(0.5, 0.5)),
    ("kumaraswamy", pt.Kumaraswamy.dist(a=2.0, b=5.0), _kumaraswamy(2, 5)),
    ("exponential", pt.Exponential.dist(lam=2.0), st.expon(scale=0.5)),
    ("laplace", pt.Laplace.dist(mu=1.0, b=2.0), st.laplace(1, 2)),
    ("lognormal", pt.Lognormal.dist(mu=0.3, sigma=0.6),
     st.lognorm(0.6, scale=np.exp(0.3))),
    ("studentt", pt.StudentT.dist(nu=3.0, mu=1.0, sigma=2.0),
     st.t(3, 1, 2)),
    ("studentt-lam", pt.StudentT.dist(nu=8.0, mu=-1.0, lam=0.25),
     st.t(8, -1, 2)),
    ("pareto", pt.Pareto.dist(alpha=5.0, m=2.0), st.pareto(5, scale=2)),
    ("cauchy", pt.Cauchy.dist(alpha=1.0, beta=2.0), st.cauchy(1, 2)),
    ("halfcauchy", pt.HalfCauchy.dist(beta=2.0), st.halfcauchy(scale=2)),
    ("gamma", pt.Gamma.dist(alpha=2.5, beta=1.5),
     st.gamma(2.5, scale=1 / 1.5)),
    ("gamma-small", pt.Gamma.dist(alpha=0.3, beta=1.0), st.gamma(0.3)),
    ("inversegamma", pt.InverseGamma.dist(alpha=5.0, beta=2.0),
     st.invgamma(5, scale=2)),
    ("chisquared", pt.ChiSquared.dist(nu=4.0), st.chi2(4)),
    ("weibull", pt.Weibull.dist(alpha=1.5, beta=2.0),
     st.weibull_min(1.5, scale=2)),
    ("halfstudentt", pt.HalfStudentT.dist(nu=5.0, sigma=2.0), _half_t(5, 2)),
    ("exgaussian", pt.ExGaussian.dist(mu=1.0, sigma=0.5, nu=2.0),
     st.exponnorm(4.0, 1, 0.5)),
    # VonMises draws wrap onto [-pi, pi); they are held centred on mu
    ("vonmises", pt.VonMises.dist(mu=0.5, kappa=2.0), _vonmises(2.0)),
    ("vonmises-flat", pt.VonMises.dist(mu=0.0, kappa=0.1), _vonmises(0.1)),
    ("vonmises-peaked", pt.VonMises.dist(mu=-2.0, kappa=50.0),
     _vonmises(50.0)),
    ("skewnormal", pt.SkewNormal.dist(mu=1.0, sigma=2.0, alpha=3.0),
     st.skewnorm(3, 1, 2)),
    ("triangular", pt.Triangular.dist(lower=-1.0, c=0.0, upper=3.0),
     st.triang(0.25, -1, 4)),
    ("gumbel", pt.Gumbel.dist(mu=1.0, beta=2.0), st.gumbel_r(1, 2)),
    ("rice", pt.Rice.dist(nu=2.0, sigma=1.0), st.rice(2.0)),
    ("logistic", pt.Logistic.dist(mu=1.0, s=2.0), st.logistic(1, 2)),
    ("logitnormal", pt.LogitNormal.dist(mu=0.5, sigma=1.0),
     _logitnormal(0.5, 1.0)),
    ("interpolated", pt.Interpolated.dist(
        x_points=_TRI_X, pdf_points=st.triang(1 / 3, 0, 3).pdf(_TRI_X)),
     st.triang(1 / 3, 0, 3)),
    ("bound-normal", pt.Bound(pt.Normal, lower=0.5).dist(mu=1.0, sigma=2.0),
     st.truncnorm(-0.25, np.inf, 1, 2)),
    ("normalmixture", pt.NormalMixture.dist(
        w=np.array([0.3, 0.7]), mu=np.array([-2.0, 3.0]),
        sigma=np.array([0.5, 1.0])), None),
]
HEAVY = {"cauchy", "halfcauchy", "studentt"}
#: The families whose draws the JAX package returns as float32 (its
#: clipped_beta_rvs returns floatX; a Bound casts them to the wrapped
#: distribution's dtype); its other continuous families' are float64.
JAX_FLOAT32 = {"Beta", "_ContinuousBounded"}


def _draws(dist, seed=0, size=N):
    gen = torch.Generator().manual_seed(seed)
    out = dist.random(size=size, gen=gen)
    want = np.float32 if type(dist).__name__ in JAX_FLOAT32 else np.float64
    assert isinstance(out, np.ndarray) and out.dtype == want
    return out.astype(np.float64)


def _check_quantiles(x, ref):
    q_hat = np.quantile(x, PROBS)
    q = ref.ppf(PROBS)
    se = np.sqrt(PROBS * (1 - PROBS) / x.size) / ref.pdf(q)
    z = np.abs(q_hat - q) / se
    assert np.all(z < Z_QUANTILE), (q_hat, q, z)


def _check_moments(x, mean, var, kurt):
    n = x.size
    sd = np.sqrt(var)
    assert abs(x.mean() - mean) / (sd / np.sqrt(n)) < Z_MOMENT, \
        (x.mean(), mean)
    if np.isfinite(kurt):
        se_rel = np.sqrt((kurt + 2.0) / (4.0 * n))
        assert abs(x.std() / sd - 1.0) / se_rel < Z_MOMENT, (x.std(), sd)


@pytest.mark.parametrize("name,dist,ref", CELLS, ids=[c[0] for c in CELLS])
def test_draws_match_scipy(name, dist, ref):
    x = _draws(dist)
    assert np.all(np.isfinite(x))
    if name.startswith("vonmises"):
        assert np.all((x >= -np.pi) & (x <= np.pi))
        mu = float(dist.mu.test_value)
        x = np.mod(x - mu + np.pi, 2 * np.pi) - np.pi
    if ref is None:  # the mixture: its closed-form moments
        w, mu, s = np.array([0.3, 0.7]), np.array([-2.0, 3.0]), \
            np.array([0.5, 1.0])
        mean = w @ mu
        var = w @ (s ** 2 + mu ** 2) - mean ** 2
        _check_moments(x, mean, var, np.nan)
        return
    _check_quantiles(x, ref)
    mean, var, kurt = ref.stats(moments="mvk")
    if name not in HEAVY and mean is not None and np.isfinite(var):
        _check_moments(x, float(mean), float(var), float(kurt))


def test_dirichlet_and_mvnormal_moments():
    a = np.array([1.0, 2.0, 3.0])
    x = _draws(pt.Dirichlet.dist(a=a), seed=1)
    assert x.shape == (N, 3)
    np.testing.assert_allclose(x.sum(-1), 1.0, atol=1e-5)
    a0 = a.sum()
    mean, var = a / a0, a * (a0 - a) / (a0 ** 2 * (a0 + 1))
    assert np.all(np.abs(x.mean(0) - mean) / np.sqrt(var / N) < Z_MOMENT)

    mu = np.array([1.0, -2.0])
    cov = np.array([[2.0, 0.6], [0.6, 1.0]])
    y = _draws(pt.MvNormal.dist(mu=mu, cov=cov), seed=2)
    assert y.shape == (N, 2)
    assert np.all(np.abs(y.mean(0) - mu) / np.sqrt(np.diag(cov) / N)
                  < Z_MOMENT)
    # covariance entries: se of a sample covariance ~ sqrt((s_ii s_jj +
    # s_ij^2) / n) for a normal
    se = np.sqrt((np.outer(np.diag(cov), np.diag(cov)) + cov ** 2) / N)
    assert np.all(np.abs(np.cov(y.T) - cov) / se < Z_MOMENT)


def test_flat_cannot_be_drawn():
    for d in (pt.Flat.dist(), pt.HalfFlat.dist()):
        with pytest.raises(ValueError):
            d.random(size=3)


# -- shapes: the JAX package's random() -----------------------------------------
SIZES = [None, 5, (4, 5)]
SHAPE_CELLS = [
    ("Normal", dict(mu=0.0, sigma=1.0)),
    ("Beta", dict(alpha=2.0, beta=3.0)),
    ("StudentT", dict(nu=4.0, mu=0.0, sigma=1.0)),
    ("VonMises", dict(mu=0.0, kappa=1.0)),
    ("Triangular", dict(lower=0.0, c=0.5, upper=1.0)),
    ("TruncatedNormal", dict(mu=0.0, sigma=1.0, lower=-1.0, upper=1.0)),
]


@pytest.mark.parametrize("cls,params", SHAPE_CELLS,
                         ids=[c[0] for c in SHAPE_CELLS])
def test_random_shapes_match_jax(cls, params):
    vec = {k: np.full(5, v) for k, v in params.items()}
    for kwargs in (dict(params), dict(params, shape=10),
                   dict(vec, shape=5), dict(vec), dict(vec, shape=(3, 5))):
        dj = getattr(pj, cls).dist(**kwargs)
        dt = getattr(pt, cls).dist(**kwargs)
        for size in SIZES:
            assert tuple(dt.random(size=size).shape) == \
                np.shape(dj.random(size=size)), (kwargs, size)


def test_multivariate_and_mixture_shapes_match_jax():
    cells = [
        ("Dirichlet", dict(a=np.ones(3))),
        ("Dirichlet", dict(a=np.ones((2, 3)))),
        ("MvNormal", dict(mu=np.zeros(3), cov=np.eye(3))),
        ("NormalMixture", dict(w=np.array([0.5, 0.5]),
                               mu=np.array([0.0, 1.0]), sigma=1.0)),
        ("NormalMixture", dict(w=np.array([0.5, 0.5]),
                               mu=np.array([0.0, 1.0]), sigma=1.0,
                               shape=(7,))),
    ]
    for cls, kwargs in cells:
        dj = getattr(pj, cls).dist(**kwargs)
        dt = getattr(pt, cls).dist(**kwargs)
        for size in SIZES:
            assert tuple(dt.random(size=size).shape) == \
                np.shape(dj.random(size=size)), (cls, kwargs, size)


def test_same_seed_same_draws():
    d = pt.Gamma.dist(alpha=2.0, beta=1.0, shape=4)
    a = _draws(d, seed=7, size=50)
    b = _draws(d, seed=7, size=50)
    c = _draws(d, seed=8, size=50)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


# -- draws at points -------------------------------------------------------------
def test_random_at_a_point_uses_its_values():
    with pt.Model():
        mu = pt.Normal("mu", 0.0, 1.0)
        d = pt.Normal.dist(mu=mu * 2.0, sigma=0.1)
    x = d.random(point={"mu": np.float32(5.0)}, size=1000,
                 gen=torch.Generator().manual_seed(0))
    assert abs(x.mean() - 10.0) < 4 * 0.1 / np.sqrt(1000)


def test_draws_at_a_batched_point_line_up_per_sample():
    """A per-sample parameter (S,) against a (S, 8) draw: each sample's
    row uses its own value (the JAX package loops per sample here)."""
    from pymc3_tpu_torch.distributions.distribution import BatchedPoint
    with pt.Model():
        mu = pt.Normal("mu", 0.0, 1.0)
        theta = pt.Normal.dist(mu=mu, sigma=0.01, shape=8)
    S = 6
    mus = torch.arange(S, dtype=torch.float32) * 10.0
    point = BatchedPoint({"mu": mus}, {"mu"}, S)
    x = theta.random(point=point, size=S, gen=torch.Generator().manual_seed(1))
    assert x.shape == (S, 8)
    np.testing.assert_allclose(x.mean(1), mus.numpy(), atol=0.05)
    with pytest.raises(ValueError, match="batched point"):
        theta.random(point=point, size=S + 1)


def test_bound_rejection_respects_bounds():
    d = pt.Bound(pt.Normal, lower=-0.5, upper=0.5).dist(mu=1.5, sigma=1.0)
    x = _draws(d, seed=3, size=2000)
    assert np.all((x >= -0.5) & (x <= 0.5))
