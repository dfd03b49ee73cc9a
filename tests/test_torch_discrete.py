"""The port's discrete distributions against the JAX package's.

The same parameters and value grids (support edges and points outside the
support included) go through ``logp`` and ``logcdf`` of both packages:
float32, rtol 2e-5 and atol 2e-6, with ``-inf`` in the same places. Test
values (modes) agree exactly. ``random`` is held against scipy's pmf by
frequencies (each within five binomial standard errors) and against its
mean and variance (five standard errors of the mean, 10% of the variance).
"""
import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF

from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)
TOL = dict(rtol=2e-5, atol=2e-6)
GRID = np.array([-2, -1, 0, 1, 2, 3, 5, 7, 10, 11, 12, 40], np.float32)
P3 = np.array([0.2, 0.5, 0.3])
CUT = np.array([-1.0, 0.5])

# name -> (parameters, scipy distribution or None)
CELLS = {
    "Binomial": (dict(n=10, p=0.3), st.binom(10, 0.3)),
    "BetaBinomial": (dict(alpha=2.0, beta=3.0, n=10),
                     st.betabinom(10, 2.0, 3.0)),
    "Bernoulli": (dict(p=0.3), st.bernoulli(0.3)),
    "Bernoulli_logit": (dict(logit_p=-0.4),
                        st.bernoulli(1 / (1 + np.exp(0.4)))),
    "DiscreteWeibull": (dict(q=0.8, beta=1.3), None),
    "Poisson": (dict(mu=3.5), st.poisson(3.5)),
    "Poisson_zero": (dict(mu=0.0), None),
    "NegativeBinomial": (dict(mu=4.0, alpha=2.5),
                         st.nbinom(2.5, 2.5 / (2.5 + 4.0))),
    "Geometric": (dict(p=0.25), st.geom(0.25)),
    "DiscreteUniform": (dict(lower=1, upper=10), st.randint(1, 11)),
    "Categorical": (dict(p=P3), st.rv_discrete(values=(np.arange(3), P3))),
    "Constant": (dict(c=3), None),
    "ZeroInflatedPoisson": (dict(psi=0.6, theta=3.0), None),
    "ZeroInflatedBinomial": (dict(psi=0.7, n=10, p=0.4), None),
    "ZeroInflatedNegativeBinomial": (dict(psi=0.5, mu=4.0, alpha=2.0), None),
    "OrderedLogistic": (dict(eta=0.3, cutpoints=CUT), None),
}
LOGCDF = ["Binomial", "Bernoulli", "Poisson", "Geometric", "DiscreteUniform"]


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _dists(name):
    cls = name.split("_")[0]
    params = CELLS[name][0]
    return (getattr(pj, cls).dist(**params), getattr(pt, cls).dist(**params))


def _same(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(want))
    fin = np.isfinite(want)
    np.testing.assert_allclose(got[fin], want[fin], **TOL)


def test_all_fifteen_classes_are_exported():
    from pymc3_tpu.distributions import discrete as jd
    from pymc3_tpu_torch.distributions import discrete as td
    assert sorted(td.__all__) == sorted(jd.__all__) and len(td.__all__) == 15
    for name in td.__all__:
        assert getattr(pt, name) is getattr(td, name)
    assert {n.split("_")[0] for n in CELLS} | {"ConstantDist"} == \
        set(td.__all__)


@pytest.mark.parametrize("as_int", [False, True], ids=["float", "int"])
@pytest.mark.parametrize("name", list(CELLS))
def test_logp_matches_jax_on_the_grid(name, as_int):
    """A free discrete variable arrives as a float, observed data as
    integers: both give the JAX package's logp."""
    dj, dt = _dists(name)
    grid = GRID.astype(np.int32) if as_int else GRID
    _same(dt.logp(torch.from_numpy(grid)).numpy(), dj.logp(jnp.asarray(grid)))


@pytest.mark.parametrize("name", LOGCDF)
def test_logcdf_matches_jax_on_the_grid(name):
    dj, dt = _dists(name)
    # between the integers too: the CDF is a step function
    grid = np.concatenate([GRID, GRID + 0.5]).astype(np.float32)
    _same(dt.logcdf(torch.from_numpy(grid)).numpy(),
          dj.logcdf(jnp.asarray(grid)))


@pytest.mark.parametrize("name", list(CELLS))
def test_test_values_match_jax(name):
    dj, dt = _dists(name)
    np.testing.assert_array_equal(dt.default(), dj.default())
    assert dt.dtype == dj.dtype == np.dtype("int32")
    assert dt.shape == dj.shape


def _parent_model(pm, data):
    with pm.Model() as model:
        lam = pm.Exponential("lam", 1.0)
        p = pm.Beta("p", 2.0, 2.0)
        n = pm.DiscreteUniform("n", 8, 15)
        pm.Poisson("k", mu=lam, observed=data["k"])
        pm.Binomial("b", n=n, p=p, observed=data["b"])
        pm.NegativeBinomial("nb", mu=lam + 1.0, alpha=2.0,
                            observed=data["k"])
        pm.ZeroInflatedPoisson("zip", psi=p, theta=lam, observed=data["k"])
        pm.Geometric("g", p=p, shape=2)
        pm.Categorical("c", p=P3)
        pm.Bernoulli("z", p=p)
    return model


def test_parameters_as_other_variables_match_jax():
    """logp over a batch of points of a model whose discrete distributions
    take continuous and discrete parents, and its gradient in the
    continuous ones (rtol 1e-4: a sum of 40 terms)."""
    rng = np.random.RandomState(3)
    data = {"k": rng.poisson(2.0, 12), "b": rng.binomial(8, 0.4, 12)}
    mj, mt = _parent_model(pj, data), _parent_model(pt, data)
    assert [(v.var, v.slc) for v in mj.ordering.vmap] == \
        [(v.var, v.slc) for v in mt.ordering.vmap]
    assert [v.name for v in mt.disc_vars] == [v.name for v in mj.disc_vars]
    assert [v.name for v in mt.cont_vars] == [v.name for v in mj.cont_vars]
    for k, v in mt.test_point.items():
        np.testing.assert_array_equal(v, mj.test_point[k])
    q0 = mj.dict_to_array(mj.test_point)
    q = np.tile(q0, (4, 1)).astype(np.float32)
    q[:, :2] += rng.uniform(-0.5, 0.5, (4, 2))       # lam_log__, p_logodds__
    q[1, 2], q[2, 2], q[3, 2] = 9, 15, 7             # n: inside, edge, below b
    q[2, 3:5] = [3, 1]                               # g
    q[3, 5] = 0                                      # c
    lj, gj = jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn))(jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    _same(lt.numpy(), lj)
    fin = np.isfinite(np.asarray(lj))
    np.testing.assert_allclose(gt.numpy()[fin, :2], np.asarray(gj)[fin, :2],
                               rtol=1e-4, atol=1e-4)
    assert torch.isfinite(gt[torch.from_numpy(fin)]).all()
    # the logp-only function gives the same numbers, with no graph
    only = mt.make_logp_fn()(torch.from_numpy(q))
    assert not only.requires_grad
    np.testing.assert_array_equal(only.numpy(), lt.numpy())


RANDOM = [n for n, (_, ref) in CELLS.items() if ref is not None]


@pytest.mark.parametrize("name", RANDOM)
def test_random_matches_scipy_pmf(name):
    _, dt = _dists(name)
    ref = CELLS[name][1]
    N = 40000
    x = dt.random(size=N, gen=torch.Generator().manual_seed(11))
    assert isinstance(x, np.ndarray) and x.shape == (N,) \
        and x.dtype == np.int64
    lo, hi = int(x.min()), int(x.max())
    ks = np.arange(lo, hi + 1)
    pmf = ref.pmf(ks)
    assert np.all(pmf[np.isin(ks, np.unique(x))] > 0), "draw off the support"
    freq = np.array([(x == k).mean() for k in ks])
    se = np.sqrt(np.maximum(pmf * (1 - pmf), 1e-12) / N)
    assert np.all(np.abs(freq - pmf) < 5 * se + 1e-4)
    assert abs(x.mean() - ref.mean()) < 5 * ref.std() / np.sqrt(N)
    assert abs(x.var() / ref.var() - 1) < 0.1


def test_random_of_the_families_scipy_lacks():
    """Discrete Weibull by its CDF 1 - q^((k+1)^beta); the zero-inflated
    ones by their zero share and the mean of the rest; ordered logistic by
    its probabilities; the constant."""
    gen = torch.Generator().manual_seed(5)
    N = 40000
    x = pt.DiscreteWeibull.dist(q=0.8, beta=1.3).random(size=N, gen=gen)
    for k in (0, 1, 3, 6):
        cdf = 1 - 0.8 ** ((k + 1) ** 1.3)
        assert abs((x <= k).mean() - cdf) < 5 * 0.5 / np.sqrt(N)
    cases = [
        (pt.ZeroInflatedPoisson.dist(psi=0.6, theta=3.0), 0.6,
         st.poisson(3.0)),
        (pt.ZeroInflatedBinomial.dist(psi=0.7, n=10, p=0.4), 0.7,
         st.binom(10, 0.4)),
        (pt.ZeroInflatedNegativeBinomial.dist(psi=0.5, mu=4.0, alpha=2.0),
         0.5, st.nbinom(2.0, 2.0 / 6.0)),
    ]
    for dist, psi, base in cases:
        x = dist.random(size=N, gen=gen).astype(np.float64)
        zero = 1 - psi + psi * base.pmf(0)
        assert abs((x == 0).mean() - zero) < 5 * 0.5 / np.sqrt(N)
        assert abs(x.mean() - psi * base.mean()) < \
            5 * np.sqrt(base.var() + base.mean() ** 2) / np.sqrt(N)
    dist = pt.OrderedLogistic.dist(eta=0.3, cutpoints=CUT)
    x = dist.random(size=N, gen=gen)
    p = dist.p.test_value
    np.testing.assert_allclose(np.bincount(x, minlength=3) / N, p,
                               atol=5 * 0.5 / np.sqrt(N))
    assert (pt.Constant.dist(c=3).random(size=7, gen=gen) == 3).all()


def test_random_shapes_and_batched_rows():
    gen = torch.Generator().manual_seed(2)
    rows = np.array([[0.9, 0.1, 0.0], [0.0, 0.1, 0.9]])
    x = pt.Categorical.dist(p=rows).random(size=500, gen=gen)
    assert x.shape == (500, 2)
    assert (x[:, 0] <= 1).all() and (x[:, 1] >= 1).all()
    assert pt.Poisson.dist(mu=np.array([1.0, 50.0])).random(
        size=(3, 4), gen=gen).shape == (3, 4, 2)
    assert pt.Binomial.dist(n=5, p=0.5, shape=3).random(gen=gen).shape == (3,)


@pytest.mark.parametrize("lower,upper", [(2, 6), (2, None), (None, 6)])
def test_discrete_bound_matches_jax(lower, upper):
    dj = pj.Bound(pj.Poisson, lower=lower, upper=upper).dist(mu=3.0)
    dt = pt.Bound(pt.Poisson, lower=lower, upper=upper).dist(mu=3.0)
    _same(dt.logp(torch.from_numpy(GRID)).numpy(),
          dj.logp(jnp.asarray(GRID)))
    np.testing.assert_array_equal(dt.default(), dj.default())
    assert dt.transform is None and dt.dtype == dj.dtype
    x = dt.random(size=2000, gen=torch.Generator().manual_seed(1))
    assert x.min() >= (lower or 0) and x.max() <= (upper or 10 ** 6)
    with pytest.raises(ValueError, match="transform discrete"):
        pt.Bound(pt.Poisson, lower=1).dist(mu=3.0, transform="log")


def test_mixture_of_poissons_matches_jax():
    w = np.array([0.3, 0.7])

    def build(pm):
        return pm.Mixture.dist(w=w, comp_dists=[pm.Poisson.dist(mu=2.0),
                                                pm.Poisson.dist(mu=9.0)])
    dj, dt = build(pj), build(pt)
    assert dt.dtype == dj.dtype == np.dtype("int32")
    np.testing.assert_array_equal(dt.default(), dj.default())
    grid = GRID[GRID >= 0]
    _same(dt.logp(torch.from_numpy(grid)).numpy(),
          dj.logp(jnp.asarray(grid)))
    x = dt.random(size=20000, gen=torch.Generator().manual_seed(4)).astype(
        np.float64)
    assert abs(x.mean() - (0.3 * 2 + 0.7 * 9)) < 0.15
