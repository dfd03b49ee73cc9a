"""The port's fifteen examples of ``tests/test_examples.py`` against the JAX
package's, on the CPU.

- Each example's model is built by both packages from the same numpy data
  (each module makes its own from the same seed; the tests check that the
  data agree). The free variables agree in name and shape, and logp and its
  gradient agree at the test point and two seeded jitters of it (three
  jitters for ``arbitrary_stochastic``, whose test point is the kink of
  ``|x|``) within
  rtol 1e-5 in float32; the absolute tolerance is 1e-5 times the largest
  value of the compared array (at least 1), because both packages sum the
  same float32 terms over the data rows in another order.
- ``arma_example`` writes the innovations as a Toeplitz product: it is
  held against the recurrence itself, looped in float64.
- ``factor_potential`` is sampled to its closed form N(1/3, 1/3) and
  ``lasso_missing`` imputes 0/1 values that mix.
"""
import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pymc3_tpu.model import ValueGradFunction as JaxVGF
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)

EXAMPLES = ["gelman_schools", "gelman_bioassay", "baseball",
            "lightspeed_example", "factor_potential", "censored_data",
            "glm_hierarchical", "custom_dists", "arbitrary_stochastic",
            "rankdata_ordered", "arma_example", "samplers_mvnormal",
            "gp_example", "minibatch_advi_logistic", "lasso_missing"]
RTOL = 1e-5


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _modules(name):
    return (importlib.import_module(f"pymc3_tpu.examples.{name}"),
            importlib.import_module(f"pymc3_tpu_torch.examples.{name}"))


def _build(name, module):
    """The example's model from its own builders; the data-dependent ones
    at a small size (the same numpy data in both packages)."""
    if name == "gp_example":
        return module.build_marginal(*module.make_data(n=20))[0]
    if name == "minibatch_advi_logistic":
        # one batch of all rows: without a minibatch draw the JAX package's
        # window view reads other rows than its test value (see
        # test_minibatch_logp_without_a_draw_reads_the_test_value)
        X, y, _ = module.make_data(n=400, d=5, seed=3)
        return module.build_model(X, y, batch_size=400)
    if name == "samplers_mvnormal":
        return module.build_model(d=4)[0]
    return module.build_model()


def _points(model, seed, at_test_point=True):
    """The test point and two jitters of it (three jitters without it):
    continuous coordinates moved by N(0, 0.3²), imputed discrete ones drawn
    from {0, 1}."""
    rng = np.random.RandomState(seed)
    q0 = model.dict_to_array(model.test_point).astype(np.float64)
    discrete = np.zeros(q0.size, bool)
    for vm in model.ordering.vmap:
        if any(v.name == vm.var for v in model.disc_vars):
            discrete[vm.slc] = True
    rows = [q0] if at_test_point else []
    for _ in range(3 - len(rows)):
        q = q0 + 0.3 * rng.randn(q0.size)
        q[discrete] = rng.randint(0, 2, discrete.sum())
        rows.append(q)
    return np.stack(rows).astype(np.float32)


def _close(got, want, what):
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * scale,
                               err_msg=what)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_matches_jax_package(name):
    jmod, tmod = _modules(name)
    mj, mt = _build(name, jmod), _build(name, tmod)
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    assert sorted(mt.named_vars) == sorted(mj.named_vars)
    # arbitrary_stochastic's test point is the kink of |x|, where the
    # packages take different subgradients (JAX 1, torch 0)
    q = _points(mj, seed=EXAMPLES.index(name),
                at_test_point=name != "arbitrary_stochastic")
    vag = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))
    lj, gj = (np.asarray(a) for a in vag(jnp.asarray(q)))
    lt, gt = (a.numpy() for a in mt.logp_dlogp_function()(
        torch.from_numpy(q)))
    assert np.all(np.isfinite(lj)) and np.all(np.isfinite(gj))
    _close(lt, lj, f"{name} logp")
    _close(gt, gj, f"{name} gradient")


@pytest.mark.parametrize("name,arrays", [
    ("censored_data", ("samples", "uncensored")),
    ("custom_dists", ("xdata", "ydata")),
    ("rankdata_ordered", ("yreal", "y_argsort")),
    ("arma_example", ("y_data",)),
    ("lasso_missing", ("score", "male", "siblings", "disability", "age",
                       "mother_hs", "early_ident")),
])
def test_example_data_equal_the_jax_packages(name, arrays):
    jmod, tmod = _modules(name)
    for a in arrays:
        np.testing.assert_array_equal(getattr(tmod, a), getattr(jmod, a))


def test_minibatch_logp_without_a_draw_reads_the_test_value():
    """With no minibatch draw, the port's logp reads the rows of the view's
    test value (the leading rows of the once-shuffled copy). The JAX
    package's window view reads the shuffled copy at the permutation's
    positions instead (``pymc3_tpu/data.py:225-230``), other rows than its
    own test value, so the packages are compared above with one batch of
    all rows."""
    import pymc3_tpu_torch as pt
    from pymc3_tpu_torch.examples.minibatch_advi_logistic import (
        build_model, make_data)
    X, y, _ = make_data(n=2000, d=5, seed=3)
    model = build_model(X, y, batch_size=250)
    joint = pt.data.minibatch_nodes(model)[0]
    rows = np.asarray(joint.test_value, np.float64)
    w = np.random.RandomState(0).randn(5) * 0.3
    logits = rows[:, :-1] @ w
    want = (2000 / 250) * np.sum(rows[:, -1] * logits
                                 - np.logaddexp(0.0, logits)) \
        + np.sum(-0.5 * (w / 10.0) ** 2 - np.log(10.0)
                 - 0.5 * np.log(2 * np.pi))
    got = model.logp({"w": w.astype(np.float32)})
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_glm_hierarchical_reads_the_same_radon_table():
    from pymc3_tpu.examples.glm_hierarchical import load_radon as jload
    from pymc3_tpu_torch.examples.radon import load_radon
    floor, county_idx, n_counties, log_radon = load_radon()
    data = jload()
    np.testing.assert_array_equal(county_idx, data.county_code.values)
    assert n_counties == len(data.county.unique())
    np.testing.assert_array_equal(floor, data.floor.values)
    np.testing.assert_array_equal(
        log_radon, data.log_radon.astype(np.float32).values)


@pytest.mark.parametrize("theta", [-1.3, -0.4, 0.0, 0.7, 1.1])
def test_arma_innovations_equal_the_recurrence(theta):
    """The Toeplitz product against ``err_t = y_t - (mu + phi y_{t-1} +
    theta err_{t-1})`` looped in float64, the JAX example's scan."""
    from pymc3_tpu_torch.examples.arma_example import (
        _toeplitz_exponents, err_seq, y_data)
    mu, phi = 0.3, -0.6
    y = y_data.astype(np.float64)
    want = np.empty_like(y)
    want[0] = y[0] - (mu + phi * mu)
    for t in range(1, len(y)):
        want[t] = y[t] - (mu + phi * y[t - 1] + theta * want[t - 1])
    e, lower = (torch.from_numpy(a).double()
                for a in _toeplitz_exponents(len(y)))
    got = err_seq(torch.tensor(mu, dtype=torch.float64),
                  torch.tensor(phi, dtype=torch.float64),
                  torch.tensor(theta, dtype=torch.float64),
                  torch.from_numpy(y), e, lower)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-9 * np.abs(want).max())


def test_factor_potential_samples_its_closed_form():
    """N(1, 1) times exp(-x²) is N(1/3, 1/3) (``tests/test_examples.py``
    ``test_factor_potential``)."""
    import pymc3_tpu_torch as pt
    from pymc3_tpu_torch.examples.factor_potential import build_model
    with build_model():
        trace = pt.sample(draws=300, tune=300, chains=4, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    x = np.asarray(trace["x"])
    assert abs(x.mean() - 1.0 / 3.0) < 0.1
    assert abs(x.var() - 1.0 / 3.0) < 0.1


def test_lasso_missing_imputes_binary_values_that_mix():
    """``tests/test_examples.py::test_lasso_missing_imputation`` on the
    port: the masked indicators become ``_missing`` free variables sampled
    by the compound step, and take 0/1 values that move."""
    import pymc3_tpu_torch as pt
    from pymc3_tpu_torch.examples.lasso_missing import build_model
    model = build_model()
    missing = {v.name for v in model.free_RVs if "missing" in v.name}
    assert missing == {"disability_imp_missing", "mother_imp_missing"}
    assert {v.name for v in model.missing_values} == missing
    with model:
        trace = pt.sample(draws=40, tune=40, chains=2, progressbar=False,
                          random_seed=1, compute_convergence_checks=False)
    imputed = np.asarray(trace["disability_imp_missing"])
    assert set(np.unique(imputed)) <= {0.0, 1.0}
    assert np.unique(np.asarray(trace["mother_imp_missing"]).sum(1)).size > 1


# -- repairs: the port's data and its normal log cdf -------------------------
ROOT = __import__("pathlib").Path(__file__).resolve().parents[1]


def test_get_data_returns_the_packaged_test_scores():
    import pymc3_tpu_torch as pt
    want = (ROOT / "pymc3_tpu" / "examples" / "data" /
            "test_scores.csv").read_bytes()
    assert pt.get_data("test_scores.csv").read() == want


def _code_strings(path):
    """The string literals of a source file that are not docstrings."""
    import ast
    tree = ast.parse(path.read_text(), str(path))
    docstrings = set()
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if isinstance(body, list) and body and isinstance(body[0], ast.Expr) \
                and isinstance(body[0].value, ast.Constant) \
                and isinstance(body[0].value.value, str):
            docstrings.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)
            and id(n) not in docstrings]


def test_the_port_names_no_file_of_the_jax_package():
    """No string in the port's code (comments and docstrings aside) names
    the JAX package's directory, and every data path of the port lies in
    it: a machine with the port alone builds every example."""
    from pymc3_tpu_torch import data
    from pymc3_tpu_torch.examples import radon
    bad = [(p.relative_to(ROOT).as_posix(), s)
           for p in sorted((ROOT / "pymc3_tpu_torch").rglob("*.py"))
           for s in _code_strings(p)
           if s == "pymc3_tpu" or "pymc3_tpu/" in s or "pymc3_tpu\\" in s]
    assert not bad, bad
    port = ROOT / "pymc3_tpu_torch"
    for path in [radon.DATA] + list(data._DATA_SEARCH_PATHS):
        assert port in __import__("pathlib").Path(path).resolve().parents
    assert radon.DATA.exists()


def test_normal_log_cdf_is_batched_under_vmap():
    """``normal_lcdf``/``normal_lccdf`` ran ``torch.special.log_ndtr``,
    which has no ``vmap`` batching rule: under ``vmap`` it ran once per
    lane. They now take erfcx/erfc, batched, with the same values."""
    import warnings
    from pymc3_tpu_torch.distributions.dist_math import (normal_lccdf,
                                                         normal_lcdf)
    x = torch.linspace(-30.0, 8.0, 4000, dtype=torch.float64).reshape(8, -1)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        lo = torch.func.vmap(lambda v: normal_lcdf(0.5, 1.5, v))(x)
        hi = torch.func.vmap(lambda v: normal_lccdf(0.5, 1.5, v))(x)
    assert not [w for w in caught if "batching rule" in str(w.message)]
    z = (x - 0.5) / 1.5
    np.testing.assert_allclose(lo, torch.special.log_ndtr(z), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(hi, torch.special.log_ndtr(-z), rtol=1e-12,
                               atol=1e-12)
