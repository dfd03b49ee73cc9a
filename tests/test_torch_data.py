"""The port's ``Data``, ``Minibatch`` and ``total_size`` against the JAX
package on the CPU (mirrors ``tests/test_minibatch.py`` and
``tests/test_data_container.py``).

Rows are compared exactly: for the same seed both packages shuffle with
``np.random.RandomState(seed).permutation``, so the same offset selects the
same rows. Log-densities with ``total_size`` agree to rtol 1e-5 (float32).
"""
import numpy as np
import pytest
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.data import MinibatchNode as JMinibatch, RNG_ENV_KEY as JKEY
from pymc3_tpu_torch.data import (MinibatchNode, RNG_ENV_KEY, minibatch_nodes,
                                  minibatch_noise)

from . import torch_models  # noqa: F401  (the port on the CPU)

torch.set_num_threads(2)


def _rows(mb, r):
    """The port's minibatch for the entry ``r``."""
    return mb._eval_default({RNG_ENV_KEY: {mb.noise_key: torch.as_tensor(r)}},
                            {}).numpy()


def test_window_indices_none_match_test_value():
    data = np.arange(40, dtype=np.float32).reshape(20, 2)
    mb = MinibatchNode(data, batch_size=6, random_seed=7)
    assert mb.sampling == "window"
    np.testing.assert_array_equal(data[mb.indices().numpy()],
                                  mb._test_value)
    np.testing.assert_array_equal(
        mb._test_value, np.asarray(JMinibatch(data, 6, random_seed=7)
                                   ._test_value))


def test_window_rows_match_jax_for_the_same_offset():
    """The JAX package's offset for a key, replayed: the same rows, and
    ``indices`` names their positions in the user's array."""
    data = np.arange(60, dtype=np.float32).reshape(30, 2)
    jmb = JMinibatch(data, batch_size=5, random_seed=3)
    mb = MinibatchNode(data, batch_size=5, random_seed=3)
    for seed in range(6):
        key = jax.random.PRNGKey(seed)
        r = int(jax.random.randint(jax.random.fold_in(key, jmb._fold), (), 0,
                                   30))
        want = np.asarray(jmb._eval_default({JKEY: key}, {}))
        np.testing.assert_array_equal(_rows(mb, r), want)
        np.testing.assert_array_equal(data[mb.indices(r).numpy()], want)


@pytest.mark.parametrize("bs", [10, 17])
def test_batch_size_at_least_data_falls_back_to_random(bs):
    data = np.arange(10, dtype=np.float32)
    mb = MinibatchNode(data, batch_size=bs, random_seed=1)
    assert mb.sampling == "random"
    gen = torch.Generator().manual_seed(0)
    draw = minibatch_noise([mb], gen, 1)
    out = mb._eval_default({RNG_ENV_KEY: {k: v[0] for k, v in draw.items()}},
                           {}).numpy()
    assert out.shape == (bs,)
    assert set(out.tolist()) <= set(data.tolist())


def test_window_marginal_row_probability_uniform():
    data = np.arange(16, dtype=np.float32)
    mb = MinibatchNode(data, batch_size=4, random_seed=0)
    gen = torch.Generator().manual_seed(42)
    draws = minibatch_noise([mb], gen, 400)[mb.noise_key]
    counts = np.zeros(16)
    for r in draws:
        counts[mb.indices(r).numpy()] += 1
    # each row expected 400 * 4/16 = 100 times; binomial sd ~ 8.7
    assert counts.min() > 55 and counts.max() < 145


def test_same_seed_views_stay_paired():
    X = np.arange(50, dtype=np.float32)
    y = np.arange(50, dtype=np.float32) * 10
    mbx = MinibatchNode(X, batch_size=8, random_seed=5)
    mby = MinibatchNode(y, batch_size=8, random_seed=5)
    assert mbx.noise_key == mby.noise_key
    for r in (0, 13, 49):
        np.testing.assert_array_equal(_rows(mby, r), _rows(mbx, r) * 10)


def test_minibatch_under_vmap_takes_each_samples_rows():
    """Under ``torch.func.vmap`` each sample gathers its own rows."""
    data = np.arange(20, dtype=np.float32).reshape(10, 2)
    mb = MinibatchNode(data, batch_size=3, random_seed=1)
    r = torch.tensor([0, 4, 9])
    out = torch.func.vmap(lambda ri: mb._eval_default(
        {RNG_ENV_KEY: {mb.noise_key: ri}}, {}))(r)
    for i in range(3):
        np.testing.assert_array_equal(out[i].numpy(), _rows(mb, int(r[i])))


def _logistic(pm, N=200, d=3, batch=25, total_size=True):
    rng = np.random.RandomState(4)
    X = rng.randn(N, d).astype(np.float32)
    y = (rng.uniform(size=N) < 0.4).astype(np.float32)
    X_mb, y_mb = pm.Minibatch(X, batch), pm.Minibatch(y, batch)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 1.0, shape=d)
        s = pm.HalfNormal("s", 1.0)
        p = pm.math.invlogit(pm.math.dot(X_mb, w) * s)
        pm.Bernoulli("obs", p=p, observed=y_mb,
                     total_size=N if total_size else None)
    return model


@pytest.mark.parametrize("total_size", [True, False])
def test_total_size_scales_the_minibatch_logp_as_jax(total_size):
    """The logp at a point and a replayed offset, with and without
    ``total_size``, against the JAX package's ``make_logp_fn(with_rng)``."""
    jm, tm = _logistic(pj, total_size=total_size), \
        _logistic(pt, total_size=total_size)
    q = np.random.RandomState(0).randn(4).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jmb = jm.observed_RVs[0].data_node
    r = int(jax.random.randint(jax.random.fold_in(key, jmb._fold), (), 0,
                               200))
    want = float(jax.jit(jm.make_logp_fn(with_rng=True))(q, key))
    node = minibatch_nodes(tm)[0]
    got = float(tm.logp_point_fn()(torch.as_tensor(q),
                                   {node.noise_key: torch.tensor(r)}))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert tm["obs"].scaling == (8.0 if total_size else 1.0)


@pytest.mark.parametrize("total_size,shape,want", [
    (None, (5,), 1.0), (10, (5,), 2.0), (10, (), 10.0),
    ([20, None], (5, 3), 4.0), ([Ellipsis, 9], (5, 3), 3.0),
    ([4, Ellipsis, 9], (2, 7, 3), 6.0)])
def test_get_scaling_matches_jax(total_size, shape, want):
    from pymc3_tpu.model import _get_scaling as jax_scaling
    from pymc3_tpu_torch.model import _get_scaling
    got = _get_scaling(total_size, shape, len(shape))
    assert got == jax_scaling(total_size, shape, len(shape)) == want


def test_free_rv_total_size_scales_its_term():
    with pt.Model() as m:
        pt.Normal("a", 0.0, 1.0, shape=4, total_size=12)
    with pj.Model() as jm:
        pj.Normal("a", 0.0, 1.0, shape=4, total_size=12)
    pt_ = {"a": np.full(4, 0.5, np.float32)}
    np.testing.assert_allclose(m.logp(pt_), jm.logp(pt_), rtol=1e-6)
    np.testing.assert_allclose(m.logp(pt_), 3.0 * 4 * (
        -0.5 * np.log(2 * np.pi) - 0.125), rtol=1e-6)


def test_symbolic_logp_nodes_match_jax():
    """``logpt``, ``logp_nojact``, ``varlogpt`` and ``datalogpt``."""
    def build(pm):
        with pm.Model() as m:
            mu = pm.Normal("mu", 0.0, 2.0)
            sd = pm.HalfNormal("sd", 1.5)
            pm.Normal("y", mu, sd, observed=np.array([0.3, -0.2, 1.1]))
        return m
    jm, tm = build(pj), build(pt)
    point = {"mu": np.float32(0.4), "sd_log__": np.float32(-0.3)}
    for name in ("logpt", "logp_nojact", "varlogpt", "datalogpt"):
        want = float(getattr(jm, name).eval(
            {k: np.asarray(v) for k, v in point.items()}))
        got = float(getattr(tm, name).eval(
            {k: torch.as_tensor(v) for k, v in point.items()}))
        np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)
    np.testing.assert_allclose(tm.logp_nojac(point), jm.logp_nojac(point),
                               rtol=1e-5)


class TestDataContainer:
    """``tests/test_data_container.py`` on the port."""

    def test_data_as_observed_and_in_deterministic(self):
        data = np.array([0.5, 0.4, 5.0, 2.0])
        with pt.Model() as m:
            X = pt.Data("X", data)
            mu = pt.Normal("mu", 0.0, 1.0)
            pt.Deterministic("shifted", X + mu)
            pt.Normal("y", mu=mu, sigma=1.0, observed=X)
            assert np.isfinite(m.logp(m.test_point))
            tr = pt.sample(draws=30, tune=30, chains=1, progressbar=False,
                           compute_convergence_checks=False, random_seed=4)
        np.testing.assert_allclose(tr["shifted"][0], data + tr["mu"][0],
                                   rtol=1e-4)

    def test_sample_with_data_likelihood(self):
        rng = np.random.default_rng(0)
        x = np.linspace(0.0, 1.0, 30)
        y = 2.0 * x + rng.normal(scale=0.05, size=30)
        with pt.Model():
            xs = pt.Data("xs", x)
            beta = pt.Normal("beta", 0.0, 5.0)
            pt.Normal("obs", mu=beta * xs, sigma=0.05, observed=y)
            tr = pt.sample(draws=200, tune=200, chains=2, progressbar=False,
                           compute_convergence_checks=False, random_seed=1)
        assert abs(tr["beta"].mean() - 2.0) < 0.05

    def test_posterior_predictive_after_set_data(self):
        x_train = np.array([0.0, 1.0, 2.0, 3.0])
        y_train = np.array([0.1, 2.0, 3.9, 6.1])
        x_test = np.array([10.0, 20.0])
        with pt.Model():
            xs = pt.Data("xs", x_train)
            ys = pt.Data("ys", y_train)
            beta = pt.Normal("beta", 0.0, 10.0)
            pt.Normal("obs", mu=beta * xs, sigma=0.2, observed=ys)
            tr = pt.sample(draws=200, tune=200, chains=2, progressbar=False,
                           compute_convergence_checks=False, random_seed=2)
            pt.set_data({"xs": x_test, "ys": np.zeros_like(x_test)})
            ppc = pt.sample_posterior_predictive(tr, samples=100,
                                                 progressbar=False)
        assert ppc["obs"].shape == (100, 2)
        np.testing.assert_allclose(ppc["obs"].mean(0), 2.0 * x_test,
                                   rtol=0.1)

    def test_sample_after_set_data_resizes(self):
        with pt.Model():
            xs = pt.Data("xs", np.array([1.0, 2.0, 3.0]))
            ys = pt.Data("ys", np.array([1.1, 2.1, 2.9]))
            b = pt.Normal("b", 0.0, 10.0)
            pt.Normal("obs", mu=b * xs, sigma=0.1, observed=ys)
            pt.sample(draws=50, tune=50, chains=1, progressbar=False,
                      compute_convergence_checks=False)
            pt.set_data({"xs": np.linspace(0.0, 5.0, 10),
                         "ys": 3.0 * np.linspace(0.0, 5.0, 10)})
            tr2 = pt.sample(draws=200, tune=200, chains=2, progressbar=False,
                            compute_convergence_checks=False, random_seed=3)
        assert abs(tr2["b"].mean() - 3.0) < 0.1

    def test_creation_outside_model_raises(self):
        with pytest.raises(TypeError):
            pt.Data("x", np.arange(3))

    def test_set_data_on_non_data_variable_raises(self):
        with pt.Model():
            pt.Normal("x", 0.0, 1.0)
            with pytest.raises(TypeError):
                pt.set_data({"x": np.array([1.0])})

    def test_data_naming_nested(self):
        with pt.Model() as outer:
            with pt.Model(name="sub"):
                pt.Data("d", np.array([1.0, 2.0]))
        assert "sub_d" in outer.named_vars

    def test_data_value_roundtrip(self):
        with pt.Model():
            d = pt.Data("d", np.array([1.0, 2.0, 3.0]))
            np.testing.assert_allclose(d.test_value, [1.0, 2.0, 3.0])
            pt.set_data({"d": np.array([4.0, 5.0])})
            np.testing.assert_allclose(d.test_value, [4.0, 5.0])
            assert d.version == 1 and d.get_value().dtype == np.float32


def test_generator_adapter_and_get_data():
    gen = pt.GeneratorAdapter(iter([np.ones(3), np.zeros(3)]))
    assert gen.shape == (3,)
    np.testing.assert_array_equal(next(gen), np.ones(3))
    np.testing.assert_array_equal(next(gen), np.zeros(3))
    node = pt.GeneratorAdapter(iter([np.arange(2.0)])).make_variable("g")
    np.testing.assert_array_equal(node.get_value(), [0.0, 1.0])
    assert pt.align_minibatches() is None
    with pytest.raises(FileNotFoundError):
        pt.get_data("no_such_file.csv")
