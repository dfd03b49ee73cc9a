"""The stepper names that keep the reference's one-chain class API, and the
functional Welford and diagonal-mass helpers, against the JAX package's.

- ``CpuLeapfrogIntegrator``: ``compute_state`` and one ``step`` from the
  same ``q``, ``p`` and diagonal mass on eight-schools; rtol 1e-5, atol
  1e-5 (float32, one logp+grad each, XLA's fused arithmetic against
  PyTorch's). A step to a non-finite energy raises ``IntegrationError``
  in both.
- ``DualAverageAdaptation`` fed the same accept statistics: step sizes
  (rtol 1e-5, float32 updates), statistics, and the text of
  ``warnings()``.
- ``welford_*`` and ``diag_*`` on the same numpy inputs, rtol 1e-6; the
  ``psum`` merges over eight chains in one process against the JAX
  package's over a ``vmap`` axis (``tests/test_parallel.py``'s and
  ``tests/test_quadpotential.py``'s cases); over two ranks they are in
  ``tests/test_torch_parallel.py``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.hmc import integration as jint
from pymc3_tpu.step_methods.hmc import quadpotential as jqp
from pymc3_tpu.step_methods import step_sizes as jss
from pymc3_tpu_torch.step_methods.hmc import integration as tint
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tqp
from pymc3_tpu_torch.step_methods import step_sizes as tss
from . import torch_models  # noqa: F401  (asks the port for the CPU)
from .torch_parallel_jobs import eight_schools

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _integrators():
    out = []
    for pm, mod in ((pj, jint), (pt, tint)):
        model = eight_schools(pm)
        n = model.ordering.size
        pot = pm.step_methods.hmc.quadpotential.QuadPotentialDiag(
            np.linspace(0.5, 2.0, n))
        out.append((mod.CpuLeapfrogIntegrator(pot, model.make_logp_dlogp_fn()),
                    n))
    return out


def test_leapfrog_integrator_step_matches_jax():
    (j, n), (t, _) = _integrators()
    rng = np.random.default_rng(1)
    q = rng.normal(size=n).astype(np.float32)
    p = rng.normal(size=n).astype(np.float32)
    sj, st = j.compute_state(q, p), t.compute_state(q, p)
    for _ in range(3):
        for field in sj._fields:
            np.testing.assert_allclose(
                getattr(st, field).numpy(), np.asarray(getattr(sj, field)),
                err_msg=field, **TOL)
        sj, st = j.step(0.05, sj), t.step(0.05, st)


def test_leapfrog_integrator_raises_on_a_non_finite_energy():
    (j, n), (t, _) = _integrators()
    q = np.zeros(n, np.float32)
    p = np.ones(n, np.float32)
    with pytest.raises(jint.IntegrationError):
        j.step(1e30, j.compute_state(q, p))
    with pytest.raises(tint.IntegrationError):
        t.step(1e30, t.compute_state(q, p))
    assert issubclass(tint.IntegrationError, RuntimeError)


@pytest.mark.parametrize("tuned_accept", [0.3, 0.8])
def test_dual_average_adaptation_matches_jax(tuned_accept):
    rng = np.random.default_rng(2)
    j = jss.DualAverageAdaptation(0.5, 0.8)
    t = tss.DualAverageAdaptation(0.5, 0.8)
    for i, accept in enumerate(np.r_[rng.uniform(0.2, 1.0, 60),
                                     np.full(40, tuned_accept)]):
        tune = i < 60
        np.testing.assert_allclose(t.current(tune), j.current(tune),
                                   rtol=1e-5)
        j.update(float(accept), tune)
        t.update(float(accept), tune)
    assert t.stats().keys() == j.stats().keys()
    for k, v in j.stats().items():
        np.testing.assert_allclose(t.stats()[k], v, rtol=1e-5)
    wj, wt = j.warnings(), t.warnings()
    assert len(wt) == len(wj) == (1 if tuned_accept == 0.3 else 0)
    for a, b in zip(wt, wj):
        assert (a.kind.name, a.message, a.level) == \
            (b.kind.name, b.message, b.level)
    t.reset(0.25)
    assert t.current(True) == pytest.approx(0.25) and t.warnings() == []


def _np(state):
    return [np.asarray(x) for x in state]


@pytest.mark.parametrize("weight", [0.0, 5.0])
def test_welford_functions_match_jax(weight):
    rng = np.random.default_rng(3)
    mean0, var0 = rng.normal(size=3), rng.uniform(0.5, 2.0, 3)
    xs = rng.normal(size=(40, 3)).astype(np.float32)
    j = jqp.welford_init(3, mean0, var0, weight)
    t = tqp.welford_init(3, mean0, var0, weight)
    jc = jqp.welford_cov_init(3, mean0, np.diag(var0), weight)
    tc = tqp.welford_cov_init(3, mean0, np.diag(var0), weight)
    for a, b in zip(_np(t) + _np(tc), _np(j) + _np(jc)):
        np.testing.assert_allclose(a, b, rtol=1e-6)
    for x in xs:
        j, jc = jqp.welford_add(j, x), jqp.welford_cov_add(jc, x)
        xt = torch.from_numpy(x)
        t, tc = tqp.welford_add(t, xt), tqp.welford_cov_add(tc, xt)
    for a, b in zip(_np(t) + _np(tc) + [tqp.welford_var(t).numpy()],
                    _np(j) + _np(jc) + [np.asarray(jqp.welford_var(j))]):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_welford_init_of_several_chains():
    st = tqp.welford_init(3, init_mean=torch.zeros(5, 3), init_var=np.ones(3),
                          init_weight=2.0)
    assert st.w.shape == (5,) and st.m2.shape == (5, 3)
    np.testing.assert_array_equal(st.m2.numpy(), 2.0)
    cov = tqp.welford_cov_init(3, init_mean=torch.zeros(5, 3))
    assert cov.w.shape == (5,) and cov.m2.shape == (5, 3, 3)


def test_welford_psum_merge_is_the_jax_packages():
    """``tests/test_parallel.py::test_welford_psum_merge_is_exact``'s
    eight shards as eight chains of one batched state."""
    data = np.random.default_rng(0).normal(size=(8, 50, 3)).astype(
        np.float32)

    def shard_fn(xs):
        st, _ = jax.lax.scan(lambda s, x: (jqp.welford_add(s, x), None),
                             jqp.welford_init(3), xs)
        return jqp.welford_merge_psum(st, "shards")

    want = jax.vmap(shard_fn, axis_name="shards")(jnp.asarray(data))
    st = tqp.welford_init(3, init_mean=torch.zeros(8, 3))
    for i in range(data.shape[1]):
        st = tqp.welford_add(st, torch.from_numpy(data[:, i]))
    got = tqp.welford_merge_psum(st, "shards")
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5)
    flat = data.reshape(-1, 3).astype(np.float64)
    np.testing.assert_allclose(tqp.welford_var(got).numpy()[0], flat.var(0),
                               rtol=2e-4)


def test_welford_cov_psum_merge_is_the_jax_packages():
    """``tests/test_quadpotential.py``'s dense merge over four chains."""
    X = np.random.RandomState(8).randn(4, 50, 2).astype(np.float32)

    def per_chain(xs):
        st = jqp.welford_cov_init(2)
        for i in range(xs.shape[0]):
            st = jqp.welford_cov_add(st, xs[i])
        return jqp.welford_cov_merge_psum(st, "c")

    want = jax.vmap(per_chain, axis_name="c")(jnp.asarray(X))
    st = tqp.welford_cov_init(2, init_mean=torch.zeros(4, 2))
    for i in range(X.shape[1]):
        st = tqp.welford_cov_add(st, torch.from_numpy(X[:, i]))
    got = tqp.welford_cov_merge_psum(st, "c")
    for a, b in zip(_np(got), _np(want)):
        np.testing.assert_allclose(a, b, rtol=2e-5, atol=1e-5)
    est = got.m2[0].numpy() / (float(got.w[0]) - 1.0)
    np.testing.assert_allclose(est, np.cov(X.reshape(-1, 2).T), atol=1e-4)


def test_diag_functions_match_jax():
    rng = np.random.default_rng(4)
    var = rng.uniform(0.5, 2.0, 5).astype(np.float32)
    p = rng.normal(size=5).astype(np.float32)
    vt, pt_ = torch.from_numpy(var), torch.from_numpy(p)
    np.testing.assert_allclose(tqp.diag_velocity(vt, pt_).numpy(),
                               np.asarray(jqp.diag_velocity(var, p)),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tqp.diag_kinetic(vt, pt_)),
                               float(jqp.diag_kinetic(var, p)), rtol=1e-6)
    inv_stds = 1.0 / torch.sqrt(vt)
    got = tqp.diag_random(torch.Generator().manual_seed(7), inv_stds)
    z = torch.randn(5, generator=torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(got.numpy(), (inv_stds * z).numpy())
    want = jqp.diag_random(jax.random.PRNGKey(0), jnp.asarray(inv_stds))
    assert got.shape == want.shape and got.dtype == torch.float32
