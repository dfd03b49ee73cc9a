"""Every ``init`` string of the JAX package's ``init_nuts`` on the port, and
the host-side API of the adaptive diagonal potential against the JAX
package's."""
import numpy as np
import pytest
import torch

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.hmc import quadpotential as jq
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tq

from . import torch_models  # noqa: F401

torch.set_num_threads(2)

INITS = ["auto", "adapt_diag", "jitter+adapt_diag", "advi+adapt_diag",
         "advi+adapt_diag_grad", "advi", "advi_map", "map", "adapt_full",
         "jitter+adapt_full", "nuts"]
POTENTIAL = {"advi+adapt_diag": tq.QuadPotentialDiagAdapt,
             "advi+adapt_diag_grad": tq.QuadPotentialDiagAdapt,
             "advi": tq.QuadPotentialDiag, "advi_map": tq.QuadPotentialDiag,
             "map": tq.QuadPotentialFull}


def _model(pm):
    y = np.array([1.2, 0.4, 2.2, 1.7, 0.9, 1.5], np.float32)
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 5.0)
        sd = pm.HalfNormal("sd", 2.0)
        pm.Normal("obs", mu=mu, sigma=sd, observed=y)
    return m


def test_the_port_accepts_every_init_the_jax_package_documents():
    import re
    doc = " ".join(pj.init_nuts.__doc__.split())
    documented = re.search(r"Strategies: (.*?)\.", doc).group(1)
    names = [s.strip() for s in documented.split(",")]
    names = [n.replace("and ", "") for n in names]
    assert sorted(names) == sorted(INITS)


@pytest.mark.parametrize("init", INITS)
def test_init_nuts_and_a_short_run(init):
    m = _model(pt)
    start, step = pt.init_nuts(init=init, chains=3, n_init=1000, model=m,
                               random_seed=4, progressbar=False)
    assert len(start) == 3
    for point in start:
        assert set(point) >= {"mu", "sd_log__"}
        assert np.isfinite(m.logp({k: point[k] for k in ("mu", "sd_log__")}))
    if init in POTENTIAL:
        assert type(step.potential) is POTENTIAL[init]
    tr = pt.sample(draws=20, tune=20, chains=3, model=m, init=init,
                   n_init=1000, random_seed=4, progressbar=False,
                   compute_convergence_checks=False)
    assert np.isfinite(tr["mu"]).all() and tr["mu"].shape == (60,)


def test_advi_init_starts_near_the_jax_fit():
    """``advi+adapt_diag``: the starting mean and variances of the mass
    matrix against the JAX package's ADVI fit of the same model (two fits
    on different random streams: within a quarter of the posterior sd and
    40% in variance)."""
    tm, jm = _model(pt), _model(pj)
    _, tstep = pt.init_nuts(init="advi+adapt_diag", chains=2, n_init=4000,
                            model=tm, random_seed=3, progressbar=False)
    _, jstep = pj.init_nuts(init="advi+adapt_diag", chains=2, n_init=4000,
                            model=jm, random_seed=3, progressbar=False)
    tpot, jpot = tstep.potential, jstep.potential
    sd = np.sqrt(np.asarray(jpot._initial_diag))
    assert np.all(np.abs(tpot._initial_mean
                         - np.asarray(jpot._initial_mean)) < 0.25 * sd)
    np.testing.assert_allclose(tpot._initial_diag,
                               np.asarray(jpot._initial_diag), rtol=0.4)
    assert tpot._initial_weight == 50


def test_map_init_uses_the_inverse_hessian():
    tm = _model(pt)
    start, step = pt.init_nuts(init="map", chains=2, model=tm,
                               progressbar=False)
    H = pt.find_hessian(start[0], model=tm)
    np.testing.assert_allclose(step.potential._cov, np.linalg.inv(H),
                               rtol=1e-4)
    jm = _model(pj)
    jstart, _ = pj.init_nuts(init="map", chains=2, model=jm,
                             progressbar=False)
    np.testing.assert_allclose(start[0]["mu"], jstart[0]["mu"], rtol=1e-3)


def test_diag_adapt_host_api_matches_jax():
    """``update``, ``velocity``, ``energy`` and ``reset`` of one chain."""
    n = 3
    mean = np.array([0.5, -1.0, 2.0], np.float32)
    diag = np.array([1.0, 2.0, 0.5], np.float32)
    tpot = tq.QuadPotentialDiagAdapt(n, mean, diag, 10, adaptation_window=4)
    jpot = jq.QuadPotentialDiagAdapt(n, mean, diag, 10, adaptation_window=4)
    rng = np.random.RandomState(0)
    x = rng.randn(n).astype(np.float32)
    for i in range(9):
        s = rng.randn(n).astype(np.float32)
        tpot.update(s, None, True)
        jpot.update(s, None, True)
        np.testing.assert_allclose(tpot.velocity(x), jpot.velocity(x),
                                   rtol=1e-5)
    np.testing.assert_allclose(tpot.energy(x), jpot.energy(x), rtol=1e-5)
    tpot.update(rng.randn(n), None, False)
    np.testing.assert_allclose(tpot.velocity(x), jpot.velocity(x), rtol=1e-5)
    np.random.seed(1)
    r = tpot.random()
    assert r.shape == (n,) and np.isfinite(r).all()
    tpot.reset()
    np.testing.assert_allclose(tpot.velocity(x), diag * x, rtol=1e-6)


@pytest.mark.parametrize("bad,word", [(0.0, "zero"), (np.inf, "non-finite")])
def test_raise_ok_names_the_variable(bad, word):
    m = _model(pt)
    pot = tq.QuadPotentialDiagAdapt(2, np.zeros(2), np.ones(2), 10)
    pot._state = pot._state._replace(
        var=torch.tensor([[1.0, bad]], dtype=torch.float32))
    with pytest.raises(ValueError, match=f"`sd_log__`.ravel\\(\\)\\[1\\] is "
                       f"{word}"):
        pot.raise_ok(m.ordering.vmap)
    pot.reset()
    pot.raise_ok(m.ordering.vmap)


def test_diag_adapt_grad_tracks_squared_gradients():
    pot = tq.QuadPotentialDiagAdaptGrad(2, np.zeros(2), np.ones(2), 10)
    pot.update(np.ones(2), np.array([2.0, -3.0]), True)
    np.testing.assert_allclose(pot._grad_state.mean[0].numpy(), [4.0, 9.0])
    assert isinstance(pot, tq.QuadPotentialDiagAdapt)
