"""The port's ODE solver against the JAX package's, on the same inputs.

- Solutions of exponential decay, freefall, ``test_ode_matrix.py``'s SIR
  with recovery and the SIR model of PyMC3's ODE notebook, by the adaptive
  DOPRI5 solver and by fixed-grid RK4: with both packages in float64 they
  agree to rtol 1e-7 (the same steps; the stage sums are added in another
  order); in float32 to the solver's own ``rtol`` (1e-4) with atol 1e-4 x
  the largest state: float32 rounding can move an error estimate across
  the acceptance boundary, and the two packages then take different
  accepted-step sequences, a step apart, each within its tolerance.
- The calibrated ``max_steps`` is the same in both, in float64 for every
  system and in float32 but for the SIR notebook's. There the float32
  error estimate at twice the test point's theta is rounding noise (err
  norm far below 1), so the step-size controller follows the rounding;
  and the JAX package's compiled loop rounds differently from any
  sequence of PyTorch ops, since XLA on the CPU contracts a multiply and
  an add into one fused multiply-add (``jax.jit(lambda a, b, c: a * b +
  c)`` differs from numpy's float32 result in about a quarter of the
  entries). Its attempt counts (25 and 28) stay within 3, so the bounds
  within 9.
- The logp and gradient of the freefall and SIR models at a few points
  match ``jax.value_and_grad`` (rtol 1e-4, atol 1e-4 x the largest
  gradient, as the port's other model tests).
- Running out of ``max_steps`` gives NaN rows and a logp that is not finite
  in both.
- The early-exit ``Function`` equals the plain full-length masked loop
  (``solve_adaptive_reference``, which evaluates ``func`` through
  ``torch.func.vmap``) in value, gradient and second derivative, on lanes
  that finish at different iterations, one of them running out of steps
  (float64, rtol 1e-10). A ``func`` that does not broadcast over lanes
  falls back to ``vmap``.
- A batch of chains under ``vmap`` equals each chain solved alone.
- The validation errors match ``test_ode_matrix.py``'s cases, message for
  message.
- A short ``sample()`` of freefall runs end to end on the CPU.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model import ValueGradFunction as JaxVGF
from pymc3_tpu.node import evaluate as jeval
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.examples import suite
from pymc3_tpu_torch.node import evaluate as teval
from pymc3_tpu_torch.ode import ode as tode
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)


@pytest.fixture
def f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


@pytest.fixture
def f64():
    prev = jax.config.jax_enable_x64, pj.get_config().floatX
    pj.set_config(floatX="float64")
    pt.set_config(floatX="float64")
    yield
    pt.set_config(floatX="float32")
    pj.set_config(floatX=prev[1])
    jax.config.update("jax_enable_x64", prev[0])


def _decay(y, t, p):
    return -p[0] * y[0]


def _freefall(y, t, p):
    return 2.0 * p[1] - p[0] * y[0]


def _sir_recovery(y, t, p):
    return [-p[0] * y[0] * y[1], p[0] * y[0] * y[1] - p[1] * y[1]]


# name: (func, times, n_states, n_theta, t0, y0, theta)
SYSTEMS = {
    "decay": (_decay, np.linspace(0.25, 4.0, 12), 1, 1, 0.0, [1.0], [0.7]),
    "freefall": (_freefall, np.arange(0, 10, 0.5), 1, 2, 0.0, [0.0],
                 [0.4, 9.8]),
    "sir_recovery": (_sir_recovery, np.linspace(0.2, 3.0, 7), 2, 2, 0.0,
                     [0.99, 0.01], [2.0, 0.5]),
    "sir_notebook": (suite.sir_rhs, suite.SIR_TIMES, 2, 2, 0.0,
                     [0.99, 0.01], [4.0, 1.0]),
}


def _solve(pm, name, method, **kwargs):
    func, times, n_states, n_theta, t0, y0, theta = SYSTEMS[name]
    ode = pm.ode.DifferentialEquation(func, times, n_states, n_theta, t0=t0,
                                      method=method, **kwargs)
    sol = ode(y0=y0, theta=theta)
    out = (teval if pm is pt else jeval)(sol, {})
    return np.asarray(out.numpy() if pm is pt else out, np.float64), ode


@pytest.mark.parametrize("method", ["rk45", "rk4"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_solution_float64(f64, name, method):
    got, _ = _solve(pt, name, method)
    want, _ = _solve(pj, name, method)
    assert got.dtype == want.dtype and np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-12)


@pytest.mark.parametrize("method", ["rk45", "rk4"])
@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_solution_float32(f32, name, method):
    got, ode = _solve(pt, name, method)
    want, _ = _solve(pj, name, method)
    assert np.all(np.isfinite(want))
    np.testing.assert_allclose(got, want, rtol=ode.rtol,
                               atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_calibrated_max_steps_float64(f64, name):
    _, ot = _solve(pt, name, "rk45")
    _, oj = _solve(pj, name, "rk45")
    assert ot.max_steps == oj.max_steps


@pytest.mark.parametrize("name", sorted(SYSTEMS))
def test_calibrated_max_steps_float32(f32, name):
    _, ot = _solve(pt, name, "rk45")
    _, oj = _solve(pj, name, "rk45")
    if name == "sir_notebook":
        assert abs(ot.max_steps - oj.max_steps) <= 9
    else:
        assert ot.max_steps == oj.max_steps


def test_freefall_solve_leaves_the_loop_early(f32):
    """The bench suite's freefall at gamma = 1 calibrates to 81 iterations
    (3 x 27 attempts at the worst probe); a logp+grad there leaves the loop
    within ``_CHECK_EVERY`` iterations of its last output."""
    func, times, _, _, t0, _, _ = SYSTEMS["freefall"]
    ode = pt.ode.DifferentialEquation(func, times, 1, 2, t0=t0)
    with pt.Model() as model:
        gamma = pt.Lognormal("gamma", 0, 1, testval=1.0)
        pt.Normal("Y", mu=ode(y0=[0], theta=[gamma, 9.8])[:, 0], sigma=2.0,
                  observed=suite.ode_model_data())
    assert ode.max_steps == 81
    attempts = ode._count_steps([0.0], [1.0, 9.8])["attempts"]
    tode.ITERATIONS = tode.SOLVES = 0
    model.logp_dlogp_function()(
        convert.point_to_q(model, model.test_point)[None])
    assert tode.SOLVES == 1
    assert attempts <= tode.ITERATIONS < attempts + tode._CHECK_EVERY


def _points(model, n, seed, scale=0.3):
    rng = np.random.RandomState(seed)
    q0 = model.dict_to_array(model.test_point)
    return (q0 + scale * rng.randn(n, q0.size)).astype(np.float32)


def _freefall_model(pm):
    return suite.ode_model(pm)[0]


@pytest.mark.parametrize("build", [_freefall_model, suite.sir_model],
                         ids=["freefall", "sir"])
def test_model_logp_grad_matches_jax(f32, build):
    mt, mj = build(pt), build(pj)
    assert [(v.var, v.shp) for v in mt.ordering.vmap] == \
        [(v.var, v.shp) for v in mj.ordering.vmap]
    q = _points(mt, 4, seed=3)
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(JaxVGF(mj).jax_fn)))(
        jnp.asarray(q))
    lt, gt = mt.logp_dlogp_function()(torch.from_numpy(q))
    assert np.all(np.isfinite(np.asarray(lj)))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    scale = max(1.0, float(np.abs(np.asarray(gj)).max()))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-4,
                               atol=1e-4 * scale)


def _stiff_model(pm, xp):
    """y' = -lam (y - cos t) with max_steps = 3: every solve runs out."""
    times = np.arange(0.5, 3.0, 0.5)
    ode = pm.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * (y[0] - xp.cos(t)), times, n_states=1,
        n_theta=1, method="rk45", max_steps=3)
    with pm.Model() as model:
        lam = pm.Lognormal("lam", np.log(60.0), 0.1)
        sol = ode(y0=[1.0], theta=[lam])
        pm.Normal("obs", mu=sol[:, 0], sigma=0.1,
                  observed=np.cos(times).astype(np.float32))
    return model, sol


def test_max_steps_exhaustion(f32):
    mt, st = _stiff_model(pt, torch)
    mj, sj = _stiff_model(pj, jnp)
    rows_t = teval(st, {}).numpy()
    rows_j = np.asarray(jeval(sj, {}))
    np.testing.assert_array_equal(np.isnan(rows_t), np.isnan(rows_j))
    assert np.isnan(rows_t[-1]).all()
    lt = float(mt.logp_dlogp_function()(
        convert.point_to_q(mt, mt.test_point)[None])[0][0])
    lj = float(mj.logp(mj.test_point))
    assert not np.isfinite(lt) and not np.isfinite(lj)
    assert np.isnan(lt) == np.isnan(lj)


def _lanes(max_steps):
    """Driven decay lanes of rates 0.2, 2, 8 and 60: at float64's
    tolerances they write their last output at iterations 16, 60, 101 and
    428, so with ``max_steps`` 120 the last one runs out."""
    ode = pt.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * (y[0] - torch.cos(p[1] * t)),
        np.linspace(0.25, 3.0, 8), n_states=1, n_theta=2,
        max_steps=max_steps)
    theta = torch.tensor([[0.2, 1.0], [2.0, 3.0], [8.0, 0.5], [60.0, 2.0]],
                         dtype=torch.float64, requires_grad=True)
    y0 = torch.tensor([[1.0], [0.5], [-1.0], [2.0]], dtype=torch.float64,
                      requires_grad=True)
    return ode, y0, theta


def _loss(ys):
    w = torch.linspace(0.5, 1.5, ys[0].numel(), dtype=ys.dtype).reshape(
        ys.shape[1:])
    return torch.where(torch.isfinite(ys), ys * w, 0.0).sum()


def test_early_exit_equals_plain_loop(f64):
    ode, y0, theta = _lanes(max_steps=120)
    tode.ITERATIONS = 0
    ys = tode._AdaptiveSolve.apply(y0, theta, ode)[0]
    assert tode.ITERATIONS == ode.max_steps
    want = tode.solve_adaptive_reference(ode, y0, theta)
    # the stiffest lane ran out: NaN rows there, and only there
    finite = torch.isfinite(want).all(dim=2).all(dim=1)
    assert finite.tolist() == [True, True, True, False]
    np.testing.assert_array_equal(ys.detach().numpy(),
                                  want.detach().numpy())
    got_g = torch.autograd.grad(_loss(ys), (y0, theta), create_graph=True)
    want_g = torch.autograd.grad(_loss(want), (y0, theta),
                                 create_graph=True)
    for a, b in zip(got_g, want_g):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-10, atol=1e-12)
    # the second derivative, through the replayed backward
    h_got = torch.autograd.grad(got_g[1].sum(), theta)[0]
    h_want = torch.autograd.grad(want_g[1].sum(), theta)[0]
    np.testing.assert_allclose(h_got.numpy(), h_want.numpy(), rtol=1e-9,
                               atol=1e-12)


def test_early_exit_leaves_the_loop(f64):
    """With the three lanes that finish, the solve stops within
    ``_CHECK_EVERY`` iterations of the last output, far below max_steps,
    and equals the full-length loop."""
    ode, y0, theta = _lanes(max_steps=400)
    last = max(ode._count_steps(y0[i].detach(), theta[i].detach())[
        "attempts"] for i in range(3))
    assert last == 101
    tode.ITERATIONS = 0
    ys = tode._AdaptiveSolve.apply(y0[:3], theta[:3], ode)[0]
    assert last <= tode.ITERATIONS < last + tode._CHECK_EVERY
    np.testing.assert_array_equal(
        ys.detach().numpy(),
        tode.solve_adaptive_reference(ode, y0[:3], theta[:3]).detach()
        .numpy())


def test_exhausted_lane_leaves_others_alone(f64):
    ode, y0, theta = _lanes(max_steps=120)
    ys = tode._AdaptiveSolve.apply(y0, theta, ode)[0]
    alone = tode._AdaptiveSolve.apply(y0[:3], theta[:3], ode)[0]
    np.testing.assert_array_equal(ys[:3].detach().numpy(),
                                  alone.detach().numpy())
    g_all = torch.autograd.grad(_loss(ys), theta)[0]
    g_alone = torch.autograd.grad(_loss(alone), theta)[0]
    np.testing.assert_allclose(g_all[:3].numpy(), g_alone[:3].numpy(),
                               rtol=1e-12)
    assert torch.isfinite(g_all).all()


def test_vmap_equals_chain_by_chain(f32):
    model = suite.sir_model(pt)
    q = torch.from_numpy(_points(model, 5, seed=4))
    vag = model.logp_dlogp_function()
    lp, g = vag(q)
    for i in range(len(q)):
        lpi, gi = vag(q[i:i + 1])
        # float32: a batch of 5 and a batch of 1 may round the stage
        # sums' products differently
        np.testing.assert_allclose(lpi.numpy(), lp[i:i + 1].numpy(),
                                   rtol=1e-5)
        np.testing.assert_allclose(gi.numpy(), g[i:i + 1].numpy(),
                                   rtol=1e-5, atol=1e-5)


TIMES = np.linspace(0.1, 1.0, 5)
VALIDATION = {
    "too_many_params": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * y[0], TIMES, 1, 1)(y0=[1.0],
                                                   theta=[1.0, 2.0]),
    "too_few_params": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: p[0] * p[1] - y[0], TIMES, 1, 2)(y0=[1.0],
                                                         theta=[1.0]),
    "too_many_y0": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * y[0], TIMES, 1, 1)(y0=[1.0, 2.0],
                                                   theta=[1.0]),
    "too_few_y0": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: [-p[0] * y[0], y[0] - y[1]], TIMES, 2, 1)(
            y0=[1.0], theta=[1.0]),
    "func_not_callable": lambda pm: pm.ode.DifferentialEquation(
        1, TIMES, 1, 1),
    "n_states_zero": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -y[0], TIMES, 0, 1),
    "n_theta_zero": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -y[0], TIMES, 1, 0),
    "t0_after_first_time": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * y[0], TIMES, 1, 1, t0=0.5),
    "times_decreasing": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -y[0], [3, 2, 1], 1, 1),
    "one_time_at_t0": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -y[0], [0.0], 1, 1, t0=0),
    "unknown_method": lambda pm: pm.ode.DifferentialEquation(
        lambda y, t, p: -y[0], TIMES, 1, 1, method="euler"),
}


def test_func_that_does_not_broadcast_uses_vmap(f64):
    """A ``func`` that sums its state reads only its own lane under
    ``vmap``: the solve equals the plain loop."""
    ode = pt.ode.DifferentialEquation(
        lambda y, t, p: -p[0] * y + 0.1 * y.sum(), np.linspace(0.5, 2, 4),
        n_states=2, n_theta=1)
    y0 = torch.tensor([[1.0, 2.0], [0.5, -1.0]], dtype=torch.float64)
    theta = torch.tensor([[0.7], [1.3]], dtype=torch.float64)
    ys = tode._AdaptiveSolve.apply(y0, theta, ode)[0]
    np.testing.assert_array_equal(
        ys.numpy(), tode.solve_adaptive_reference(ode, y0, theta).numpy())


def test_math_of_a_number(f32):
    """``pm.math.log(2)``, as the SIR notebook writes it, is a constant in
    both packages."""
    with pt.Model():
        got = teval(pt.math.log(2), {})
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(
        jeval(pj.math.log(2), {})), rtol=1e-7)


@pytest.mark.parametrize("case", sorted(VALIDATION))
def test_validation_errors_match(f32, case):
    messages = []
    for pm in (pj, pt):
        with pytest.raises(ValueError) as err:
            VALIDATION[case](pm)
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_freefall_sample_end_to_end(f32):
    model, names = suite.ode_model(pt)
    tode.ITERATIONS = tode.SOLVES = 0
    trace = pt.sample(draws=10, tune=10, chains=4, model=model,
                      random_seed=3, progressbar=False,
                      compute_convergence_checks=False,
                      nuts={"max_treedepth": 3})
    gamma = trace["gamma"]
    assert gamma.shape == (40,) and np.all(np.isfinite(gamma))
    assert 0.3 < gamma.mean() < 0.5
    assert tode.SOLVES > 0
    assert tode.ITERATIONS / tode.SOLVES < 81


def test_graph_cache_keeps_the_last_used(monkeypatch):
    """The CUDA graphs of one equation: a key is captured the second time
    it is seen, and each kind keeps the ``KEEP`` graphs used last."""
    from pymc3_tpu_torch.ode import graphs
    monkeypatch.setattr(graphs, "KEEP", 2)
    g = graphs.Graphs(None)
    made = []

    def get(key):
        return g._get(g.backward, key, lambda: made.append(key) or key)
    assert get("a") is None and get("a") == "a"
    get("b"), get("b"), get("a"), get("c"), get("c")
    assert made == ["a", "b", "c"]
    assert list(g.backward) == ["a", "c"]


def test_failed_capture_raises():
    """A capture that fails is not hidden: the solve raises and names the
    switch that runs the equation eagerly."""
    from pymc3_tpu_torch.ode import graphs
    g = graphs.Graphs(None)

    def fails():
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")
    assert g._get(g.forward, "k", fails) is None
    with pytest.raises(RuntimeError, match="graphs.ENABLED = False"):
        g._get(g.forward, "k", fails)
    assert not g.forward
