"""The port's optimizer rules against the JAX package's on the same
gradients: two updates of every rule from the same parameters, and the norm
constraints. Tolerance rtol 1e-5, atol 1e-6 (float32; the step counters of
``adam``/``adamax`` are host integers in the port, device ones in JAX)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pymc3_tpu.variational import updates as ju
from pymc3_tpu_torch.variational import updates as tu

from . import torch_models  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-6)

RULES = [("sgd", {"learning_rate": 0.1}),
         ("momentum", {"learning_rate": 0.05}),
         ("nesterov_momentum", {"learning_rate": 0.05}),
         ("adagrad", {"learning_rate": 0.5}),
         ("adagrad_window", {"learning_rate": 0.2, "n_win": 3}),
         ("rmsprop", {"learning_rate": 0.05}),
         ("adadelta", {"learning_rate": 2.0}),
         ("adam", {"learning_rate": 0.2}),
         ("adamax", {"learning_rate": 0.2})]


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {0: {"mu": rng.randn(5).astype(np.float32),
                "L": rng.randn(2, 3).astype(np.float32)}}


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    return tu.tree_map(lambda x: torch.as_tensor(np.array(x)), tree)


@pytest.mark.parametrize("name,hyper", RULES, ids=[r[0] for r in RULES])
def test_updates_match_jax(name, hyper):
    jopt, topt = getattr(ju, name)(**hyper), getattr(tu, name)(**hyper)
    jp, tp = _j(_tree(0)), _t(_tree(0))
    js, ts = jopt.init(jp), topt.init(tp)
    for k in range(4):
        g = _tree(10 + k)
        jp, js = jopt.update(_j(g), js, jp)
        tp, ts = topt.update(_t(g), ts, tp)
        for key in ("mu", "L"):
            np.testing.assert_allclose(tp[0][key].numpy(),
                                       np.asarray(jp[0][key]), err_msg=key,
                                       **TOL)


@pytest.mark.parametrize("name,hyper", RULES, ids=[r[0] for r in RULES])
def test_updates_descend_a_quadratic(name, hyper):
    """``tests/test_variational.py::test_optimizers_converge_quadratic``."""
    lr = {"adagrad_window": 0.2, "adadelta": 20.0}.get(
        name, hyper["learning_rate"])
    opt = getattr(tu, name)(**{**hyper, "learning_rate": lr})
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"x": torch.zeros(3)}
    state = opt.init(params)
    for _ in range(300):
        params, state = opt.update({"x": 2 * (params["x"] - target)}, state,
                                   params)
    assert float(torch.sum((params["x"] - target) ** 2)) < 0.05, name


def test_norm_constraints_match_jax():
    rng = np.random.RandomState(1)
    for shape, axes in (((4, 3), None), ((2, 3, 4), None), ((6,), None),
                        ((4, 3), (1,))):
        x = rng.randn(*shape).astype(np.float32) * 3
        want = ju.norm_constraint(jnp.asarray(x), 2.0, norm_axes=axes)
        got = tu.norm_constraint(torch.as_tensor(x), 2.0, norm_axes=axes)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    xs = [rng.randn(3).astype(np.float32), rng.randn(2, 2).astype(np.float32)]
    want, wn = ju.total_norm_constraint([jnp.asarray(x) for x in xs], 1.5,
                                        return_norm=True)
    got, gn = tu.total_norm_constraint([torch.as_tensor(x) for x in xs], 1.5,
                                       return_norm=True)
    np.testing.assert_allclose(float(gn), float(wn), **TOL)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_get_optimizer_and_momentum_wrappers():
    assert tu.get_optimizer("adam").name == "adam"
    assert tu.get_optimizer(tu.adam).name == "adam"
    opt = tu.adam(learning_rate=0.3)
    assert tu.get_optimizer(opt) is opt and opt() is opt
    assert tu.apply_momentum(opt).hyper == {"learning_rate": 0.3,
                                            "momentum": 0.9}
    assert tu.apply_nesterov_momentum(0.2).name == "nesterov_momentum"
    with pytest.raises(TypeError):
        tu.get_optimizer(3)
