"""The port's stationary-covariance op against the JAX package's.

On the CPU the port's wrappers run their plain PyTorch versions (the CUDA
kernels need the card; ``chip_smoke.py`` holds each against the same plain
version there). The JAX side runs its Pallas kernel in interpret mode and
its XLA fallback, as ``tests/test_pallas_ops.py`` does.

Tolerances are those of ``tests/test_pallas_ops.py``: forward rtol 2e-5,
atol 2e-6 (both sides sum the same float32 squared differences, possibly in
another order); gradients rtol 2e-4, atol 2e-5 (the closed-form backward
against autodiff through it).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pymc3_tpu.ops.pallas.gp_cov import _fallback, stationary_cov as jax_cov
from pymc3_tpu_torch.ops import gp_cov
from pymc3_tpu_torch.ops.gp_cov import (
    STATIONARY_KINDS, stationary_cov, stationary_cov_backward_reference,
    stationary_cov_reference)
from . import torch_models  # noqa: F401  (asks the port for the CPU)

torch.set_num_threads(2)

FWD = dict(rtol=2e-5, atol=2e-6)
GRAD = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _inputs(n=40, m=200, d=3, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(n, d).astype(np.float32),
            rng.randn(m, d).astype(np.float32))


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_forward_matches_pallas_interpret_and_fallback(kind):
    X, Xs = _inputs()
    K = stationary_cov(torch.from_numpy(X), torch.from_numpy(Xs), kind)
    K_pl = jax_cov(X, Xs, kind=kind, force_pallas=True, interpret=True)
    K_fb = _fallback(kind, jnp.asarray(X), jnp.asarray(Xs))
    np.testing.assert_allclose(K.numpy(), np.asarray(K_pl), **FWD)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_fb), **FWD)


def test_ragged_edge_130x5():
    """The TPU kernel padded 130 rows to 256; the port masks instead."""
    X, Xs = _inputs(n=130, m=5, d=2, seed=2)
    K = stationary_cov(torch.from_numpy(X), torch.from_numpy(Xs), "expquad")
    K_pl = jax_cov(X, Xs, kind="expquad", force_pallas=True, interpret=True)
    assert K.shape == (130, 5)
    np.testing.assert_allclose(K.numpy(), np.asarray(K_pl), **FWD)


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_d40_exact_differences_against_float64_truth(kind):
    """Above d = 32 the JAX fallback switches to the matmul form; the port
    (like the Pallas body) keeps exact differences for every d."""
    X, Xs = _inputs(n=64, m=48, d=40, seed=5)
    X, Xs = 0.2 * X, 0.2 * Xs
    K = stationary_cov(torch.from_numpy(X), torch.from_numpy(Xs), kind)
    truth = stationary_cov_reference(torch.from_numpy(X).double(),
                                     torch.from_numpy(Xs).double(), kind)
    np.testing.assert_allclose(K.numpy(), truth.numpy(), **FWD)


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_gradients_match_jax_custom_vjp(kind):
    X, Xs = _inputs(n=12, m=9, d=2, seed=1)
    # keep points apart: matern gradients are steep near r = 0
    X, Xs = 2.0 * X, 2.0 * X[:9] + 3.0

    def jax_loss(X_, Xs_):
        return jnp.sum(jnp.sin(jax_cov(X_, Xs_, kind=kind,
                                       force_pallas=False)))

    gx, gxs = jax.grad(jax_loss, argnums=(0, 1))(jnp.asarray(X),
                                                 jnp.asarray(Xs))
    Xt = torch.from_numpy(X).requires_grad_()
    Xst = torch.from_numpy(Xs).requires_grad_()
    torch.sin(stationary_cov(Xt, Xst, kind)).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), np.asarray(gx), **GRAD)
    np.testing.assert_allclose(Xst.grad.numpy(), np.asarray(gxs), **GRAD)


def _apart(n, m, d, seed):
    """Inputs with every pair at distance >= 0.5: the closed form cancels
    where dK/dd2 is singular (matern12, exponential at r -> 0)."""
    rng = np.random.RandomState(seed)
    return (rng.rand(n, d).astype(np.float32),
            (rng.rand(m, d) + 1.5).astype(np.float32))


def _jax_vjp(kind, X, Xs, g):
    K, vjp = jax.vjp(lambda a, b: jax_cov(a, b, kind=kind,
                                          force_pallas=False),
                     jnp.asarray(X), jnp.asarray(Xs))
    return [np.asarray(t) for t in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("shape", [(12, 9, 2), (130, 5, 2)],
                         ids=["12x9", "130x5"])
@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_backward_reference_matches_jax_vjp(kind, shape):
    """The plain version of the backward kernel against ``jax.vjp`` of the
    JAX package's op (its XLA fallback, as its own tests run it)."""
    n, m, d = shape
    X, Xs = _apart(n, m, d, seed=6)
    g = np.random.RandomState(7).randn(n, m).astype(np.float32)
    dX, dXs = stationary_cov_backward_reference(
        torch.from_numpy(g), torch.from_numpy(X), torch.from_numpy(Xs), kind)
    wX, wXs = _jax_vjp(kind, X, Xs, g)
    np.testing.assert_allclose(dX.numpy(), wX, **GRAD)
    np.testing.assert_allclose(dXs.numpy(), wXs, **GRAD)


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_backward_reference_batched_matches_jax_vjp(kind):
    """A (B, n, d) batch, each entry against its own ``jax.vjp``."""
    pairs = [_apart(11, 7, 3, seed=s) for s in (1, 2, 3)]
    X = np.stack([p[0] for p in pairs])
    Xs = np.stack([p[1] for p in pairs])
    g = np.random.RandomState(8).randn(3, 11, 7).astype(np.float32)
    dX, dXs = stationary_cov_backward_reference(
        torch.from_numpy(g), torch.from_numpy(X), torch.from_numpy(Xs), kind)
    for b in range(3):
        wX, wXs = _jax_vjp(kind, X[b], Xs[b], g[b])
        np.testing.assert_allclose(dX[b].numpy(), wX, **GRAD)
        np.testing.assert_allclose(dXs[b].numpy(), wXs, **GRAD)


@pytest.mark.parametrize("kind", STATIONARY_KINDS)
def test_stride0_cotangent_of_a_plain_sum(kind):
    """``K.sum().backward()`` hands the op an expanded cotangent whose
    strides are all 0; the backward must read it as a full (n, m) tensor."""
    X, Xs = _apart(12, 9, 2, seed=3)
    seen = []
    orig = gp_cov._cov_backward

    def spy(kind_, g, X_, Xs_):
        seen.append(g.stride())
        return orig(kind_, g, X_, Xs_)
    gp_cov._cov_backward = spy
    try:
        Xt = torch.from_numpy(X).requires_grad_()
        Xst = torch.from_numpy(Xs).requires_grad_()
        stationary_cov(Xt, Xst, kind).sum().backward()
    finally:
        gp_cov._cov_backward = orig
    assert seen == [(0, 0, 0)]
    wX, wXs = _jax_vjp(kind, X, Xs, np.ones((12, 9), np.float32))
    np.testing.assert_allclose(Xt.grad.numpy(), wX, **GRAD)
    np.testing.assert_allclose(Xst.grad.numpy(), wXs, **GRAD)


def test_same_tensor_for_x_and_xs_sums_both_gradients():
    """The marginal-likelihood path passes one tensor as X and Xs."""
    X = torch.from_numpy(2.0 * _inputs(n=9, m=1, d=2, seed=8)[0])
    Xt = X.clone().requires_grad_()
    torch.sin(stationary_cov(Xt, Xt, "matern52")).sum().backward()
    A = X.clone().requires_grad_()
    B = X.clone().requires_grad_()
    torch.sin(stationary_cov_reference(A, B, "matern52")).sum().backward()
    np.testing.assert_allclose(Xt.grad.numpy(), (A.grad + B.grad).numpy(),
                               **GRAD)


def test_second_derivative_raises():
    """The op is once-differentiable: no silent wrong Hessian."""
    X = torch.from_numpy(_inputs(n=6, m=1, d=2, seed=9)[0]).requires_grad_()
    K = stationary_cov(X, X, "expquad")
    gX, = torch.autograd.grad(torch.sin(K).sum(), X, create_graph=True)
    with pytest.raises(RuntimeError, match="once-differentiable"):
        gX.sum().backward()


def test_backward_launch_rejects_what_the_kernel_does_not_take():
    """Like the forward: the checks raise before anything is built or
    launched, and count no launch."""
    before = gp_cov.BACKWARD_LAUNCHES
    X = torch.zeros(1, 4, 2)
    with pytest.raises(TypeError, match="float32"):
        gp_cov._launch_backward("expquad", torch.zeros(1, 4, 4).half(),
                                X.half(), X.half())
    with pytest.raises(TypeError, match="float32"):
        gp_cov._launch_backward("expquad", torch.zeros(1, 4, 4), X,
                                X.double())
    with pytest.raises(ValueError, match="CUDA"):
        gp_cov._launch_backward("expquad", torch.zeros(1, 4, 4), X, X)
    with pytest.raises(ValueError, match="CUDA"):
        gp_cov._launch("expquad", X, X)
    assert gp_cov.BACKWARD_LAUNCHES == before


def test_xs_none_means_x():
    X, _ = _inputs(n=17, m=1, d=2, seed=3)
    Xt = torch.from_numpy(X)
    np.testing.assert_array_equal(stationary_cov(Xt, None, "matern32"),
                                  stationary_cov(Xt, Xt, "matern32"))


def test_rejects_unknown_kind():
    with pytest.raises(ValueError):
        stationary_cov(torch.zeros(3, 1), None, "periodic")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_kernel_launch_rejects_other_dtypes(dtype):
    """The CUDA kernels take float32 and float64 only; another dtype raises
    before anything is built or launched, and counts no launch."""
    before = gp_cov.LAUNCHES
    X = torch.zeros(1, 4, 2, dtype=dtype)
    with pytest.raises(TypeError, match="float32"):
        gp_cov._launch("expquad", X, X)
    assert gp_cov.LAUNCHES == before


def _spy(monkeypatch):
    calls = []
    orig = gp_cov._cov_forward

    def spy(kind, X, Xs):
        X.data_ptr()   # raises on a tensor wrapped by a functorch transform
        calls.append(tuple(X.shape))
        return orig(kind, X, Xs)
    monkeypatch.setattr(gp_cov, "_cov_forward", spy)
    return calls


def _spy_backward(monkeypatch):
    calls = []
    orig = gp_cov._cov_backward

    def spy(kind, g, X, Xs):
        g.data_ptr()   # raises on a tensor wrapped by a functorch transform
        calls.append(tuple(g.shape))
        return orig(kind, g, X, Xs)
    monkeypatch.setattr(gp_cov, "_cov_backward", spy)
    return calls


def _gp_logp(X):
    def logp(ls):
        Xl = X / ls
        Xl = Xl - Xl.mean(0)
        return torch.sin(stationary_cov(Xl, Xl, "matern52")).sum()
    return logp


@pytest.mark.parametrize("route", ["functorch_grad", "autograd_of_sum"])
def test_vmap_grad_reaches_batched_rule_once(monkeypatch, route):
    """A chain batch reaches the op as ONE forward and ONE backward call on
    plain (B, n, d) tensors through the Functions' vmap rules, under vmap∘grad and under the
    vmap-then-autograd route the model's logp_dlogp uses; gradients agree
    with autograd through the plain version."""
    from pymc3_tpu_torch.torchf import batched_value_and_grad
    X = torch.from_numpy(_inputs(n=7, m=1, d=1, seed=4)[0])
    ls = torch.linspace(0.5, 1.5, 5)
    calls = _spy(monkeypatch)
    bwd_calls = _spy_backward(monkeypatch)
    logp = _gp_logp(X)
    if route == "functorch_grad":
        grad, value = torch.func.vmap(torch.func.grad_and_value(logp))(ls)
    else:
        value, grad = batched_value_and_grad(logp)(ls)
    assert calls == [(5, 7, 1)]
    assert bwd_calls == [(5, 7, 7)]

    def ref(ls_):
        Xl = X / ls_
        Xl = Xl - Xl.mean(0)
        return torch.sin(stationary_cov_reference(Xl, Xl, "matern52")).sum()
    rgrad, rvalue = torch.func.vmap(torch.func.grad_and_value(ref))(ls)
    np.testing.assert_allclose(value.numpy(), rvalue.numpy(), rtol=1e-6)
    np.testing.assert_allclose(grad.numpy(), rgrad.numpy(), **GRAD)
