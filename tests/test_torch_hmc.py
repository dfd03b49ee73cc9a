"""The port's HMC core against the JAX package's: leapfrog, pooled mass
adaptation, dual averaging and one full NUTS transition on identical noise.

The NUTS test replays the JAX package's key splits (``nuts.py:137, 154,
253, 268``) with ``jax.random`` to produce the exact momenta and uniforms
the JAX transition consumes, and hands them to the port as its noise.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.arraystep import TuneContext as JaxTune
from pymc3_tpu.step_methods.hmc import integration as jint
from pymc3_tpu.step_methods.hmc import quadpotential as jqp
from pymc3_tpu.step_methods import step_sizes as jss
from pymc3_tpu_torch import convert
from pymc3_tpu_torch.step_methods.arraystep import TuneContext
from pymc3_tpu_torch.step_methods.hmc import integration as tint
from pymc3_tpu_torch.step_methods.hmc import quadpotential as tqp
from pymc3_tpu_torch.step_methods import step_sizes as tss

from .torch_models import gp_model

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _jax_f32():
    prev = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", prev)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_leapfrog_from_identical_state():
    """float32, rtol 1e-5: one logp+grad evaluation and a few axpys."""
    mj, mt = gp_model(pj, n=20), gp_model(pt, n=20)
    rng = np.random.RandomState(0)
    C, n = 3, mt.ndim
    q = (mt.dict_to_array(mt.test_point)[None]
         + rng.uniform(-0.3, 0.3, (C, n))).astype(np.float32)
    p = rng.randn(C, n).astype(np.float32)
    var = rng.uniform(0.5, 2.0, (C, n)).astype(np.float32)
    eps = np.array([0.1, -0.2, 0.05], np.float32)

    jvag = jax.value_and_grad(pj.model.ValueGradFunction(mj).jax_fn)
    jstate = jax.vmap(lambda q_, p_, v_: jint.compute_state(jvag, v_, q_, p_))(
        jnp.asarray(q), jnp.asarray(p), jnp.asarray(var))
    jout = jax.vmap(lambda e, v_, s: jint.leapfrog(jvag, v_, e, s))(
        jnp.asarray(eps), jnp.asarray(var), jstate)

    tvag = mt.logp_dlogp_function()
    tvar = torch.from_numpy(var)
    tstate = tint.compute_state(tvag, tvar, torch.from_numpy(q),
                                torch.from_numpy(p))
    tout = tint.leapfrog(tvag, tvar, torch.from_numpy(eps), tstate)
    for field in jint.IntegrationState._fields:
        np.testing.assert_allclose(getattr(tout, field).numpy(),
                                   np.asarray(getattr(jout, field)),
                                   rtol=1e-5, atol=1e-5, err_msg=field)


@pytest.mark.parametrize("pooled", [False, True])
def test_diag_adapt_update_matches_psum(pooled):
    """The pooled Welford merge over dim 0 equals the JAX psum over the
    vmapped chain axis, to 1e-6 relative, through early promotions
    (n = 3, 10 with 512 chains) and window ends (window 5)."""
    rng = np.random.RandomState(1)
    C, n, window = 512, 4, 5
    mean0 = rng.randn(n).astype(np.float32)
    init = jqp.diag_adapt_init(jnp.asarray(mean0), jnp.ones(n), 10.0)
    jstate = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (C,) + x.shape), init)
    tstate = convert.diag_adapt_state(_np(jstate))
    axis = "chains_local" if pooled else None
    jupd = jax.jit(jax.vmap(
        lambda s, x: jqp.diag_adapt_update(s, x, True, window, axis_name=axis),
        axis_name="chains_local"))
    for _ in range(12):
        x = (rng.randn(C, n) * [1.0, 2.0, 0.5, 3.0]).astype(np.float32)
        jstate = jupd(jstate, jnp.asarray(x))
        tstate = tqp.diag_adapt_update(tstate, torch.from_numpy(x), True,
                                       window, pooled=pooled)
    for got, want in zip(jax.tree_util.tree_leaves(tuple(tstate)),
                         jax.tree_util.tree_leaves(jstate)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-6, atol=1e-6)


def test_dual_averaging_50_updates():
    rng = np.random.RandomState(2)
    C = 4
    step0 = np.array([0.1, 0.3, 1.0, 0.05], np.float32)
    jstate = jax.vmap(jss.da_init)(jnp.asarray(step0))
    tstate = tss.da_init(torch.from_numpy(step0))
    for i in range(50):
        acc = rng.uniform(0, 1, C).astype(np.float32)
        tune = i < 40
        jstate = jax.vmap(lambda s, a: jss.da_update(s, a, tune))(
            jstate, jnp.asarray(acc))
        tstate = tss.da_update(tstate, torch.from_numpy(acc), tune)
        np.testing.assert_allclose(tss.da_current(tstate, tune).numpy(),
                                   np.asarray(jax.vmap(
                                       lambda s: jss.da_current(s, tune))(
                                           jstate)), rtol=1e-5)
    for got, want in zip(tstate, jstate):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)


class ReplayNoise:
    """The random numbers one JAX NUTS transition per chain consumes,
    replayed from its keys in the order the port asks for them. ``dtype``
    is the JAX package's ``floatX``, in which it draws the momenta and the
    uniforms (the direction's too: ``jax.random.bernoulli``'s default p is
    a Python float, so its uniform takes the default float width)."""

    def __init__(self, keys, n, max_depth, dtype=np.float32):
        self.dtype = dtype
        self.p = []
        self.depths = [[] for _ in range(max_depth)]
        for key in keys:
            k_mom, k_tree = jax.random.split(key)
            self.p.append(np.asarray(jax.random.normal(k_mom, (n,), dtype)))
            for d in range(max_depth):
                k_tree, k_dir, k_sub, k_swap = jax.random.split(k_tree, 4)
                takes = []
                for _ in range(max(1, (1 << d) // 2)):
                    k_sub, ka, kb = jax.random.split(k_sub, 3)
                    takes += [jax.random.uniform(ka, (), dtype),
                              jax.random.uniform(kb, (), dtype)]
                self.depths[d].append((
                    jax.random.uniform(k_dir, (), dtype),
                    jax.random.uniform(k_swap, (), dtype), takes))

    def normal(self, dim):
        return torch.from_numpy(np.stack(self.p))

    def depth(self, d, n_take):
        rows = self.depths[d]
        u_dir = np.array([r[0] for r in rows], self.dtype)
        u_swap = np.array([r[1] for r in rows], self.dtype)
        takes = np.array([r[2][:n_take] for r in rows], self.dtype).T
        return (torch.from_numpy(u_dir), torch.from_numpy(u_swap),
                torch.from_numpy(takes))


@pytest.mark.parametrize("pooled", [False, True])
def test_one_nuts_transition_on_identical_noise(pooled):
    """Same depth, same number of leapfrogs, same next q (within 1e-4)."""
    mj, mt = gp_model(pj, n=20), gp_model(pt, n=20)
    C, n, max_depth = 4, mt.ndim, 6
    axis = "chains_local" if pooled else None
    jstep = pj.NUTS(model=mj, max_treedepth=max_depth, axis_name=axis)
    tstep = pt.NUTS(model=mt, max_treedepth=max_depth, axis_name=axis)
    rng = np.random.RandomState(3)
    q0 = (mt.dict_to_array(mt.test_point)[None]
          + rng.uniform(-0.5, 0.5, (C, n))).astype(np.float32)
    jinit = jax.vmap(jstep.kernel_init)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(11), C)
    jq, jst, jstats = jax.vmap(
        lambda k, q, s: jstep.kernel_step(
            k, q, s, JaxTune(jnp.asarray(True), jnp.asarray(250, jnp.int32),
                             1000)),
        axis_name="chains_local")(keys, jnp.asarray(q0), jinit)

    tinit = convert.nuts_kernel_state(_np(jinit))
    tq, tst, tstats = tstep.kernel_step(torch.from_numpy(q0), tinit,
                                        TuneContext(True, 250, 1000),
                                        ReplayNoise(keys, n, max_depth))
    np.testing.assert_array_equal(tstats["depth"].numpy(),
                                  np.asarray(jstats["depth"]))
    np.testing.assert_array_equal(tstats["tree_size"].numpy(),
                                  np.asarray(jstats["tree_size"]))
    np.testing.assert_allclose(tq.numpy(), np.asarray(jq), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(tst.da.log_step.numpy(),
                               np.asarray(jst.da.log_step), rtol=1e-4)
    np.testing.assert_allclose(tst.pot.var.numpy(), np.asarray(jst.pot.var),
                               rtol=1e-4)
