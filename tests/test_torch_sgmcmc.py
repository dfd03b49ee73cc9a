"""One SGLD transition of the port against the JAX kernel on the JAX
package's own random numbers (its key splits replayed into the port's
``noise``), and SGLD through ``sample()`` on a minibatch model."""
import numpy as np
import torch

import jax

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.step_methods.arraystep import TuneContext as JTune
from pymc3_tpu.step_methods.sgmcmc import SGLD as JSGLD
from pymc3_tpu_torch.step_methods.arraystep import TuneContext

from . import torch_models  # noqa: F401

torch.set_num_threads(2)


def _model(pm):
    rng = np.random.RandomState(1)
    data = (rng.randn(400) + 1.5).astype(np.float32)
    mb = pm.Minibatch(data, batch_size=50)
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 10.0)
        sd = pm.HalfNormal("sd", 2.0)
        pm.Normal("obs", mu=mu, sigma=sd, observed=mb, total_size=400)
    return m, mb


class _Replayed:
    """``noise`` handing in fixed minibatch offsets and normal draws."""

    def __init__(self, offsets, normals):
        self.offsets, self.normals = offsets, normals

    def minibatch(self, nodes):
        return {nodes[0].noise_key: self.offsets}

    def normal(self, dim):
        return self.normals


def test_one_sgld_step_matches_jax_kernel():
    (jm, jmb), (tm, _) = _model(pj), _model(pt)
    jstep = JSGLD(vars=jm.free_RVs, step_size=1e-2, model=jm)
    tstep = pt.SGLD(vars=tm.free_RVs, step_size=1e-2, model=tm)
    q = np.array([[0.5, -0.2], [1.4, 0.3], [2.0, 0.0]], np.float32)
    keys = jax.random.split(jax.random.PRNGKey(5), 3)
    state = tstep.kernel_init(torch.as_tensor(q))
    for t in range(3):
        keys = jax.vmap(lambda k: jax.random.split(k)[0])(keys)
        want, offsets, normals = [], [], []
        for c in range(3):
            js = jstep.kernel_init(q[c])._replace(
                step_count=jax.numpy.asarray(t, jax.numpy.int32))
            qn, _, _ = jstep.kernel_step(keys[c], q[c], js, JTune(True, t, 0))
            want.append(np.asarray(qn))
            k_mb, k_noise = jax.random.split(keys[c])
            offsets.append(int(jax.random.randint(
                jax.random.fold_in(k_mb, jmb._fold), (), 0, 400)))
            normals.append(np.asarray(jax.random.normal(k_noise, (2,))))
        got, state, _ = tstep.kernel_step(
            torch.as_tensor(q), state, TuneContext(True, t, 0),
            _Replayed(torch.tensor(offsets), torch.as_tensor(
                np.stack(normals))))
        np.testing.assert_allclose(got.numpy(), np.stack(want), rtol=1e-5,
                                   atol=1e-5)
        q = got.numpy()


def test_sgld_through_sample_recovers_the_mean():
    tm, _ = _model(pt)
    with tm:
        tr = pt.sample(draws=300, tune=100, chains=8, random_seed=2,
                       step=pt.SGLD(step_size=1e-2), progressbar=False,
                       compute_convergence_checks=False)
    assert abs(tr["mu"].mean() - 1.5) < 0.2
    assert not hasattr(tr, "stat_names") or not tr.stat_names
