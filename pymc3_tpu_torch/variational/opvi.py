"""Operator variational inference core (cf. ``pymc3_tpu/variational/opvi.py``).

An :class:`Approximation` is a parametric sampler over the model's flat
unconstrained space. Its variational parameters are a dict of tensors per
group, ``{group index: {name: tensor}}``, on the model's device. All of its
random numbers come in as ``noise`` (:meth:`Approximation.draw_noise`):
one entry per group (standard normal draws, or particle indices for an
empirical group) and one minibatch draw (``data.minibatch_noise``). A caller
that hands in its own noise, such as a test replaying the JAX package's
draws, gets the same objective value and gradient.

One optimizer step is a Monte-Carlo objective over ``obj_n_mc`` samples
(the model's logp vmapped over them), its gradient by autograd, and a
functional update (``updates.py``). The step does not wait for the device:
non-finite values are masked on the device, and the loss stays there.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..blocking import ArrayOrdering
from ..config import floatX, torch_floatX
from ..data import minibatch_noise, minibatch_nodes
from ..model import modelcontext
from ..node import _ev
from .updates import adagrad_window, get_optimizer, tree_leaves, tree_map

__all__ = ["Approximation", "Group", "Operator", "ObjectiveFunction",
           "TestFunction", "node_property"]


def node_property(f):
    """API-parity shim for the reference decorator (``opvi.py:32``)."""
    return property(f)


class TestFunction:
    """cf. ``opvi.py:37``."""

    def __init__(self):
        self._inited = False

    def setup(self, approx):
        pass

    @classmethod
    def from_function(cls, f):
        obj = TestFunction()
        obj.__call__ = f
        return obj


def _unflatten(template, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), template)


def value_and_grad(fn, params, *args):
    """``fn(params, *args)`` and its gradient with respect to every leaf of
    ``params`` (zeros where a leaf is unused)."""
    with torch.enable_grad():
        req = tree_map(lambda p: p.detach().requires_grad_(), params)
        leaves = tree_leaves(req)
        val = fn(req, *args)
        grads = torch.autograd.grad(val, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    return val.detach(), _unflatten(req, grads)


def mask_nonfinite(grads, finite=None):
    """Zero every non-finite gradient entry, and every entry where
    ``finite`` (a 0-d bool tensor) is false, on the device."""
    def one(g):
        ok = torch.isfinite(g) if finite is None else \
            finite & torch.isfinite(g)
        return torch.where(ok, g, torch.zeros_like(g))
    return tree_map(one, grads)


class Group:
    """A variational family over a subset of the free variables
    (cf. ``opvi.py:53``): a contiguous index set into the model's flat
    unconstrained vector, all free variables by default.

    A ``local`` group (AEVB) takes its variational parameters from the
    user (``params``), trainable arrays or an encoder, and scales its logq
    like the model's logp term of its variables (``scale_vec``, from their
    ``total_size``). A ``rowwise`` group factorizes over the leading axis
    of its one variable (``FullRankGroup``)."""

    has_logq = True
    supports_batched = False
    short_name = ""

    def __init__(self, group=None, vfam=None, params=None, model=None,
                 local=False, rowwise=False, options=None, **kwargs):
        model = modelcontext(model)
        self.model = model
        self.device = model.device
        self.local = bool(local)
        self.rowwise = bool(rowwise)
        if self.local and params is None:
            raise ValueError(
                "Local (AEVB) groups need user-provided params: trainable "
                "dict(mu=..., rho=...) or an encoder dict(encoder=fn, "
                "aux=...)")
        if group is None:
            if self.local:
                raise ValueError("Local groups must name their variables")
            self.group_vars = model.free_RVs
        else:
            def resolve(v):
                tr = getattr(v, "transformed", None)
                return v if tr is None else tr
            self.group_vars = [resolve(model.named_vars.get(
                getattr(v, "name", v), v)) for v in group]
        self.ordering = ArrayOrdering(self.group_vars)
        self.ndim = self.ordering.size
        glob = model.ordering
        idx, scale = [], []
        for vm in self.ordering.vmap:
            g = glob.by_name[vm.var]
            idx.extend(range(g.slc.start, g.slc.stop))
            scale += [float(getattr(model.named_vars.get(vm.var), "scaling",
                                    1.0))] * (g.slc.stop - g.slc.start)
        self.q_indices = np.asarray(idx, dtype=np.int64)
        self.scale_vec = np.asarray(scale, dtype=floatX())
        self.user_params = params

    def _start_vector(self, start=None):
        """The group's slice of a start point (the test point by
        default)."""
        if start is None:
            start = self.model.test_point
        return np.concatenate([
            np.ravel(np.asarray(start.get(vm.var, np.zeros(vm.shp))))
            for vm in self.ordering.vmap]).astype(floatX())

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.detach().to(dtype=torch_floatX(), device=self.device)
        return torch.as_tensor(np.asarray(x), dtype=torch_floatX(),
                               device=self.device)

    def _normal(self, gen, size):
        return torch.randn((size, self.ndim), generator=gen,
                           dtype=torch_floatX(), device=self.device)

    # family interface -------------------------------------------------------
    def init_params(self, start=None) -> Dict[str, torch.Tensor]:
        raise NotImplementedError

    def draw_noise(self, gen, size):
        """The group's random numbers for ``size`` samples (standard normal
        ``(size, ndim)`` unless the family says otherwise)."""
        return self._normal(gen, size)

    def sample_q(self, params, noise, draws=None):
        """``(z (size, ndim), logq (size,))``, reparameterized. ``draws``
        is the minibatch draw of the samples (``noise["minibatch"]``), which
        a local group's encoder reads."""
        raise NotImplementedError

    def mean(self, params):
        raise NotImplementedError

    def std(self, params):
        raise NotImplementedError


class Operator:
    """Base operator class (cf. ``opvi.py:121``)."""

    has_test_function = False
    returns_loss = True
    require_logq = True
    objective_class = None  # set below

    def __init__(self, approx):
        self.approx = approx
        if self.require_logq and not approx.has_logq:
            raise ValueError(
                f"{self} requires logq, but {approx} does not provide it")

    @property
    def model(self):
        return self.approx.model

    def apply(self, f):
        """The per-sample objective ``fn(z, logq, draw) -> scalar``."""
        raise NotImplementedError

    def __call__(self, f=None):
        if self.has_test_function and f is None:
            raise ValueError(f"Operator {self} requires TestFunction")
        return self.objective_class(self, f)

    def __repr__(self):
        return type(self).__name__


class ObjectiveFunction:
    """A Monte-Carlo objective and its update step (cf. ``opvi.py:153``)."""

    def __init__(self, op: Operator, tf: Optional[TestFunction] = None):
        self.op = op
        self.tf = tf

    @property
    def approx(self):
        return self.op.approx

    def draw_noise(self, gen, nmc):
        return self.approx.draw_noise(gen, nmc)

    def loss_fn(self, nmc):
        """``loss(params, noise)``: the mean over ``nmc`` samples of the
        operator's per-sample objective."""
        approx = self.approx
        per_sample = torch.func.vmap(self.op.apply(self.tf))

        def loss(params, noise):
            z, logq = approx.sample_q(params, nmc, noise)
            return torch.mean(per_sample(z, logq, noise["minibatch"]))
        return loss

    def step_function(self, obj_n_mc=1, obj_optimizer=None,
                      more_obj_params=None, total_grad_norm_constraint=None,
                      score=True, fn_kwargs=None):
        """``step(params, opt_state, noise) -> (params, opt_state, loss)``
        and its optimizer (cf. ``opvi.py:179``). A non-finite loss zeroes
        the whole gradient and a non-finite entry its own, on the device
        (``opvi.py:195-200``)."""
        opt = get_optimizer(obj_optimizer if obj_optimizer is not None
                            else adagrad_window())
        loss = self.loss_fn(obj_n_mc)

        def step(params, opt_state, noise):
            val, grads = value_and_grad(loss, params, noise)
            with torch.no_grad():
                if total_grad_norm_constraint is not None:
                    from .updates import total_norm_constraint
                    grads = _unflatten(grads, total_norm_constraint(
                        tree_leaves(grads), total_grad_norm_constraint))
                grads = mask_nonfinite(grads, torch.isfinite(val))
                params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, val
        return step, opt

    def sharded_step_function(self, mesh, obj_n_mc=1, obj_optimizer=None,
                              axis_name=None):
        """Data-parallel step over the ranks of ``mesh`` (a
        ``parallel.ChainMesh``; cf. ``opvi.py:207-250``): ``step(params,
        opt_state, noise) -> (params, opt_state, loss)`` and its optimizer.
        ``axis_name``, as in the JAX package, names the mesh's axis the
        step averages over (its chain axis, the one it has); another name
        raises.

        Every rank calls ``step`` with the same parameters and its own
        ``noise`` (its minibatch and Monte-Carlo draws, from its own
        generator: ``self.draw_noise(gen, obj_n_mc)``). The gradients and
        the loss are averaged over the ranks in one SUM, so the update, and
        the parameters after it, are the same on every rank. A non-finite
        averaged loss zeroes the whole gradient and a non-finite entry its
        own, as in :meth:`step_function`."""
        if axis_name is not None and axis_name not in mesh.axis_names:
            raise ValueError(f"axis_name={axis_name!r} is not an axis of the "
                             f"mesh, {mesh.axis_names}")
        opt = get_optimizer(obj_optimizer if obj_optimizer is not None
                            else adagrad_window())
        loss = self.loss_fn(obj_n_mc)
        world = float(mesh.world_size)

        def step(params, opt_state, noise):
            val, grads = value_and_grad(loss, params, noise)
            with torch.no_grad():
                leaves = tree_leaves(grads)
                flat = mesh.sum(torch.cat(
                    [val.reshape(1)] + [g.reshape(-1) for g in leaves])) \
                    / world
                val, start, mean = flat[0], 1, []
                for g in leaves:
                    mean.append(flat[start:start + g.numel()].reshape(g.shape))
                    start += g.numel()
                grads = mask_nonfinite(_unflatten(grads, mean),
                                       torch.isfinite(val))
                params, opt_state = opt.update(grads, opt_state, params)
            return params, opt_state, val
        return step, opt

    def __call__(self, nmc, **kwargs):
        return self.loss_fn(nmc)


Operator.objective_class = ObjectiveFunction


class Approximation:
    """A collection of groups covering every free variable
    (cf. ``opvi.py:259``); carries the fitted parameters and turns samples
    into a :class:`MultiTrace`."""

    def __init__(self, groups, model=None):
        model = modelcontext(model)
        self.model = model
        if not isinstance(groups, (list, tuple)):
            groups = [groups]
        self.groups = list(groups)
        covered = set()
        for g in self.groups:
            covered.update(g.q_indices.tolist())
        if len(covered) != model.ordering.size:
            raise ValueError(
                "Approximation groups must cover all free variables")
        self._index = [torch.as_tensor(g.q_indices, device=model.device)
                       for g in self.groups]
        self._minibatches = minibatch_nodes(model)
        self.params = {i: g.init_params() for i, g in enumerate(self.groups)}
        self.hist = np.asarray([])

    @property
    def has_logq(self):
        return all(g.has_logq for g in self.groups)

    @property
    def ndim(self):
        return self.model.ordering.size

    # -- sampling ------------------------------------------------------------
    def draw_noise(self, gen, size):
        """All random numbers of ``size`` samples: ``{"groups": [one entry
        per group], "minibatch": {noise_key: draws}}``."""
        return {"groups": [g.draw_noise(gen, size) for g in self.groups],
                "minibatch": minibatch_noise(self._minibatches, gen, size)}

    def sample_q(self, params, size, noise=None, gen=None):
        """``(z (size, ndim), logq (size,))`` across all groups, from
        ``noise`` (drawn from ``gen`` when not given)."""
        if noise is None:
            noise = self.draw_noise(gen, size)
        if len(self.groups) == 1 and np.array_equal(
                self.groups[0].q_indices, np.arange(self.ndim)):
            return self.groups[0].sample_q(params[0], noise["groups"][0],
                                           noise["minibatch"])
        z = torch.zeros((size, self.ndim), dtype=torch_floatX(),
                        device=self.model.device)
        logq = torch.zeros((size,), dtype=torch_floatX(),
                           device=self.model.device)
        for i, g in enumerate(self.groups):
            zi, lqi = g.sample_q(params[i], noise["groups"][i],
                                 noise["minibatch"])
            z = z.index_copy(1, self._index[i], zi)
            logq = logq + lqi
        return z, logq

    def logq_fn(self, params):
        """``z (ndim,) -> logq``, for the families with a density."""
        def logq(z):
            return sum(g.logq(params[i], z[self._index[i]])
                       for i, g in enumerate(self.groups))
        return logq

    def _generator(self, random_seed=None):
        gen = torch.Generator(device=self.model.device)
        if random_seed is None:
            gen.seed()
        else:
            gen.manual_seed(int(random_seed))
        return gen

    # -- moments -------------------------------------------------------------
    def _gather(self, fn):
        out = np.zeros(self.ndim, dtype=floatX())
        for i, g in enumerate(self.groups):
            out[g.q_indices] = fn(g, self.params[i]).detach().cpu().numpy()
        return out

    @property
    def mean(self) -> np.ndarray:
        return self._gather(lambda g, p: g.mean(p))

    @property
    def std(self) -> np.ndarray:
        return self._gather(lambda g, p: g.std(p))

    @property
    def cov(self) -> np.ndarray:
        cov = np.zeros((self.ndim, self.ndim), dtype=floatX())
        for i, g in enumerate(self.groups):
            if hasattr(g, "cov"):
                gc = np.asarray(g.cov(self.params[i]).detach().cpu())
            else:
                gc = np.diag(g.std(self.params[i]).detach().cpu().numpy()
                             ** 2)
            cov[np.ix_(g.q_indices, g.q_indices)] = gc
        return cov

    # -- conversion ----------------------------------------------------------
    def sample(self, draws=500, include_transformed=True, random_seed=None):
        """Posterior draws as a one-chain MultiTrace (cf. ``opvi.py:351``),
        decoded on the device and copied to the host once."""
        from ..backends.base import MultiTrace
        from ..backends.ndarray import NDArray
        model = self.model
        with torch.no_grad():
            z, _ = self.sample_q(self.params, draws,
                                 gen=self._generator(random_seed))
            unobserved = model.unobserved_RVs
            ordering = model.ordering

            def decode(q):
                env = model._env_from_q(q, ordering)
                memo = {}
                return [_ev(v, env, memo) for v in unobserved]
            vals = torch.func.vmap(decode)(z)
        strace = NDArray(model=model, vars=unobserved)
        strace.setup(draws, 0)
        strace.record_batch({v.name: x.cpu().numpy()
                             for v, x in zip(unobserved, vals)}, draws)
        strace.close()
        return MultiTrace([strace])

    def sample_node(self, node, size=None, more_replacements=None,
                    random_seed=None):
        """A node's values under ``size`` draws of q (their mean when
        ``size`` is None, from 100 draws), cf. ``opvi.py:380``."""
        from ..node import as_node
        node = as_node(node)
        model = self.model
        ordering = model.ordering
        with torch.no_grad():
            z, _ = self.sample_q(self.params, size or 100,
                                 gen=self._generator(random_seed))
            vals = torch.func.vmap(lambda q: _ev(
                node, model._env_from_q(q, ordering), {}))(z)
        vals = vals.cpu().numpy()
        return vals.mean(axis=0) if size is None else vals

    apply_replacements = sample_node

    @property
    def sample_dict_fn(self):
        def inner(draws=500):
            tr = self.sample(draws)
            return {v: tr.get_values(v) for v in tr.varnames}
        return inner

    def __repr__(self):
        names = ",".join(type(g).__name__ for g in self.groups)
        return f"<Approximation[{names}] ndim={self.ndim}>"
