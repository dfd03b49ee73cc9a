"""Data containers (cf. ``pymc3_tpu/data.py``).

``Data`` is a named mutable array registered on the model and swapped with
``set_data``; its tensor on the model's device is replaced when the value
is, and every logp reads the current one. ``Minibatch`` yields a new slice
of its data at every evaluation of a stochastic objective.

Which rows a minibatch takes is part of the objective's random numbers:
the caller draws them (:func:`minibatch_noise`) and passes them to the
model's logp through the evaluation environment under ``RNG_ENV_KEY``, one
row of the draw per Monte-Carlo sample under ``torch.func.vmap``. A node
turns its entry into row indices on the device and gathers; nothing goes
to the host. Views with the same ``random_seed`` share one entry, so an X
view and a y view select the same rows.
"""
from __future__ import annotations

import io
import os

import numpy as np
import torch

from .config import floatX
from .model import RNG_ENV_KEY, modelcontext
from .node import NamedNode, current_device

__all__ = ["get_data", "GeneratorAdapter", "Minibatch", "Data",
           "SharedDataNode", "MinibatchNode", "align_minibatches",
           "minibatch_nodes", "minibatch_noise", "RNG_ENV_KEY"]

# offsets are drawn from [0, _OFFSET_RANGE) and reduced modulo the row
# count on the device: the bias is below N / 2**62
_OFFSET_RANGE = 2 ** 62

_DATA_SEARCH_PATHS = [
    os.path.join(os.path.dirname(__file__), "datasets"),
    os.path.join(os.path.dirname(__file__), "examples", "data"),
]


def get_data(filename):
    """A BytesIO over one of the packaged datasets (cf. ``data.py:38``)."""
    for base in _DATA_SEARCH_PATHS:
        path = os.path.join(base, filename)
        if os.path.exists(path):
            with open(path, "rb") as f:
                return io.BytesIO(f.read())
    raise FileNotFoundError(
        f"dataset {filename!r} not found in {_DATA_SEARCH_PATHS}")


def _as_floatx(value):
    value = np.asarray(value)
    if value.dtype == np.float64 and floatX() == "float32":
        value = value.astype(floatX())
    return value


class SharedDataNode(NamedNode):
    """Named mutable data, held on ``device`` (the model's)."""

    def __init__(self, name, value, model=None, register=True, dtype=None,
                 device=None):
        self.name = name
        self.model = model
        value = np.asarray(value)
        self._dtype = np.dtype(dtype) if dtype is not None else \
            _as_floatx(value).dtype
        self.device = (model.device if model is not None else
                       current_device()) if device is None else device
        self.version = 0
        self._store(value)
        if register and model is not None:
            model.add_named_variable(self)

    def _store(self, value):
        self._value = np.asarray(value).astype(self._dtype)
        self._tensor = torch.as_tensor(self._value, device=self.device)

    @property
    def _test_value(self):
        return self._value

    @_test_value.setter
    def _test_value(self, v):
        pass

    def get_value(self):
        return self._value

    def set_value(self, value):
        """Replace the value (any shape); bumps ``version``."""
        self._store(value)
        self.version += 1

    def _eval_default(self, env, memo):
        return self._tensor


class GeneratorAdapter:
    """Feed a generator of arrays (cf. ``data.py:51``)."""

    def __init__(self, generator):
        if not hasattr(generator, "__next__"):
            raise TypeError("Object should be generator-like")
        self.gen = generator
        self._first = np.asarray(next(generator))
        self.shape = self._first.shape
        self.dtype = self._first.dtype
        self._returned_first = False

    def __next__(self):
        if not self._returned_first:
            self._returned_first = True
            return self._first
        return np.asarray(next(self.gen))

    def __iter__(self):
        return self

    def make_variable(self, name="generator"):
        node = SharedDataNode(name, self._first, model=None, register=False)
        node._generator = self
        return node


class MinibatchNode(NamedNode):
    """A random slice of ``data`` per evaluation (cf. ``data.py:119``).

    ``sampling="window"`` (the default) shuffles the rows once with
    ``np.random.RandomState(random_seed).permutation``, as the JAX package
    does, and takes a circular run of ``batch_size`` rows from a uniform
    offset: every row has the marginal probability ``batch_size / N``, so
    the scaled likelihood stays unbiased. ``sampling="random"`` takes
    ``batch_size`` i.i.d. uniform rows (the reference's semantics); a
    window as large as the data falls back to it, and so does a per-axis
    ``batch_size`` (a list or tuple, kept as given), which takes
    ``batch_size[0]`` rows of axis 0 and ignores the other entries, as the
    JAX package does. Without an entry in the environment (test values)
    the leading rows of the (shuffled) copy are returned.
    """

    _counter = [0]

    def __init__(self, data, batch_size, name=None, random_seed=42,
                 in_memory_size=None, sampling="window", device=None):
        data = _as_floatx(data)
        if in_memory_size is not None:
            data = data[_slice_from_size(in_memory_size)]
        per_axis = isinstance(batch_size, (list, tuple))
        self.batch_size = batch_size if per_axis else int(batch_size)
        # rows a draw takes
        self._rows = int(batch_size[0]) if per_axis else self.batch_size
        MinibatchNode._counter[0] += 1
        self.name = name or f"Minibatch_{MinibatchNode._counter[0]}"
        self.random_seed = random_seed
        self._fold = int(random_seed if random_seed is not None else 42)
        if sampling not in ("window", "random"):
            raise ValueError(f"sampling must be 'window' or 'random', "
                             f"got {sampling!r}")
        if per_axis or self._rows >= data.shape[0]:
            sampling = "random"
        self.sampling = sampling
        self._perm = None
        if sampling == "window":
            rng = np.random.RandomState(self._fold)
            self._perm = rng.permutation(data.shape[0])
            data = data[self._perm]
        self.data = data
        self.device = current_device() if device is None else device
        self._tensor = torch.as_tensor(data, device=self.device)
        self._arange = torch.arange(self._rows, device=self.device)
        # on the device once: an encoder maps every sample's draw through it
        self._perm_t = None if self._perm is None else torch.as_tensor(
            self._perm, device=self.device)

    @property
    def noise_key(self):
        """The key of this node's entry in a minibatch draw: shared by
        views with the same seed and sampling."""
        if self.sampling == "window":
            return f"window:{self._fold}"
        return f"random:{self._fold}:{self._rows}"

    def noise_shape(self, size):
        return (size,) if self.sampling == "window" else (size, self._rows)

    @property
    def _test_value(self):
        return self.data[:self._rows]

    @_test_value.setter
    def _test_value(self, v):
        pass

    @property
    def total_size(self):
        return self.data.shape[0]

    def _positions(self, r):
        """Row positions in the stored copy for one entry ``r``."""
        n = self.data.shape[0]
        if self.sampling == "window":
            return torch.remainder(r + self._arange, n)
        return torch.remainder(r, n)

    def indices(self, r=None):
        """Row indices into the user's original array selected by the entry
        ``r``, or by this node's entry of a minibatch draw ``r`` (a dict, as
        an AEVB encoder receives it); None: the rows of the test value."""
        if isinstance(r, dict):
            r = r[self.noise_key]
        if r is None:
            pos = self._arange
        else:
            pos = self._positions(torch.as_tensor(r, device=self.device))
        return pos if self._perm_t is None else self._perm_t[pos]

    def _eval_default(self, env, memo):
        draw = env.get(RNG_ENV_KEY)
        if draw is None:
            return self._tensor[:self._rows]
        return self._tensor[self._positions(draw[self.noise_key])]


def Minibatch(data, batch_size=128, dtype=None, broadcastable=None,
              name="Minibatch", random_seed=42, update_shared_f=None,
              in_memory_size=None, sampling="window"):
    """A minibatch view of ``data`` (cf. ``data.py:230``); see
    :class:`MinibatchNode`."""
    return MinibatchNode(data, batch_size, name=name, random_seed=random_seed,
                         sampling=sampling, in_memory_size=in_memory_size)


def align_minibatches(batches=None):
    """Views with one seed already share their rows (cf. ``data.py:245``);
    kept for API parity."""
    return None


def _slice_from_size(size):
    if isinstance(size, int):
        return slice(0, size)
    return tuple(slice(0, s) if isinstance(s, int) else slice(None)
                 for s in size)


def minibatch_nodes(model):
    """The minibatch views the model's observed variables and parameters
    read, one per ``noise_key``."""
    from .torchf import _walk
    roots = list(model.potentials) + list(model.deterministics)
    for factor in model._factor_order:
        roots.append(getattr(factor, "data_node", None))
        roots.extend(factor.distribution.param_nodes().values())
    found = {}
    for root in roots:
        for node in _walk(root):
            if isinstance(node, MinibatchNode):
                found.setdefault(node.noise_key, node)
    return list(found.values())


def minibatch_noise(nodes, gen, size):
    """One minibatch draw per Monte-Carlo sample: ``{noise_key: int64
    tensor}`` with a leading axis of ``size``, drawn on the generator's
    device (empty when there are no minibatch views)."""
    return {node.noise_key: torch.randint(
        0, _OFFSET_RANGE, node.noise_shape(size), generator=gen,
        device=gen.device) for node in nodes}


def Data(name, value, *, dims=None, export_index_as_coords=False,
         model=None):
    """A named mutable data container on the model's device
    (cf. ``data.py:258``)."""
    model = modelcontext(model)
    if hasattr(value, "to_numpy"):
        value = value.to_numpy()
    node = SharedDataNode(model.name_for(name), np.asarray(value),
                          model=model)
    if dims is not None:
        model._RV_dims[node.name] = tuple(np.atleast_1d(dims))
    return node
