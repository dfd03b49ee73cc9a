"""Distribution base machinery (cf. ``pymc3_tpu/distributions/distribution.py``).

``Distribution.__new__`` registers into the ambient model; ``.dist(...)``
builds an unregistered instance. Log-densities are tensor functions of the
value and the parameters; parameters are symbolic nodes resolved against the
evaluation environment, so the joint logp is one function of the flat point.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..config import floatX
from ..node import Node, evaluate
from .shape_utils import to_tuple

__all__ = ["Distribution", "Continuous"]


class Distribution:
    """Statistical distribution base (cf. ``distribution.py:46``)."""

    def __new__(cls, name, *args, **kwargs):
        from ..model import Model
        model = Model.get_context(error_if_none=False)
        if model is None:
            raise TypeError(
                "No model on context stack, which is needed to instantiate "
                "distributions. Add variable inside a 'with model:' block, or "
                "use the '.dist' syntax for a standalone distribution.")
        if not isinstance(name, str):
            raise TypeError(f"Name needs to be a string but got: {name}")
        data = kwargs.pop("observed", None)
        if isinstance(data, Distribution):
            raise TypeError("An observed variable cannot be a distribution "
                            "instance.")
        dist = cls.dist(*args, **kwargs)
        return model.Var(name, dist, data=data)

    @classmethod
    def dist(cls, *args, **kwargs):
        dist = object.__new__(cls)
        dist.__init__(*args, **kwargs)
        return dist

    def __init__(self, shape=(), dtype=None, testval=None, defaults=(),
                 transform=None):
        self.shape = to_tuple(shape)
        self.dtype = np.dtype(dtype if dtype is not None else floatX())
        self.testval = testval
        self.defaults = tuple(defaults)
        self.transform = transform

    def _infer_shape(self, shape, *param_nodes):
        """shape kwarg wins; else broadcast of parameter test shapes."""
        if shape is not None:
            return to_tuple(shape)
        shapes = [tuple(np.shape(p.test_value)) for p in param_nodes
                  if p is not None]
        return tuple(np.broadcast_shapes(*shapes)) if shapes else ()

    def _ev_params(self, names, env, memo):
        env = env or {}
        memo = {} if memo is None else memo
        return [evaluate(getattr(self, n), env, memo) for n in names]

    def logp(self, value, env: Optional[Dict] = None,
             memo: Optional[Dict] = None):
        """Elementwise log-density at ``value`` (a tensor)."""
        raise NotImplementedError

    # -- testval machinery (cf. distribution.py:90-117) ----------------------
    def default(self):
        return np.asarray(self.get_test_val(self.testval, self.defaults),
                          dtype=self.dtype)

    def get_test_val(self, val, defaults):
        if val is None:
            for v in defaults:
                attr = getattr(self, v, None)
                if attr is not None and np.all(np.isfinite(
                        self.getattr_value(attr))):
                    return self.getattr_value(attr)
            raise AttributeError(
                f"{self} has no finite default value to use, checked: "
                f"{defaults}. Pass testval argument or adjust so value is "
                "finite.")
        return self.getattr_value(val)

    def getattr_value(self, val):
        if isinstance(val, str):
            val = getattr(self, val)
        if isinstance(val, Node):
            val = val.test_value
        val = np.asarray(val)
        return np.broadcast_to(val, self.shape) if self.shape else val

    def __str__(self):
        return type(self).__name__

    __repr__ = __str__


class Continuous(Distribution):
    """Base for continuous distributions (cf. ``distribution.py:205``)."""

    def __init__(self, shape=(), dtype=None,
                 defaults=("median", "mean", "mode"), **kwargs):
        super().__init__(shape=shape, dtype=dtype or floatX(),
                         defaults=defaults, **kwargs)
