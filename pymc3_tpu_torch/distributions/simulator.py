"""ABC simulator distribution (cf. ``pymc3_tpu/distributions/simulator.py``).

``Simulator(name, function, *params, observed=data)`` has no density: its
logp is 0, and ``sample_smc(kernel="abc")`` compares ``function(*params)``
with the data instead. A function written in torch runs batched over the
particles on the device; one that returns numpy is called on the host once
per particle (see ``smc._make_abc_loglike``).
"""
from __future__ import annotations

import torch

from ..config import floatX
from .distribution import NoDistribution, draw_values
from .shape_utils import to_tuple

__all__ = ["Simulator"]


class Simulator(NoDistribution):
    r"""Forward-simulator pseudo-distribution for SMC-ABC
    (cf. ``simulator.py:14``)."""

    def __init__(self, function, *args, **kwargs):
        self.function = function
        self.params = list(args)
        shape = to_tuple(kwargs.pop("shape", ()))
        dtype = kwargs.pop("dtype", floatX())
        super().__init__(shape=shape, dtype=dtype,
                         testval=kwargs.pop("testval", 0.0), **kwargs)

    def _random(self, point=None, size=None, gen=None):
        """``function`` at the parameters drawn at ``point``, once, or once
        per sample along ``size``'s first axis. The function is handed CPU
        tensors (a numpy simulator reads them as arrays); the draws come
        back on this distribution's device."""
        params = [p.cpu() for p in draw_values(self.params, point=point,
                                                size=size, gen=gen)]
        if size is None:
            return torch.as_tensor(self.function(*params), device=self.device)
        n = to_tuple(size)[0]
        rows = zip(*[p if p.ndim and p.shape[0] == n else [p] * n
                     for p in params])
        return torch.stack([torch.as_tensor(self.function(*row))
                            for row in rows]).to(self.device)

    def __str__(self):
        return f"Simulator({getattr(self.function, '__name__', 'fn')})"
