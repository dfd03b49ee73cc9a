"""Stein variational helpers (cf. ``pymc3_tpu/variational/stein.py``)."""
from __future__ import annotations

__all__ = ["Stein"]


class Stein:
    """The pieces of the SVGD direction (cf. ``stein.py:12``)."""

    def __init__(self, approx, kernel, temperature=1.0):
        self.approx = approx
        self.kernel = kernel
        self.temperature = float(temperature)

    def grad(self, particles):
        """The SVGD ascent direction ``phi*(x)`` of the particle set."""
        _, glogp = self.approx.model.logp_dlogp_function()(particles)
        kxy, dxkxy = self.kernel(particles)
        return (kxy @ glogp / self.temperature + dxkxy) / particles.shape[0]
