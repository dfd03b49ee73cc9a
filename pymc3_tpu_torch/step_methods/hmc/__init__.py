"""Hamiltonian samplers (cf. ``pymc3_tpu/step_methods/hmc``)."""
from .nuts import NUTS
from .quadpotential import QuadPotentialDiagAdapt

__all__ = ["NUTS", "QuadPotentialDiagAdapt"]
