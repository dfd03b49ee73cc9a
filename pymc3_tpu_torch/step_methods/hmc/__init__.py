"""Hamiltonian samplers (cf. ``pymc3_tpu/step_methods/hmc``)."""
from .hmc import HamiltonianMC
from .nuts import NUTS
from .quadpotential import QuadPotentialDiagAdapt

__all__ = ["NUTS", "HamiltonianMC", "QuadPotentialDiagAdapt"]
