"""Hamiltonian samplers (cf. ``pymc3_tpu/step_methods/hmc``)."""
from .hmc import HamiltonianMC
from .nuts import NUTS
from .quadpotential import (
    QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialFull,
    QuadPotentialFullAdapt, QuadPotentialFullInv, quad_potential,
)

__all__ = ["NUTS", "HamiltonianMC", "QuadPotentialDiag",
           "QuadPotentialDiagAdapt", "QuadPotentialFull",
           "QuadPotentialFullInv", "QuadPotentialFullAdapt",
           "quad_potential"]
