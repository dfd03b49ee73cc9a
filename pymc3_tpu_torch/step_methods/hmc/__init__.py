"""Hamiltonian samplers (cf. ``pymc3_tpu/step_methods/hmc``)."""
from .hmc import HamiltonianMC
from .nuts import NUTS
from .quadpotential import (
    QuadPotentialDiag, QuadPotentialDiagAdapt, QuadPotentialDiagAdaptGrad,
    QuadPotentialFull,
    QuadPotentialFullAdapt, QuadPotentialFullInv, quad_potential,
)

__all__ = ["NUTS", "HamiltonianMC", "QuadPotentialDiag",
           "QuadPotentialDiagAdapt", "QuadPotentialDiagAdaptGrad",
           "QuadPotentialFull",
           "QuadPotentialFullInv", "QuadPotentialFullAdapt",
           "quad_potential"]
