from .ode import DifferentialEquation

__all__ = ["DifferentialEquation"]
