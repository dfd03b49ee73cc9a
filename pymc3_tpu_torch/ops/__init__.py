"""Hand-written device kernels of the port, each beside its plain version."""
from .gp_cov import stationary_cov, STATIONARY_KINDS

__all__ = ["stationary_cov", "STATIONARY_KINDS"]
