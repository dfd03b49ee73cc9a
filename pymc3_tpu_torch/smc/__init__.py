"""Sequential Monte Carlo (cf. ``pymc3_tpu/smc/__init__.py``)."""
from .sample_smc import sample_smc
from .smc import SMC

__all__ = ["sample_smc", "SMC"]
