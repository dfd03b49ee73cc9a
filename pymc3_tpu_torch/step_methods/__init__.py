"""Step methods (cf. ``pymc3_tpu/step_methods``). Ported so far: NUTS."""
from .arraystep import Competence, TuneContext
from .hmc import NUTS, QuadPotentialDiagAdapt

__all__ = ["NUTS", "Competence", "TuneContext", "QuadPotentialDiagAdapt"]
