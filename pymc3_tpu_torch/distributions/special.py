"""Special functions (cf. ``pymc3_tpu/distributions/special.py``)."""
import torch

__all__ = ["gammaln", "multigammaln", "psi", "log_i0", "digamma"]



def gammaln(x):
    return torch.special.gammaln(x)


def digamma(x):
    return torch.special.digamma(x)


psi = digamma


def multigammaln(a, p):
    """Multivariate log gamma of dimension p (cf. ``special.py:12``)."""
    return torch.special.multigammaln(a, int(p))


def log_i0(x):
    """log of the modified Bessel I0, stable for large |x|: log(i0e(x)) + |x|
    (cf. ``special.py:17``)."""
    return torch.log(torch.special.i0e(x)) + torch.abs(x)
