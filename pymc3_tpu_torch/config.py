"""Global configuration: the float and int widths of the port and the device
its models are built on.

Mirrors ``pymc3_tpu/config.py`` without the JAX compile-cache and Pallas
dispatch settings, which have no counterpart in eager PyTorch. As there,
``PYMC3_TPU_FLOATX`` (``float32`` or ``float64``) sets the float width at
import, and ``intX`` follows it.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import numpy as np
import torch

__all__ = ["floatX", "intX", "torch_floatX", "get_config", "set_config",
           "Config", "default_device"]


_FLOATX = os.environ.get("PYMC3_TPU_FLOATX", "float32")


@dataclasses.dataclass
class Config:
    """Typed global configuration.

    ``floatX`` is the float width of every continuous computation:
    ``PYMC3_TPU_FLOATX`` at import, float32 where it is not set. The card
    runs both widths (float64 through the float64 builds of the covariance
    kernels). ``intX`` follows it (int32 or int64).
    ``device`` is where a model is built, and so where it is sampled, when
    ``Model(device=...)`` names none: the card by default.
    ``compute_test_value`` is the JAX package's field of that name (the
    analog of Theano's ``compute_test_value='raise'``), which neither
    package reads: the port computes an operation's test value when it is
    first asked for, and a shape error raises there.
    """

    floatX: str = _FLOATX
    intX: str = "int64" if _FLOATX == "float64" else "int32"
    device: str = "cuda"
    compute_test_value: str = "raise"


_config = Config()


def get_config() -> Config:
    return _config


def set_config(**kwargs: Any) -> Config:
    """Update config fields; returns the config object."""
    for k, v in kwargs.items():
        if not hasattr(_config, k):
            raise KeyError(f"unknown config field {k!r}")
        setattr(_config, k, v)
    _config.intX = "int64" if _config.floatX == "float64" else "int32"
    return _config


def default_device() -> torch.device:
    """The configured device. Raises when it is a CUDA device and there is
    none: a model is never moved to the CPU behind the caller's back."""
    device = torch.device(_config.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"the configured device is {_config.device!r} and torch finds no "
            "CUDA device. To run on the CPU ask for it: "
            "set_config(device=\"cpu\") for every model, or "
            "Model(device=\"cpu\") for one.")
    return device


def torch_floatX() -> torch.dtype:
    """The torch dtype of ``floatX``."""
    return getattr(torch, _config.floatX)


def floatX(x=None):
    """Cast ``x`` (numpy) to the configured float dtype, or return its name."""
    if x is None:
        return _config.floatX
    if isinstance(x, (list, tuple)):
        return np.asarray(x, dtype=_config.floatX)
    if hasattr(x, "astype"):
        return x.astype(_config.floatX)
    return np.asarray(x, dtype=_config.floatX)


def intX(x=None):
    """Cast ``x`` (numpy) to the configured int dtype, or return its name."""
    if x is None:
        return _config.intX
    if hasattr(x, "astype"):
        return x.astype(_config.intX)
    return np.asarray(x, dtype=_config.intX)
