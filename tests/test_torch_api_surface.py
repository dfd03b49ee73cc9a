"""Every public name of the JAX package exists in the port.

The names are ``dir(pymc3_tpu)`` less the private ones and the
submodules, as ``import pymc3_tpu as pm`` offers them to a user. The
exclusion list is empty: the plots and the model graph, its last names,
are ported (``tests/test_torch_plots.py``,
``tests/test_torch_model_graph.py``); ``tests/test_torch_submodule_surface.py``
holds every submodule's names.
"""
import types

import pytest

import pymc3_tpu as pj
import pymc3_tpu_torch as pt

from . import torch_models  # noqa: F401  (the port on the CPU)

NOT_YET_PORTED = set()

# ``handler`` exists in the JAX package only where logging had no root
# handler when it was imported; it has a case of its own, so that every
# test process collects the same cases
CONDITIONAL = {"handler"}

JAX_NAMES = sorted(
    n for n in dir(pj) if not n.startswith("_") and n not in CONDITIONAL
    and not isinstance(getattr(pj, n), types.ModuleType))


def test_exclusions_are_public_names_of_the_jax_package():
    assert NOT_YET_PORTED <= set(JAX_NAMES)
    assert not any(hasattr(pt, n) for n in NOT_YET_PORTED)


@pytest.mark.parametrize("name", [n for n in JAX_NAMES
                                  if n not in NOT_YET_PORTED])
def test_public_name_exists_in_the_port(name):
    assert hasattr(pt, name), name
    assert callable(getattr(pt, name)) == callable(getattr(pj, name)), name


def test_logging_handler():
    """The port always has ``handler``, the JAX package's name for its
    package logger's handler."""
    import logging
    assert isinstance(pt.handler, logging.Handler)
    if hasattr(pj, "handler"):
        assert type(pt.handler) is type(pj.handler)
