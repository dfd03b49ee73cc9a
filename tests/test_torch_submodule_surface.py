"""Every module of the JAX package has its counterpart in the port, module
by module.

``pkgutil.walk_packages`` lists the JAX package's modules; each maps to
the port's module of the same path, but for ``jaxf`` -> ``torchf``,
``ops.pallas.gp_cov`` -> ``ops.gp_cov`` and ``ops.pallas`` -> ``ops``
(the one Pallas module's port is ``ops/gp_cov.py`` with its CUDA source).
The counterpart must have every public class and function the JAX module
defines, every name of its ``__all__``, and every public member of each
such class. ``tests/test_torch_api_surface.py`` holds the top-level names.

The one dict of exclusions maps a JAX name (relative to ``pymc3_tpu``) to
its counterpart in the port (``torch.`` for PyTorch's own), which a test
asserts exists; ``None`` marks the one name with no counterpart, whose
reason is stated beside it.
"""
import importlib
import inspect
import pkgutil

import pytest
import torch

import pymc3_tpu
import pymc3_tpu_torch

from . import torch_models  # noqa: F401  (asks the port for the CPU)

RENAMES = (("jaxf", "torchf"), ("ops.pallas.gp_cov", "ops.gp_cov"),
           ("ops.pallas", "ops"))

EXCLUDED = {
    # a flat vector to a dict of traced arrays: the port's logp builds its
    # environment of tensors from the flat point
    "blocking.DictToArrayBijection.rmap_jax": "model.Model._env_from_q",
    # the jitted pure logp of the flat point
    "model.ValueGradFunction.jax_fn": "model.Model.logp_point_fn",
    # XLA's compile cache: the port compiles its one CUDA source once,
    # keyed by the source's hash, into build/kernels
    "config.enable_compilation_cache": "ops.gp_cov.build",
    # XLA's matmul precision: PyTorch's own setting, left at its default
    # ("highest": float32 matmuls in full float32)
    "config.Config.matmul_precision": "torch.set_float32_matmul_precision",
    # The JAX package's switch, read from its environment and backend,
    # between its Pallas kernel and XLA. The port has one path on the card,
    # the kernel (a CPU tensor takes the plain version), so nothing to ask.
    "ops.pallas_stationary_available": None,
    "ops.pallas.gp_cov.pallas_stationary_available": None,
}


def _relative(module):
    return module[len("pymc3_tpu."):]


def port_module(module):
    rel = _relative(module)
    for old, new in RENAMES:
        if rel == old or rel.startswith(old + "."):
            rel = new + rel[len(old):]
            break
    return "pymc3_tpu_torch." + rel


JAX_MODULES = sorted(info.name for info in pkgutil.walk_packages(
    pymc3_tpu.__path__, "pymc3_tpu."))


def _public_names(module):
    """The classes and functions ``module`` defines, and its ``__all__``."""
    names = {n for n, obj in vars(module).items()
             if not n.startswith("_") and (inspect.isclass(obj)
                                           or inspect.isfunction(obj))
             and getattr(obj, "__module__", None) == module.__name__}
    return sorted(names | set(getattr(module, "__all__", ())))


def _missing(module):
    jm = importlib.import_module(module)
    tm = importlib.import_module(port_module(module))
    rel = _relative(module)
    missing = []
    for name in _public_names(jm):
        key = f"{rel}.{name}"
        if key in EXCLUDED:
            continue
        if not hasattr(tm, name):
            missing.append(key)
            continue
        obj = getattr(jm, name)
        if not inspect.isclass(obj):
            continue
        for member in vars(obj):
            if member.startswith("_") or f"{key}.{member}" in EXCLUDED:
                continue
            if not hasattr(getattr(tm, name), member):
                missing.append(f"{key}.{member}")
    return missing


@pytest.mark.parametrize("module", JAX_MODULES)
def test_module_has_its_port(module):
    assert _missing(module) == []


def _resolve(root, path):
    """``root.path``, importing the submodules on the way."""
    obj = root
    parts = path.split(".")
    for i, part in enumerate(parts):
        if hasattr(obj, part):
            obj = getattr(obj, part)
        else:
            obj = importlib.import_module(
                ".".join([root.__name__] + parts[:i + 1]))
    return obj


@pytest.mark.parametrize("name", sorted(EXCLUDED))
def test_exclusion_names_its_counterpart(name):
    """The excluded name is the JAX package's, and its counterpart is in
    the port (or, for the Pallas switch alone, none)."""
    assert _resolve(pymc3_tpu, name) is not None
    counterpart = EXCLUDED[name]
    if counterpart is None:
        assert name.endswith(".pallas_stationary_available")
    elif counterpart.startswith("torch."):
        assert callable(_resolve(torch, counterpart[len("torch."):]))
    else:
        assert _resolve(pymc3_tpu_torch, counterpart) is not None


def test_renamed_modules_exist():
    for module in ("pymc3_tpu.jaxf", "pymc3_tpu.ops.pallas",
                   "pymc3_tpu.ops.pallas.gp_cov"):
        assert importlib.import_module(port_module(module))
