"""Where the port's models are built: on the card unless the caller asks
for the CPU, and never on the CPU behind the caller's back. And: no source
file of the port imports JAX or the JAX package.
"""
import ast
import pathlib

import numpy as np
import pytest
import torch

import pymc3_tpu_torch as pt
from pymc3_tpu_torch.node import current_device

from . import torch_models  # noqa: F401  (asks the port for the CPU)

ROOT = pathlib.Path(__file__).resolve().parent.parent


@pytest.fixture
def card_by_default():
    """The configuration a user starts with; the tests' own afterwards."""
    pt.set_config(device="cuda")
    yield
    pt.set_config(device="cpu")


def test_the_default_device_is_the_card():
    assert pt.config.Config().device == "cuda"
    assert pt.get_config().device == "cpu"      # these tests asked for it


def test_model_without_a_card_raises_and_names_the_ways_out(card_by_default):
    if torch.cuda.is_available():
        with pt.Model() as model:
            pt.Normal("x", 0.0, 1.0)
        assert model.device.type == "cuda"
        return
    with pytest.raises(RuntimeError) as err:
        pt.Model()
    assert 'set_config(device="cpu")' in str(err.value)
    assert 'Model(device="cpu")' in str(err.value)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        current_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pt.Normal.dist(0.0, 1.0)


def test_an_explicit_device_wins_and_a_submodel_takes_its_parents(
        card_by_default):
    with pt.Model(device="cpu") as model:
        x = pt.Normal("x", 0.0, 1.0)
        assert current_device() == torch.device("cpu")
        with pt.Model(name="sub") as sub:
            pt.Poisson("k", 3.0)
    assert model.device == sub.device == torch.device("cpu")
    assert x.distribution.device == torch.device("cpu")
    assert np.isfinite(model.logp(model.test_point))


def test_with_the_cpu_configured_models_build_and_sample_there():
    with pt.Model() as model:
        pt.Normal("x", 0.0, 1.0)
        pt.Bernoulli("b", 0.3)
    assert model.device == torch.device("cpu")
    tr = pt.sample(draws=5, tune=5, chains=2, model=model, random_seed=1,
                   progressbar=False, compute_convergence_checks=False)
    assert tr["x"].shape == (10,)
    with pytest.raises(KeyError):
        pt.set_config(devise="cpu")


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


SOURCES = sorted((ROOT / "pymc3_tpu_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def test_no_source_of_the_port_imports_jax_or_the_jax_package():
    names = {p.relative_to(ROOT).as_posix() for p in SOURCES}
    for expected in ("pymc3_tpu_torch/distributions/discrete.py",
                     "pymc3_tpu_torch/step_methods/metropolis.py",
                     "pymc3_tpu_torch/step_methods/compound.py",
                     "pymc3_tpu_torch/step_methods/slicer.py",
                     "pymc3_tpu_torch/step_methods/hmc/hmc.py",
                     "pymc3_tpu_torch/examples/disaster_model.py",
                     "pymc3_tpu_torch/smc/smc.py",
                     "pymc3_tpu_torch/smc/sample_smc.py",
                     "pymc3_tpu_torch/distributions/simulator.py",
                     "pymc3_tpu_torch/gp/gp.py",
                     "chip_smoke.py"):
        assert expected in names
    bad = [(p.relative_to(ROOT).as_posix(), mod) for p in SOURCES
           for mod in _imports(p)
           if mod.split(".")[0] in ("jax", "jaxlib", "pymc3_tpu")]
    assert not bad, bad
