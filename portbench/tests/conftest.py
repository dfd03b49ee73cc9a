"""Tests of the port's benchmark. They run on the CPU at small sizes; a
test that needs a CUDA card carries the ``chip`` marker and decides inside
itself whether there is one. On the card, where JAX is not installed and
so the repository's root conftest cannot load: ``python3 -m pytest
--confcutdir=portbench portbench/tests -m chip``."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one")
