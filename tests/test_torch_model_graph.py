"""The port's model graph against the JAX package's.

``ModelGraph.make_compute_graph()`` (the parents of each variable),
``get_plates()`` and the ``graphviz.Digraph`` source, as a sorted list of
lines, equal the JAX package's for three models: the model of
``tests/test_model_features.py::test_model_graph_deps``, radon with
``coords``/``dims`` (``examples/radon.py``) and the imputed lasso of
``examples/lasso_missing.py``. The JAX package visits plates and edges in
set order, which changes between processes, so only the sorted lines are
compared; the port's source is also the same in two fresh processes.
Without graphviz ``model_to_graphviz`` raises the JAX package's
``ImportError``; without matplotlib and graphviz the port imports.
"""
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest

import pymc3_tpu as pj
import pymc3_tpu_torch as pt
from pymc3_tpu.model_graph import ModelGraph as JaxModelGraph
from pymc3_tpu_torch.model_graph import ModelGraph
from . import torch_models  # noqa: F401  (asks the port for the CPU)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _deps_model(pm):
    with pm.Model() as model:
        a = pm.Normal("a", 0, 1)
        b = pm.Normal("b", mu=a, sigma=1)
        c = pm.Deterministic("c", a + b)
        pm.Normal("obs", mu=c, sigma=1, observed=np.float32(0.5))
    return model


def _radon(pm):
    from pymc3_tpu_torch.examples.radon import build_model
    return build_model(pm, coords=True)


def _lasso(pm):
    if pm is pt:
        from pymc3_tpu_torch.examples.lasso_missing import build_model
    else:
        from pymc3_tpu.examples.lasso_missing import build_model
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return build_model()


MODELS = {"deps": _deps_model, "radon": _radon, "lasso_missing": _lasso}


@pytest.fixture(scope="module", params=sorted(MODELS))
def models(request):
    build = MODELS[request.param]
    return request.param, build(pj), build(pt)


def test_compute_graph_matches_jax(models):
    _, jm, tm = models
    assert ModelGraph(tm).make_compute_graph() == \
        JaxModelGraph(jm).make_compute_graph()


def test_plates_match_jax(models):
    _, jm, tm = models
    assert ModelGraph(tm).get_plates() == JaxModelGraph(jm).get_plates()


def test_graphviz_source_matches_jax(models):
    _, jm, tm = models
    got = pt.model_to_graphviz(tm).source.splitlines()
    want = pj.model_to_graphviz(jm).source.splitlines()
    assert sorted(got) == sorted(want)


def test_known_parents():
    """The dependency model's parents and radon's, written out."""
    g = ModelGraph(_deps_model(pt)).make_compute_graph()
    assert g == {"a": set(), "b": {"a"}, "c": {"a", "b"}, "obs": {"c"}}
    radon = ModelGraph(_radon(pt))
    assert radon.make_compute_graph()["radon_like"] == {
        "mu_a", "sigma_a", "a", "mu_b", "sigma_b", "b", "eps"}
    assert radon.get_plates()[(85,)] == {"a", "b"}
    lasso = ModelGraph(_lasso(pt)).make_compute_graph()
    assert lasso["disability_imp"] == {"p_disab", "disability_imp_missing"}


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=180, cwd=ROOT)


def test_source_is_the_same_in_every_process():
    code = ("import pymc3_tpu_torch as pm; pm.set_config(device='cpu'); "
            "from pymc3_tpu_torch.examples.radon import build_model; "
            "print(pm.model_to_graphviz(build_model(pm, coords=True))"
            ".source)")
    first, second = _run(code), _run(code)
    assert first.returncode == 0, first.stderr
    assert first.stdout == second.stdout


def test_missing_graphviz_raises_the_jax_error():
    code = ("import sys; sys.modules['graphviz'] = None\n"
            "import pymc3_tpu as pj, pymc3_tpu_torch as pt\n"
            "pt.set_config(device='cpu')\n"
            "for pm in (pj, pt):\n"
            "    with pm.Model() as m:\n"
            "        pm.Normal('x', 0.0, 1.0)\n"
            "    try:\n"
            "        pm.model_to_graphviz(m)\n"
            "    except ImportError as e:\n"
            "        print(repr(str(e)))\n")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    jax_text, port_text = out.stdout.strip().splitlines()
    assert port_text == jax_text
    assert "conda install -c conda-forge python-graphviz" in port_text


def test_import_without_matplotlib_or_graphviz():
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "sys.modules['graphviz'] = None; import pymc3_tpu_torch as pm; "
            "print(pm.traceplot.__name__, pm.model_to_graphviz.__name__)")
    out = _run(code)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["traceplot", "model_to_graphviz"]
