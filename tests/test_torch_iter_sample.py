"""``iter_sample`` of the port: the single-chain host generator over
``step.step(point)``, on the cases of ``tests/test_sampling.py``
(``TestIterSample``): one trace per draw, each as long as the draws so
far, with sampler statistics on the host path and a compound step."""
import numpy as np

import pymc3_tpu_torch as pt

from . import torch_models  # noqa: F401  (asks the port for the CPU)


def _simple_model():
    with pt.Model() as model:
        pt.Normal("x", -2.1, tau=1.3, shape=2, testval=np.zeros(2))
    return model


def test_iter():
    model = _simple_model()
    with model:
        step = pt.Metropolis(vars=model.free_RVs, blocked=True)
        traces = list(pt.iter_sample(20, step, model=model, random_seed=1))
    assert len(traces) == 20
    assert len(traces[-1]) == 20
    x = traces[-1]["x"]
    assert x.shape == (20, 2) and np.all(np.isfinite(x))
    assert len(np.unique(x[:, 0])) > 1


def test_cumulative_nuts():
    model = _simple_model()
    with model:
        step = pt.NUTS()
        lengths, last = [], None
        for i, trace in enumerate(pt.iter_sample(
                8, step, start=model.test_point, tune=2, random_seed=11)):
            lengths.append(len(trace))
            last = trace
            if i >= 7:
                break
    assert lengths == list(range(1, 9))
    assert last["x"].shape == (8, 2)
    assert "diverging" in last.stat_names
    assert last.get_sampler_stats("tune").tolist() == [True] * 2 + [False] * 6


def test_cumulative_compound():
    with pt.Model() as model:
        pt.Normal("x", 0, 1)
        pt.Bernoulli("z", 0.6)
        steps = pt.assign_step_methods(model, None)
        step = pt.CompoundStep(steps) if isinstance(steps, list) else steps
        traces = list(pt.iter_sample(5, step, tune=1, random_seed=5))
    assert len(traces) == 5
    assert len(traces[-1]) == 5
    assert set(np.unique(traces[-1]["z"])).issubset({0, 1})


def test_callback_sees_every_draw_and_bad_draws_raise():
    model = _simple_model()
    seen = []
    step = pt.Metropolis(vars=model.free_RVs, model=model)
    list(pt.iter_sample(4, step, model=model, random_seed=2,
                        callback=lambda trace, draw: seen.append(draw[2])))
    assert seen == [0, 1, 2, 3]
    try:
        next(pt.iter_sample(0, step, model=model))
    except ValueError as err:
        assert "draws" in str(err)
    else:
        raise AssertionError("draws=0 must raise")
