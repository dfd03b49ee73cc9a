"""Host time of ``save_trace`` and ``load_trace`` on the CPU for radon's
2048 chains of 30 draws of every unobserved variable, each with its NUTS
warmup-state checkpoint (what ``chip_smoke.py`` phase 26 saves), written
as uncompressed npz (what the port writes) and as compressed npz (what the
JAX package writes). Not a test: it prints one JSON line. Run from the
repository root:

    python tests/torch_trace_io.py
"""
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(chains=2048, draws=30):
    sys.path.insert(0, ROOT)
    import pymc3_tpu_torch as pm
    from pymc3_tpu_torch.backends import ndarray
    from pymc3_tpu_torch.backends.base import MultiTrace
    from pymc3_tpu_torch.examples.radon import build_model
    from pymc3_tpu_torch.sampling import _warmup_checkpoints
    pm.set_config(device="cpu")
    model = build_model(pm)
    step = pm.NUTS(model=model)
    q = torch.as_tensor(np.stack([model.dict_to_array(model.test_point)]
                                 * chains))
    warm = _warmup_checkpoints(step, step.kernel_init(q), chains)
    rng = np.random.default_rng(0)
    straces = []
    for c in range(chains):
        s = ndarray.NDArray(model=model)
        s.setup(draws, c, [{"diverging": bool, "step_size": np.float64}])
        s.record_batch({k: rng.normal(size=(draws,) + sh).astype(np.float32)
                        for k, sh in s.var_shapes.items()}, draws,
                       [{"diverging": np.zeros(draws, bool),
                         "step_size": np.ones(draws)}])
        s.warmup_state = warm[c]
        straces.append(s)
    trace = MultiTrace(straces)
    out = {"chains": chains, "draws": draws, "device": "cpu"}
    savez = np.savez
    for label, writer in (("uncompressed", savez),
                          ("compressed", np.savez_compressed)):
        np.savez = writer
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            path = pm.save_trace(trace, os.path.join(tmp, "t"))
            t_save = time.perf_counter() - t0
            t0 = time.perf_counter()
            pm.load_trace(path, model=model)
            out[label] = {"save_s": t_save,
                          "load_s": time.perf_counter() - t0}
    np.savez = savez
    print(json.dumps(out))


if __name__ == "__main__":
    main()
