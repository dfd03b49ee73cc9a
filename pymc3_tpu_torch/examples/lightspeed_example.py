"""Simon Newcomb's light-speed measurements
(cf. ``pymc3_tpu/examples/lightspeed_example.py``)."""
import numpy as np

import pymc3_tpu_torch as pm

light_speed = np.array(
    [28, 26, 33, 24, 34, -44, 27, 16, 40, -2, 29, 22, 24, 21, 25, 30, 23,
     29, 31, 19, 24, 20, 36, 32, 36, 28, 25, 21, 28, 29, 37, 25, 28, 26,
     30, 32, 36, 26, 30, 22, 36, 23, 27, 27, 28, 27, 31, 27, 26, 33, 26,
     32, 32, 24, 39, 28, 24, 25, 32, 25, 29, 27, 28, 29, 16, 23],
    dtype=np.float32)


def build_model():
    with pm.Model() as model:
        beta = pm.Uniform("beta", lower=-100, upper=100)
        sigma = pm.Uniform("sigma", lower=0, upper=80)
        pm.Normal("y", mu=beta, sigma=sigma, observed=light_speed)
    return model


def run(n=1000):
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=500, chains=2, progressbar=False)
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
