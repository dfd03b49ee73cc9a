"""Arbitrary factor potentials (cf.
``pymc3_tpu/examples/factor_potential.py``): ``pm.Potential`` adds a term to
the joint log-density, the analog of Stan's ``target += u``. With
``x ~ N(1, 1)`` and the factor ``exp(-x²)`` the posterior is N(1/3, 1/3)."""
import pymc3_tpu_torch as pm


def build_model():
    with pm.Model() as model:
        x = pm.Normal("x", 1, 1)
        pm.Potential("x2", -x ** 2)
    return model


def run(n=1000):
    if n == "short":
        n = 50
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False)
    print(pm.summary(trace))
    return trace


if __name__ == "__main__":
    run()
