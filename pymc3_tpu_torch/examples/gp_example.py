"""GP regression, ``Marginal`` with an ``ExpQuad`` covariance (cf.
``pymc3_tpu/examples/gp_example.py``): its logp runs the hand-written
covariance kernel forward and its gradient the backward kernel."""
import numpy as np

import pymc3_tpu_torch as pm


def make_data(n=60, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(0, 2, n)[:, None].astype(np.float32)
    f_true = np.sin(3 * X[:, 0]) * np.exp(-0.5 * X[:, 0])
    y = (f_true + 0.15 * rng.normal(size=n)).astype(np.float32)
    return X, y


def build_marginal(X, y):
    with pm.Model() as model:
        ls = pm.Gamma("ls", alpha=2, beta=4)
        eta = pm.HalfNormal("eta", 1.0)
        cov = eta ** 2 * pm.gp.cov.ExpQuad(1, ls)
        gp = pm.gp.Marginal(cov_func=cov)
        sigma = pm.HalfNormal("sigma", 0.5)
        gp.marginal_likelihood("y", X=X, y=y, noise=sigma)
    return model, gp


def run(n=500):
    X, y = make_data()
    model, gp = build_marginal(X, y)
    with model:
        trace = pm.sample(draws=n, tune=500, chains=2, progressbar=False,
                          nuts={"target_accept": 0.9})
    print(pm.summary(trace))
    with model:
        Xnew = np.linspace(0, 2.4, 20)[:, None].astype(np.float32)
        point = {v.name: np.median(trace.get_values(v.name), axis=0)
                 for v in model.free_RVs}
        mu, var = gp.predict(Xnew, point=point, diag=True)
        print("predictive mean head:", np.round(mu[:5], 3))
    return trace


if __name__ == "__main__":
    run()
