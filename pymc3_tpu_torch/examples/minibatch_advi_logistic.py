"""Logistic regression fitted by minibatch ADVI (cf.
``pymc3_tpu/examples/minibatch_advi_logistic.py``): one minibatch view of
the joined columns, so that the rows of X and y stay paired."""
import numpy as np
import torch

import pymc3_tpu_torch as pm
from pymc3_tpu_torch.node import apply as node_apply


def make_data(n=50000, d=10, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, d)).astype(np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    logits = X @ w_true
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-logits))).astype(np.int32)
    return X, y, w_true


def build_model(X, y, batch_size=500):
    n, d = X.shape
    joint = pm.Minibatch(np.concatenate(
        [X, y[:, None].astype(np.float32)], axis=1),
        batch_size=batch_size, name="joint")
    Xb = node_apply(lambda j: j[:, :-1], joint)
    yb = node_apply(lambda j: j[:, -1].to(torch.int32), joint)
    with pm.Model() as model:
        w = pm.Normal("w", 0.0, 10.0, shape=d)
        logits = node_apply(lambda Xb_, w_: Xb_ @ w_, Xb, w)
        p = pm.math.sigmoid(logits)
        pm.Bernoulli("y", p=p, observed=yb, total_size=n)
    return model


def run(n_fit=10000):
    X, y, w_true = make_data()
    model = build_model(X, y)
    approx = pm.fit(n=n_fit, method="advi", model=model, progressbar=False,
                    obj_optimizer=pm.variational.updates.adam(
                        learning_rate=0.02))
    w_est = approx.mean
    print("w_true:", np.round(w_true, 2))
    print("w_est :", np.round(w_est, 2))
    return approx


if __name__ == "__main__":
    run()
