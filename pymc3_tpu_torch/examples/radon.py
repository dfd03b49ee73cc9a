"""The radon hierarchical model of the benchmark of record (``bench.py``),
read without pandas.

``build_model(pm)`` reproduces ``bench.py:build_model`` exactly: the same
non-centred county intercepts and slopes, the same priors, float32
``log_radon``, for either package passed as ``pm``. With
``coords=True`` the model also names its counties
(``coords={"county": ...}``, ``dims="county"`` on the county
parameters) and adds ``Deterministic("a_range", a.max() - a.min())``.
"""
from __future__ import annotations

import csv
from pathlib import Path

import numpy as np

DATA = Path(__file__).resolve().parent / "data" / "radon.csv"

__all__ = ["load_radon", "load_radon_columns", "county_names",
           "build_model"]


def load_radon(path=DATA):
    """``(floor float64, county_idx int32, n_counties, log_radon float32)``."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    floor = np.array([float(r["floor"]) for r in rows])
    county_idx = np.array([int(r["county_code"]) for r in rows],
                          dtype="int32")
    n_counties = len({r["county"] for r in rows})
    log_radon = np.array([float(r["log_radon"]) for r in rows],
                         dtype=np.float32)
    return floor, county_idx, n_counties, log_radon


def load_radon_columns(path=DATA):
    """The columns a GLM formula names, as a dict of numpy arrays:
    ``log_radon`` (float32), ``floor`` (float64) and ``county`` (the county
    names, whose sorted order sets ``C(county)``'s levels)."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    return {"log_radon": np.array([float(r["log_radon"]) for r in rows],
                                  dtype=np.float32),
            "floor": np.array([float(r["floor"]) for r in rows]),
            "county": np.array([r["county"].strip() for r in rows])}


def county_names(path=DATA):
    """The county names in the order of their codes (``a[county_idx]``'s
    order)."""
    with open(path, newline="") as f:
        by_code = {int(r["county_code"]): r["county"].strip()
                   for r in csv.DictReader(f)}
    return [by_code[c] for c in sorted(by_code)]


def build_model(pm, coords=False):
    floor, county_idx, n_counties, log_radon = load_radon()
    dims = "county" if coords else None
    with pm.Model(coords={"county": county_names()} if coords
                  else None) as model:
        mu_a = pm.Normal("mu_a", mu=0.0, sigma=100.0 ** 2)
        sigma_a = pm.HalfCauchy("sigma_a", 5)
        mu_b = pm.Normal("mu_b", mu=0.0, sigma=100.0 ** 2)
        sigma_b = pm.HalfCauchy("sigma_b", 5)
        a_raw = pm.Normal("a", mu=0.0, sigma=1.0, shape=n_counties,
                          dims=dims)
        b_raw = pm.Normal("b", mu=0.0, sigma=1.0, shape=n_counties,
                          dims=dims)
        a = mu_a + sigma_a * a_raw
        b = mu_b + sigma_b * b_raw
        if coords:
            pm.Deterministic("a_range", a.max() - a.min())
        eps = pm.HalfCauchy("eps", 5)
        radon_est = a[county_idx] + b[county_idx] * floor
        pm.Normal("radon_like", mu=radon_est, sigma=eps, observed=log_radon)
    return model
