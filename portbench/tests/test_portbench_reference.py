"""The plain references against closed forms and finite differences, and
the ESS against autoregressive chains of known ESS."""
import math

import numpy as np
import pytest
import torch
from scipy import stats

from portbench.ess import bulk_ess
from portbench.reference import radon

RNG = np.random.default_rng(7)


def _radon_rows(rows=40, counties=4):
    county = np.arange(rows) % counties
    floor = (RNG.random(rows) < 0.3).astype(np.float64)
    y = RNG.normal(1.0, 0.8, rows)
    return county, floor, y


def _radon_point(B, counties):
    return {"mu_a": torch.tensor(RNG.normal(1.0, 0.3, B)),
            "sigma_a_log__": torch.tensor(RNG.normal(-1.0, 0.3, B)),
            "mu_b": torch.tensor(RNG.normal(-0.5, 0.3, B)),
            "sigma_b_log__": torch.tensor(RNG.normal(-1.5, 0.3, B)),
            "a": torch.tensor(RNG.normal(0, 1, (B, counties))),
            "b": torch.tensor(RNG.normal(0, 1, (B, counties))),
            "eps_log__": torch.tensor(RNG.normal(-0.3, 0.2, B))}


def test_radon_logp_closed_form():
    rows = _radon_rows()
    data = radon.Data(rows=rows)
    p = _radon_point(3, 4)
    got = radon.logp(p, data).numpy()
    county, floor, y = rows
    for i in range(3):
        v = {k: t[i].numpy() for k, t in p.items()}
        sa, sb, e = (np.exp(v[k]) for k in ("sigma_a_log__", "sigma_b_log__",
                                            "eps_log__"))
        mean = (v["mu_a"] + sa * v["a"])[county] \
            + (v["mu_b"] + sb * v["b"])[county] * floor
        want = stats.norm.logpdf(y, mean, e).sum()
        want += stats.norm.logpdf([v["mu_a"], v["mu_b"]], 0, 1e4).sum()
        want += stats.norm.logpdf(np.r_[v["a"], v["b"]]).sum()
        for s, u in ((sa, "sigma_a_log__"), (sb, "sigma_b_log__"),
                     (e, "eps_log__")):
            want += stats.halfcauchy.logpdf(s, scale=5.0) + v[u]
        assert got[i] == pytest.approx(want, rel=1e-12, abs=1e-9)


def test_radon_grad_finite_differences():
    data = radon.Data(rows=_radon_rows())
    p = _radon_point(2, 4)
    g = radon.grad(p, data)
    h = 1e-6
    for k, v in p.items():
        flat = v.reshape(2, -1)
        for j in range(flat.shape[1]):
            up = {kk: vv.clone() for kk, vv in p.items()}
            dn = {kk: vv.clone() for kk, vv in p.items()}
            up[k].reshape(2, -1)[:, j] += h
            dn[k].reshape(2, -1)[:, j] -= h
            fd = (radon.logp(up, data) - radon.logp(dn, data)) / (2 * h)
            np.testing.assert_allclose(g[k].reshape(2, -1)[:, j].numpy(),
                                       fd.numpy(), rtol=1e-6, atol=1e-5)


def test_radon_conditional_is_the_gaussian_posterior():
    """The conditional mean and covariance of (a_raw, b_raw) in one county
    against the normal posterior of that county's linear regression,
    worked out with dense matrices."""
    rows = _radon_rows()
    data = radon.Data(rows=rows)
    p = _radon_point(2, 4)
    m_a, m_b, (caa, cab, cbb) = radon.conditional(p, data)
    county, floor, y = rows
    for i in range(2):
        v = {k: t[i].numpy() for k, t in p.items()}
        sa, sb, e = (np.exp(v[k]) for k in ("sigma_a_log__", "sigma_b_log__",
                                            "eps_log__"))
        for c in range(4):
            sel = county == c
            X = np.stack([np.full(sel.sum(), sa), sb * floor[sel]], 1)
            z = y[sel] - v["mu_a"] - v["mu_b"] * floor[sel]
            cov = np.linalg.inv(np.eye(2) + X.T @ X / e ** 2)
            mean = cov @ X.T @ z / e ** 2
            np.testing.assert_allclose([m_a[i, c], m_b[i, c]], mean,
                                       rtol=1e-10)
            np.testing.assert_allclose(
                [caa[i, c], cab[i, c], cbb[i, c]],
                [cov[0, 0], cov[0, 1], cov[1, 1]], rtol=1e-10)


def test_radon_conditional_draws_standardise():
    data = radon.Data(rows=_radon_rows())
    p = _radon_point(1, 4)
    p = {k: v.expand((20000,) + v.shape[1:]).clone() for k, v in p.items()}
    gen = torch.Generator().manual_seed(3)
    p["a"], p["b"] = radon.conditional_draw(p, data, gen)
    za, zb = radon.conditional_z(p, data)
    for z in (za, zb):
        assert float(z.mean(0).abs().max()) < 0.05
        assert float((z.std(0) - 1).abs().max()) < 0.05


def test_radon_frozen_data_are_the_published_rows():
    """The frozen columns against the example data the port ships."""
    import csv
    from pathlib import Path
    county, floor, y = radon.load_data()
    assert (len(y), county.max() + 1) == (919, 85)
    src = Path(__file__).resolve().parents[2] / "pymc3_tpu_torch" / \
        "examples" / "data" / "radon.csv"
    if not src.exists():
        pytest.skip("the port's example data are not in this checkout")
    rows = list(csv.DictReader(open(src)))
    np.testing.assert_array_equal(county, [int(r["county_code"]) for r in rows])
    np.testing.assert_array_equal(floor, [float(r["floor"]) for r in rows])
    np.testing.assert_array_equal(
        y, np.float32([float(r["log_radon"]) for r in rows]))


@pytest.mark.parametrize("rho", [0.0, 0.5, 0.8])
def test_bulk_ess_of_ar1_chains(rho):
    chains, n = 400, 400
    e = RNG.normal(size=(chains, n))
    x = np.empty_like(e)
    x[:, 0] = e[:, 0] / math.sqrt(1 - rho ** 2)
    for t in range(1, n):
        x[:, t] = rho * x[:, t - 1] + e[:, t]
    want = chains * n * (1 - rho) / (1 + rho)
    assert bulk_ess(x) == pytest.approx(want, rel=0.08)


def test_bulk_ess_sees_chains_that_disagree():
    x = RNG.normal(size=(8, 200)) + np.arange(8)[:, None]
    assert bulk_ess(x) < 0.05 * x.size
