"""Lasso regression with imputed predictors (cf.
``pymc3_tpu/examples/lasso_missing.py``): Laplace-prior coefficients on test
scores, the masked entries of three predictors imputed as ``name_missing``
free variables. With no ``step``, ``sample()`` gives the continuous
variables NUTS and the imputed indicators the binary Gibbs sampler, in one
compound step. The data are read with the ``csv`` module."""
import csv
import io

import numpy as np
from numpy.ma import masked_values

import pymc3_tpu_torch as pm

COLUMNS = ["score", "male", "siblings", "prev_disab", "age_test",
           "mother_hs", "early_ident"]


def _number(field):
    """A csv field as a float: empty is missing (-999), as ``fillna(-999)``
    gives, and True/False are 1/0."""
    field = field.strip()
    if not field:
        return -999.0
    if field in ("True", "False"):
        return float(field == "True")
    return float(field)


def load_test_scores():
    """The seven columns of ``test_scores.csv`` as float64 arrays."""
    text = io.TextIOWrapper(pm.get_data("test_scores.csv"), newline="")
    rows = list(csv.DictReader(text))
    return tuple(np.array([_number(r[c]) for r in rows]) for c in COLUMNS)


# test score, gender, number of siblings, previous disability, age,
# mother with HS education or better, hearing loss identified by 3 months
(score, male, siblings, disability, age, mother_hs,
 early_ident) = load_test_scores()


def build_model():
    with pm.Model() as model:
        # impute missing predictors from their marginal models
        sib_mean = pm.Exponential("sib_mean", 1.0)
        siblings_imp = pm.Poisson("siblings_imp", sib_mean,
                                  observed=masked_values(siblings,
                                                         value=-999))

        p_disab = pm.Beta("p_disab", 1.0, 1.0)
        disability_imp = pm.Bernoulli(
            "disability_imp", p_disab,
            observed=masked_values(disability, value=-999))

        p_mother = pm.Beta("p_mother", 1.0, 1.0)
        mother_imp = pm.Bernoulli(
            "mother_imp", p_mother,
            observed=masked_values(mother_hs, value=-999))

        s = pm.HalfCauchy("s", 5.0, testval=5.0)
        beta = pm.Laplace("beta", 0.0, 100.0, shape=7, testval=0.1)

        expected_score = (beta[0] + beta[1] * male + beta[2] * siblings_imp
                          + beta[3] * disability_imp + beta[4] * age
                          + beta[5] * mother_imp + beta[6] * early_ident)
        pm.Normal("observed_score", expected_score, s, observed=score)
    return model


def run(n=1000):
    if n == "short":
        n = 100
    model = build_model()
    with model:
        trace = pm.sample(draws=n, tune=1000, chains=2, progressbar=False)
    print(pm.summary(trace, var_names=["beta", "s", "p_disab", "p_mother",
                                       "sib_mean"]))
    return trace


if __name__ == "__main__":
    run()
