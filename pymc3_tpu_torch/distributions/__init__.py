"""Distributions library (cf. ``pymc3_tpu/distributions/__init__.py``)."""
from . import transforms
from .distribution import (
    Distribution, Continuous, Discrete, NoDistribution, DensityDist,
    TransformedDistribution, TensorType, draw_values, generate_samples,
)
from .continuous import (
    Uniform, Flat, HalfFlat, Normal, TruncatedNormal, HalfNormal, Wald, Beta,
    Kumaraswamy, Exponential, Laplace, Lognormal, StudentT, Pareto, Cauchy,
    HalfCauchy, Gamma, InverseGamma, ChiSquared, Weibull, HalfStudentT,
    ExGaussian, VonMises, SkewNormal, Triangular, Gumbel, Rice, Logistic,
    LogitNormal, Interpolated,
)
from .discrete import (
    Binomial, BetaBinomial, Bernoulli, DiscreteWeibull, Poisson,
    NegativeBinomial, Constant, ConstantDist, ZeroInflatedPoisson,
    ZeroInflatedBinomial, ZeroInflatedNegativeBinomial, DiscreteUniform,
    Geometric, Categorical, OrderedLogistic,
)
from .multivariate import (
    MvNormal, MvStudentT, Dirichlet, Multinomial, Wishart, WishartBartlett,
    LKJCorr, LKJCholeskyCov, MatrixNormal, KroneckerNormal,
)
from .timeseries import (
    AR1, AR, GaussianRandomWalk, GARCH11, EulerMaruyama, MvGaussianRandomWalk,
    MvStudentTRandomWalk,
)
from .mixture import Mixture, NormalMixture
from .bound import Bound
from .simulator import Simulator

__all__ = [
    "Uniform", "Flat", "HalfFlat", "Normal", "TruncatedNormal", "HalfNormal",
    "Wald", "Beta", "Kumaraswamy", "Exponential", "Laplace", "Lognormal",
    "StudentT", "Pareto", "Cauchy", "HalfCauchy", "Gamma", "InverseGamma",
    "ChiSquared", "Weibull", "HalfStudentT", "ExGaussian", "VonMises",
    "SkewNormal", "Triangular", "Gumbel", "Rice", "Logistic", "LogitNormal",
    "Interpolated", "Binomial", "BetaBinomial", "Bernoulli",
    "DiscreteWeibull", "Poisson", "NegativeBinomial", "Constant",
    "ConstantDist", "ZeroInflatedPoisson", "ZeroInflatedBinomial",
    "ZeroInflatedNegativeBinomial", "DiscreteUniform", "Geometric",
    "Categorical", "OrderedLogistic", "MvNormal", "MvStudentT", "Dirichlet",
    "Multinomial", "Wishart", "WishartBartlett", "LKJCorr", "LKJCholeskyCov",
    "MatrixNormal", "KroneckerNormal", "AR1", "AR", "GaussianRandomWalk",
    "GARCH11", "EulerMaruyama", "MvGaussianRandomWalk",
    "MvStudentTRandomWalk", "Mixture", "NormalMixture",
    "Bound", "Simulator", "Distribution", "Continuous", "Discrete",
    "NoDistribution",
    "DensityDist", "TransformedDistribution", "draw_values",
    "generate_samples", "transforms", "TensorType",
]
