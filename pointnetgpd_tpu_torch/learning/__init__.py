"""Bandit/learning utilities (reference: dex-net/src/dexnet/learning/).

Host-side adaptive-sampling machinery; the expensive objective evaluations
(grasp quality) run as batched device calls. The main-path consumer is
robust grasp quality's Monte-Carlo mean (GaussianUniformAllocationMean,
reference robust_grasp_quality.py:126-166).

The port's own copy of ``pointnetgpd_tpu/learning/__init__.py`` (numpy only).
"""

from .analysis import ClassificationResult, ConfusionMatrix, RegressionResult
from .models import (
    BernoulliModel,
    BetaBernoulliModel,
    CorrelatedBetaBernoulliModel,
    GaussianModel,
    SquaredExponentialKernel,
)
from .objectives import (
    CCBPLogLikelihood,
    CrossEntropyLoss,
    DifferentiableObjective,
    IdentityObjective,
    LeastSquaresObjective,
    LogisticCrossEntropyObjective,
    MaximizationObjective,
    MinimizationObjective,
    NonDeterministicObjective,
    Objective,
    RandomBinaryObjective,
    RandomContinuousObjective,
    SquaredErrorLoss,
    WeightedSquaredErrorLoss,
    ZeroOneObjective,
)
from .policies import (
    BetaBernoulliBayesUCBPolicy,
    BetaBernoulliGittinsIndex98Policy,
    GaussianUCBPolicy,
    MaxDiscreteSelectionPolicy,
    ThompsonSelectionPolicy,
    UniformSelectionPolicy,
    UCBSelectionPolicy,
)
from .gittins import gittins_index, gittins_index_table
from .samplers import (
    AdaptiveSamplingResult,
    GittinsIndex98,
    BetaBernoulliBandit,
    CorrelatedBayesUCB,
    CorrelatedBetaBernoulliBandit,
    CorrelatedGittins,
    CorrelatedThompsonSampling,
    DiscreteAdaptiveSampler,
    GaussianBandit,
    GaussianUniformAllocationMean,
    ThompsonSampling,
    UniformAllocationMean,
)
from .termination import (
    AndTerminationCondition,
    ConfidenceTerminationCondition,
    MaxIterTerminationCondition,
    OrTerminationCondition,
    ThresholdTerminationCondition,
)
from .solvers import (
    DiscreteSamplingSolver,
    OptimizationSolver,
    SamplingSolver,
    Solver,
    TopKSolver,
)
from .tensor_dataset import Tensor, TensorDatapoint, TensorDataset

__all__ = [
    "ClassificationResult", "ConfusionMatrix", "RegressionResult",
    "BernoulliModel", "BetaBernoulliModel", "CorrelatedBetaBernoulliModel",
    "GaussianModel", "SquaredExponentialKernel",
    "CCBPLogLikelihood", "CrossEntropyLoss", "DifferentiableObjective",
    "IdentityObjective", "LeastSquaresObjective",
    "LogisticCrossEntropyObjective", "MaximizationObjective",
    "MinimizationObjective", "NonDeterministicObjective", "Objective",
    "RandomBinaryObjective", "RandomContinuousObjective",
    "SquaredErrorLoss", "WeightedSquaredErrorLoss", "ZeroOneObjective",
    "BetaBernoulliBayesUCBPolicy", "BetaBernoulliGittinsIndex98Policy",
    "GaussianUCBPolicy", "GittinsIndex98",
    "gittins_index", "gittins_index_table",
    "MaxDiscreteSelectionPolicy",
    "ThompsonSelectionPolicy", "UniformSelectionPolicy", "UCBSelectionPolicy",
    "AdaptiveSamplingResult", "BetaBernoulliBandit",
    "CorrelatedBayesUCB", "CorrelatedBetaBernoulliBandit",
    "CorrelatedGittins", "CorrelatedThompsonSampling",
    "DiscreteAdaptiveSampler",
    "GaussianBandit", "GaussianUniformAllocationMean", "ThompsonSampling",
    "UniformAllocationMean",
    "AndTerminationCondition", "ConfidenceTerminationCondition",
    "MaxIterTerminationCondition",
    "OrTerminationCondition", "ThresholdTerminationCondition",
    "DiscreteSamplingSolver", "OptimizationSolver", "SamplingSolver",
    "Solver", "TopKSolver",
    "Tensor", "TensorDatapoint", "TensorDataset",
]
