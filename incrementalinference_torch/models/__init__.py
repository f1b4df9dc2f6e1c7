"""Factor models, and the model families (grid densities, network
ensembles, ODE factors)."""

from .densities import (HeatmapGridDensity, LevelSetGridNormal,
                        PartialPriorPassThrough)
from .factors import (MODEL_REGISTRY, CircularCircular, EuclidDistance,
                      FactorModel, GaussianJoint, GenericMarginal,
                      LinearRelative,
                      ManifoldFactor, ManifoldPrior, MetaPrior, Mixture,
                      MsgPrior, MsgRelativeLikelihood, PartialPrior, Prior,
                      PriorCircular, PriorModel, register_factor_model)
from .flux import (FluxModelsDistribution, MixtureFluxModels, SequentialNet,
                   mlp_apply, mlp_init, nn_init)
from .ode import DERelative, rk4_integrate

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "EuclidDistance", "PriorCircular", "CircularCircular", "Mixture",
           "PartialPrior", "MsgPrior", "MetaPrior", "GenericMarginal",
           "ManifoldFactor", "ManifoldPrior", "MsgRelativeLikelihood",
           "GaussianJoint", "MODEL_REGISTRY", "register_factor_model",
           "HeatmapGridDensity", "LevelSetGridNormal",
           "PartialPriorPassThrough", "FluxModelsDistribution",
           "MixtureFluxModels", "SequentialNet", "mlp_init", "mlp_apply",
           "nn_init", "DERelative", "rk4_integrate"]
