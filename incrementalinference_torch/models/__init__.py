"""Factor models."""

from .factors import (MODEL_REGISTRY, CircularCircular, EuclidDistance,
                      FactorModel, GaussianJoint, GenericMarginal,
                      LinearRelative,
                      ManifoldFactor, ManifoldPrior, MetaPrior, Mixture,
                      MsgPrior, MsgRelativeLikelihood, PartialPrior, Prior,
                      PriorCircular, PriorModel, register_factor_model)

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "EuclidDistance", "PriorCircular", "CircularCircular", "Mixture",
           "PartialPrior", "MsgPrior", "MetaPrior", "GenericMarginal",
           "ManifoldFactor", "ManifoldPrior", "MsgRelativeLikelihood",
           "GaussianJoint", "MODEL_REGISTRY", "register_factor_model"]
