"""Factor models."""

from .factors import (MODEL_REGISTRY, EuclidDistance, FactorModel,
                      GenericMarginal, LinearRelative, MetaPrior, Mixture,
                      MsgPrior, Prior, PriorModel, register_factor_model)

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "EuclidDistance", "Mixture", "MsgPrior", "MetaPrior",
           "GenericMarginal", "MODEL_REGISTRY", "register_factor_model"]
