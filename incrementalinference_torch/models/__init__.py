"""Factor models."""

from .factors import (MODEL_REGISTRY, FactorModel, GenericMarginal,
                      LinearRelative, MetaPrior, MsgPrior, Prior, PriorModel,
                      register_factor_model)

__all__ = ["FactorModel", "PriorModel", "Prior", "LinearRelative",
           "MsgPrior", "MetaPrior", "GenericMarginal", "MODEL_REGISTRY",
           "register_factor_model"]
