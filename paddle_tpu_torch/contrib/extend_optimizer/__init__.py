"""fluid.contrib.extend_optimizer (reference
python/paddle/fluid/contrib/extend_optimizer/__init__.py)."""

from .extend_optimizer_with_weight_decay import (  # noqa: F401
    DecoupledWeightDecay, extend_with_decoupled_weight_decay)

__all__ = ["DecoupledWeightDecay", "extend_with_decoupled_weight_decay"]
