"""Backbone and MAML learner of the port."""

from .backbone import BackboneConfig, VGGBackbone, build_backbone
from .maml import MAMLConfig, MAMLFewShotLearner, MAMLInferenceState

__all__ = [
    "BackboneConfig",
    "MAMLConfig",
    "MAMLFewShotLearner",
    "MAMLInferenceState",
    "VGGBackbone",
    "build_backbone",
]
