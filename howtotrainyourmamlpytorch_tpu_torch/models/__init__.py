"""Backbone and MAML learner of the port."""

from .backbone import BackboneConfig, VGGBackbone, build_backbone
from .maml import MAMLConfig, MAMLFewShotLearner, MAMLInferenceState, TrainState

__all__ = [
    "BackboneConfig",
    "MAMLConfig",
    "MAMLFewShotLearner",
    "MAMLInferenceState",
    "TrainState",
    "VGGBackbone",
    "build_backbone",
]
