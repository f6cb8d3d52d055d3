"""Backbone and learners of the port."""

from .anil import ANILLearner
from .backbone import BackboneConfig, VGGBackbone, build_backbone
from .common import InferenceState
from .gradient_descent import GDInferenceState, GDState, GradientDescentLearner
from .maml import MAMLConfig, MAMLFewShotLearner, MAMLInferenceState, TrainState
from .matching_nets import MatchingNetsLearner, MatchingNetsState
from .protonets import ProtoNetsLearner, ProtoNetsState
from .resnet import ResNet12Backbone

__all__ = [
    "ANILLearner",
    "BackboneConfig",
    "GDInferenceState",
    "GDState",
    "GradientDescentLearner",
    "InferenceState",
    "MAMLConfig",
    "MAMLFewShotLearner",
    "MAMLInferenceState",
    "MatchingNetsLearner",
    "MatchingNetsState",
    "ProtoNetsLearner",
    "ProtoNetsState",
    "ResNet12Backbone",
    "TrainState",
    "VGGBackbone",
    "build_backbone",
]
