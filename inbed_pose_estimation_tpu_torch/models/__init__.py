from .attention import CrossAttention
from .backbone import Bottleneck, ResNet50Trunk
from .cascade import cascade_apply
from .decoder import Reconstruct, ResBlock
from .factory import ModelSpec, build_model, get_spec, model_names
from .fusion import FrozenGuidedFusion, FusionOutput, TwoStageFusion
from .hmr import HMRCore, HMROutput, MultiTrunkCore

__all__ = [
    "Bottleneck",
    "CrossAttention",
    "FrozenGuidedFusion",
    "FusionOutput",
    "HMRCore",
    "HMROutput",
    "ModelSpec",
    "MultiTrunkCore",
    "Reconstruct",
    "ResBlock",
    "ResNet50Trunk",
    "TwoStageFusion",
    "build_model",
    "cascade_apply",
    "get_spec",
    "model_names",
]
