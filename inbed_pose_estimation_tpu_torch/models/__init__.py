from .backbone import Bottleneck, ResNet50Trunk
from .cascade import cascade_apply
from .decoder import Reconstruct, ResBlock
from .factory import ModelSpec, build_model, get_spec, model_names
from .hmr import HMRCore, HMROutput

__all__ = [
    "Bottleneck",
    "HMRCore",
    "HMROutput",
    "ModelSpec",
    "Reconstruct",
    "ResBlock",
    "ResNet50Trunk",
    "build_model",
    "cascade_apply",
    "get_spec",
    "model_names",
]
