from .debug import SKELETON_14, Debugger
from .part_renderer import PartRenderer, vertex_part_labels
from .renderer import Renderer

__all__ = ["SKELETON_14", "Debugger", "PartRenderer", "Renderer", "vertex_part_labels"]
