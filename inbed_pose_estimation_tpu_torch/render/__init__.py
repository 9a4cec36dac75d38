from .part_renderer import PartRenderer, vertex_part_labels

__all__ = ["PartRenderer", "vertex_part_labels"]
