from .dataset import BaseDataset
from .loader import CheckpointDataLoader, collate

__all__ = ["BaseDataset", "CheckpointDataLoader", "collate"]
