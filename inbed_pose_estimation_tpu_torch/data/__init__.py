from .dataset import BaseDataset, MixedDataset
from .loader import CheckpointDataLoader, collate

__all__ = ["BaseDataset", "CheckpointDataLoader", "MixedDataset", "collate"]
