from .checkpoint import load_checkpoint, load_torch_checkpoint, train_state_from_jax
from .fits_dict import FitsStore, fits_get, fits_set
from .options import build_parser
from .trainer import TrainState, init_train_state, make_optimizer, make_train_step, step_feed_keys

__all__ = [
    "FitsStore",
    "TrainState",
    "build_parser",
    "fits_get",
    "fits_set",
    "init_train_state",
    "load_checkpoint",
    "load_torch_checkpoint",
    "make_optimizer",
    "make_train_step",
    "step_feed_keys",
    "train_state_from_jax",
]
