from .checkpoint import (
    adam_state_from_jax_leaves, latest_checkpoint, load_checkpoint, load_pretrained, load_torch_checkpoint,
    resume_train_state, save_checkpoint, train_state_from_jax,
)
from .fits_dict import FitsStore, fits_get, fits_set
from .options import build_parser, parse_args
from .summary import ScalarWriter
from .trainer import Trainer, TrainState, init_train_state, make_optimizer, make_train_step, step_feed_keys

__all__ = [
    "FitsStore",
    "ScalarWriter",
    "TrainState",
    "Trainer",
    "adam_state_from_jax_leaves",
    "build_parser",
    "fits_get",
    "fits_set",
    "init_train_state",
    "latest_checkpoint",
    "load_checkpoint",
    "load_pretrained",
    "load_torch_checkpoint",
    "make_optimizer",
    "make_train_step",
    "parse_args",
    "resume_train_state",
    "save_checkpoint",
    "step_feed_keys",
    "train_state_from_jax",
]
