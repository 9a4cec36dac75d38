"""Carry a JAX package training state into the port."""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from ..weights import load_jax_adam_state, load_jax_variables
from .trainer import TrainState, init_train_state


def train_state_from_jax(model: nn.Module, jax_state, options, seed: int = 0,
                         device: str | torch.device = "cuda") -> TrainState:
    """A port `TrainState` from a JAX `TrainState`: params and batch_stats
    into `model`, the Adam moments and count into a fresh optimizer, the
    fits store and the step.  JAX's PRNG key has no torch counterpart: the
    dropout generator is seeded with `seed`."""
    load_jax_variables(model, {"params": jax_state.params, "batch_stats": jax_state.batch_stats})
    state = init_train_state(model, options, np.asarray(jax_state.fits), seed=seed, device=device)
    load_jax_adam_state(model, state.optimizer, jax_state.opt_state)
    state.step = int(np.asarray(jax_state.step))
    return state
