"""Training substrate of the port: the synthetic data stream (a verbatim
copy of ``repro/training/data.py``), AdamW with the JAX package's schedule
and clip, int8 gradient compression, and the train step."""
from .data import DataConfig, SyntheticTokenStream
from .optimizer import (
    AdamWConfig,
    adamw_init,
    adamw_state_specs,
    adamw_update,
    compress_grads,
)
from .train_step import init_train_state, make_train_step, train_state_specs

__all__ = [
    "DataConfig", "SyntheticTokenStream",
    "AdamWConfig", "adamw_init", "adamw_update", "adamw_state_specs",
    "compress_grads", "init_train_state", "make_train_step",
    "train_state_specs",
]
