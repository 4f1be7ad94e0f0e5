"""Training substrate of the port: synthetic data pipeline, AdamW, train
step, checkpointing (the JAX package's ``train/`` in PyTorch)."""

from repro_torch.train.optimizer import AdamWConfig, adamw_init, adamw_update
from repro_torch.train.step import TrainConfig, loss_fn, make_train_step, train_state_init

__all__ = [
    "AdamWConfig",
    "adamw_init",
    "adamw_update",
    "TrainConfig",
    "loss_fn",
    "make_train_step",
    "train_state_init",
]
