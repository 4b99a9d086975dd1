"""Training of the port: the single-device train step."""

from ray_tpu_torch.train.step import (
    AdamW,
    TrainState,
    chunked_cross_entropy,
    grad_step,
    init_train_state,
    jit_train_step,
    loss_fn,
    make_optimizer,
    make_train_step,
)

__all__ = [
    "AdamW",
    "TrainState",
    "chunked_cross_entropy",
    "grad_step",
    "init_train_state",
    "jit_train_step",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
]
