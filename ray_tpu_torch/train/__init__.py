"""Training of the port on one device: the train step, the token
dataset, checkpoints and the memory planner."""

from ray_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checkpoint_dir_name,
    list_checkpoint_dirs,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from ray_tpu_torch.train.dataloader import TokenDataset
from ray_tpu_torch.train.memory import MemoryPlan
from ray_tpu_torch.train.memory import plan as plan_memory
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
    train_state_dict,
    train_state_from_dict,
    train_state_from_jax,
)

__all__ = [
    "AdamW",
    "CheckpointManager",
    "MemoryPlan",
    "TokenDataset",
    "TrainState",
    "checkpoint_dir_name",
    "chunked_cross_entropy",
    "grad_step",
    "init_train_state",
    "jit_train_step",
    "list_checkpoint_dirs",
    "load_metadata",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
    "plan_memory",
    "restore_checkpoint",
    "save_checkpoint",
    "train_state_dict",
    "train_state_from_dict",
    "train_state_from_jax",
]
