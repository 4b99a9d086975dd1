"""Training library of the port: the train step, the token dataset,
checkpoints, the memory planner and, above them, the controller /
worker-group ``TorchTrainer`` with its per-worker session
(ray_tpu_torch.train.trainer, .session), as in the JAX package."""

from ray_tpu_torch.train.checkpoint import (
    CheckpointManager,
    checkpoint_dir_name,
    list_checkpoint_dirs,
    load_metadata,
    restore_checkpoint,
    save_checkpoint,
)
from ray_tpu_torch.exceptions import PreemptedError
from ray_tpu_torch.train import zero
from ray_tpu_torch.train.admission import AdmissionTicket, admit_gang
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
from ray_tpu_torch.train.session import (
    collective_group_name,
    get_checkpoint,
    get_context,
    get_dataset_shard,
    grad_bucketer,
    grad_sync_opts,
    partial_collective_opts,
    preemption_notice,
    report,
    slice_label,
    step_span,
    zero_optimizer,
)
from ray_tpu_torch.train.trainer import (
    ElasticScalingPolicy,
    FailureConfig,
    Result,
    RunConfig,
    ScalingConfig,
    ScalingPolicy,
    TorchTrainer,
)
from ray_tpu_torch.train.zero import ZeroOptimizer

__all__ = [
    "AdamW",
    "AdmissionTicket",
    "CheckpointManager",
    "ElasticScalingPolicy",
    "FailureConfig",
    "MemoryPlan",
    "PreemptedError",
    "Result",
    "RunConfig",
    "ScalingConfig",
    "ScalingPolicy",
    "TokenDataset",
    "TorchTrainer",
    "TrainState",
    "ZeroOptimizer",
    "admit_gang",
    "checkpoint_dir_name",
    "chunked_cross_entropy",
    "collective_group_name",
    "get_checkpoint",
    "get_context",
    "get_dataset_shard",
    "grad_bucketer",
    "grad_step",
    "grad_sync_opts",
    "init_train_state",
    "jit_train_step",
    "list_checkpoint_dirs",
    "load_metadata",
    "loss_fn",
    "make_optimizer",
    "make_train_step",
    "partial_collective_opts",
    "plan_memory",
    "preemption_notice",
    "report",
    "restore_checkpoint",
    "save_checkpoint",
    "slice_label",
    "step_span",
    "train_state_dict",
    "train_state_from_dict",
    "train_state_from_jax",
    "zero",
    "zero_optimizer",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu('train')
del _rlu
