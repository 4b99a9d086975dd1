"""Experimental APIs (reference: python/ray/experimental/ — the
declarative collective-group API on actor handles and the GPU-object /
tensor-transport manager, here TPU-objects)."""

from ray_tpu_torch.experimental.collective import (
    create_collective_group,
    destroy_collective_group,
)
from ray_tpu_torch.experimental.tensor_transport import (
    free_tensors,
    tensor_meta,
)

__all__ = [
    "create_collective_group",
    "destroy_collective_group",
    "free_tensors",
    "tensor_meta",
]
