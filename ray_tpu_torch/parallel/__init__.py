"""Parallel layer of the port: device meshes (flat and multislice),
logical-axis sharding, the collectives the sharded model states, sequence
parallelism (ring attention, Ulysses) and pipeline parallelism (the GPipe
schedule over pp; showcase.py composes it with ep and fsdp)."""

from ray_tpu_torch.parallel.mesh import (
    MESH_AXES,
    default_axis_sizes,
    fake_slice_devices,
    make_mesh,
    make_multislice_mesh,
)
from ray_tpu_torch.parallel.pipeline import (
    mesh_spec,
    pipeline_apply,
    pipeline_loss_fn,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    logical_sharding,
    logical_spec,
    shard_pytree,
    tree_shardings,
    use_mesh,
)

__all__ = [
    "pipeline_apply",
    "pipeline_loss_fn",
    "mesh_spec",
    "MESH_AXES",
    "default_axis_sizes",
    "fake_slice_devices",
    "make_mesh",
    "make_multislice_mesh",
    "DEFAULT_RULES",
    "logical_spec",
    "logical_sharding",
    "tree_shardings",
    "shard_pytree",
    "use_mesh",
]
