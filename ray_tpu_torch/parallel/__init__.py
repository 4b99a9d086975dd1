"""Parallel layer of the port: device meshes, logical-axis sharding,
the collectives the sharded model states, and sequence parallelism (ring
attention, Ulysses). Pipeline parallelism is not ported (ROADMAP.md)."""

from ray_tpu_torch.parallel.mesh import (
    MESH_AXES,
    default_axis_sizes,
    make_mesh,
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
    "DEFAULT_RULES",
    "MESH_AXES",
    "default_axis_sizes",
    "logical_sharding",
    "logical_spec",
    "make_mesh",
    "shard_pytree",
    "tree_shardings",
    "use_mesh",
]
