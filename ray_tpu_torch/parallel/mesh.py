"""Device meshes over ``torch.distributed`` ranks (port of
ray_tpu/parallel/mesh.py).

The reference is a single controller: one JAX program sees every device
and a ``Mesh`` names the parallelism axes. The port is multi-controller
SPMD: one process per device, started by the caller (``torchrun
--nproc-per-node N`` or ``torch.multiprocessing``), each holding its own
shard. :func:`make_mesh` lays the world's ranks out on the reference's
six axes as a ``torch.distributed`` ``DeviceMesh``; it needs a default
process group and never initialises one itself.

Canonical axis order (outer -> inner):

    dp    pure data parallelism (gradients summed, parameters replicated)
    fsdp  data parallelism with parameters and optimizer state sharded
          (ZeRO-3: a weight is gathered at use)
    pp    pipeline parallelism (not ported: must be 1)
    ep    expert parallelism (MoE experts spread over ranks)
    tp    tensor parallelism (heads / mlp / vocab sharded)
    sp    sequence parallelism (ring attention, Ulysses)

Rank r sits at the mesh coordinate of r in row-major order over these
axes, as the reference reshapes its device list.
"""

from __future__ import annotations

from typing import Mapping

import torch
import torch.distributed as dist

MESH_AXES = ("dp", "fsdp", "pp", "ep", "tp", "sp")


def default_axis_sizes(n_devices: int) -> dict[str, int]:
    """A factorization of ``n_devices`` for tests and dry runs: tp, sp,
    then fsdp get a factor of 2 when it divides, dp takes the rest."""
    sizes = {a: 1 for a in MESH_AXES}
    rem = int(n_devices)
    for axis in ("tp", "sp", "fsdp"):
        if rem % 2 == 0 and rem > 1:
            sizes[axis] = 2
            rem //= 2
    sizes["dp"] = rem
    return sizes


def _resolve_sizes(
    axis_sizes: Mapping[str, int], n_devices: int
) -> dict[str, int]:
    sizes = {a: int(axis_sizes.get(a, 1)) for a in MESH_AXES}
    unknown = set(axis_sizes) - set(MESH_AXES)
    if unknown:
        raise ValueError(
            f"unknown mesh axes {sorted(unknown)}; valid axes: {MESH_AXES}"
        )
    wildcards = [a for a, s in sizes.items() if s == -1]
    if len(wildcards) > 1:
        raise ValueError("at most one axis size may be -1")
    fixed = 1
    for a, s in sizes.items():
        if s != -1:
            if s < 1:
                raise ValueError(f"axis {a!r} has invalid size {s}")
            fixed *= s
    if wildcards:
        if n_devices % fixed != 0:
            raise ValueError(
                f"cannot fill axis {wildcards[0]!r}: {n_devices} devices not "
                f"divisible by {fixed}"
            )
        sizes[wildcards[0]] = n_devices // fixed
        fixed = n_devices
    if fixed != n_devices:
        raise ValueError(
            f"mesh axis sizes {sizes} multiply to {fixed}, but there are "
            f"{n_devices} devices"
        )
    return sizes


def make_mesh(
    axis_sizes: Mapping[str, int] | None = None,
    *,
    device_type: str = "cuda",
):
    """A ``DeviceMesh`` over every rank of the default process group, with
    ``mesh_dim_names=MESH_AXES`` (axes of size 1 included, so sharding
    rules never special-case a missing axis).

    ``axis_sizes`` maps axis name -> size; missing axes get size 1; one
    axis may be -1 to take the remaining ranks. With no ``axis_sizes`` all
    ranks land on ``dp``. Raises without an initialised process group, and
    for ``device_type="cuda"`` without a GPU."""
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialised default process group: call "
            "torch.distributed.init_process_group first (torchrun sets "
            "its address, world size and rank)"
        )
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: device_type 'cuda' requested but no CUDA GPU is "
            "available; pass device_type='cpu' for the plain path"
        )
    n = dist.get_world_size()
    if axis_sizes is None:
        axis_sizes = {"dp": n}
    sizes = _resolve_sizes(axis_sizes, n)
    if sizes["pp"] != 1:
        raise NotImplementedError(
            "make_mesh: pipeline parallelism (pp > 1) is not ported "
            "(ROADMAP.md, Queue 1)"
        )
    return init_device_mesh(
        device_type, tuple(sizes[a] for a in MESH_AXES),
        mesh_dim_names=MESH_AXES,
    )


def axis_size(mesh, axis: str) -> int:
    """Size of mesh axis ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(MESH_AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis``."""
    return mesh.get_local_rank(axis)
