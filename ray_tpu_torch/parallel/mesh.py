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
    pp    pipeline parallelism (layer stages; pipeline.py runs the GPipe
          microbatch schedule over this axis)
    ep    expert parallelism (MoE experts spread over ranks)
    tp    tensor parallelism (heads / mlp / vocab sharded)
    sp    sequence parallelism (ring attention, Ulysses)

Rank r sits at the mesh coordinate of r in row-major order over these
axes, as the reference reshapes its device list. :func:`make_multislice_mesh`
places ranks for several slices (groups of ranks that share a fast
interconnect, such as one node's NVLink domain) the way the reference's
hybrid mesh places devices: the DCN factor of each axis outer, its ICI
factor inner.
"""

from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
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


def _check_process_group(device_type: str) -> int:
    """The world size; raises without an initialised default process
    group, and for ``device_type="cuda"`` without a GPU."""
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
    return dist.get_world_size()


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

    n = _check_process_group(device_type)
    if axis_sizes is None:
        axis_sizes = {"dp": n}
    sizes = _resolve_sizes(axis_sizes, n)
    return init_device_mesh(
        device_type, tuple(sizes[a] for a in MESH_AXES),
        mesh_dim_names=MESH_AXES,
    )


class FakeSliceRank(int):
    """A rank with a fake ``slice_index``: lets one slice (one node, or
    ranks sharing one card) drive :func:`make_multislice_mesh`'s hybrid
    arrangement in tests and dry runs (the reference's
    ``_FakeSliceDevice``). It is the rank itself otherwise."""

    slice_index: int

    def __new__(cls, rank: int, slice_index: int):
        obj = super().__new__(cls, rank)
        obj.slice_index = slice_index
        return obj

    def __repr__(self):
        return f"FakeSlice({self.slice_index}, rank {int(self)})"


def fake_slice_devices(n_slices: int, ranks: Sequence[int] | None = None
                       ) -> list[FakeSliceRank]:
    """``ranks`` (every rank of the default process group by default) cut
    into ``n_slices`` contiguous fake slices."""
    if ranks is None:
        ranks = range(dist.get_world_size())
    ranks = list(ranks)
    if len(ranks) % n_slices:
        raise ValueError(
            f"{len(ranks)} devices do not split into {n_slices} slices"
        )
    per = len(ranks) // n_slices
    return [FakeSliceRank(r, i // per) for i, r in enumerate(ranks)]


def slice_index(rank: int) -> int:
    """The slice of ``rank``: its ``slice_index`` (a fake slice), else its
    node under torchrun (``rank // LOCAL_WORLD_SIZE``; ranks of one node
    share its NVLink domain), else 0 (one slice)."""
    if hasattr(rank, "slice_index"):
        return rank.slice_index
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    return int(rank) // local if local > 0 else 0


def hybrid_rank_array(ici: Sequence[int], dcn: Sequence[int],
                      ranks: Sequence[int]) -> np.ndarray:
    """The ranks laid out on a mesh of shape ici x dcn, axis by axis, as
    ``jax.experimental.mesh_utils.create_hybrid_device_mesh`` lays out
    devices: the ranks grouped by :func:`slice_index` (slices in sorted
    order, ranks in their given order), each slice reshaped to ``ici``,
    the slices placed on a ``dcn`` grid, and along every axis the DCN
    index outer and the ICI index inner (so each DCN row holds one
    slice's ranks)."""
    groups: dict[int, list[int]] = {}
    for r in ranks:
        groups.setdefault(slice_index(r), []).append(int(r))
    if int(np.prod(dcn)) != len(groups):
        raise ValueError(
            f"Number of slices {len(groups)} must equal the product of "
            f"dcn_mesh_shape {tuple(dcn)}"
        )
    per_slice = [np.asarray(groups[k]) for k in sorted(groups)]
    for g in per_slice:
        if g.size != int(np.prod(ici)):
            raise ValueError(f"a slice of {g.size} ranks does not fill the "
                             f"ici mesh {tuple(ici)}")
    blocks = np.stack([g.reshape(ici) for g in per_slice]).reshape(
        *dcn, *ici)
    nd = len(ici)
    # (dcn_0, ..., dcn_n, ici_0, ..., ici_n) -> (dcn_0, ici_0, dcn_1, ...)
    order = [i for a in range(nd) for i in (a, nd + a)]
    return blocks.transpose(order).reshape(
        [d * i for d, i in zip(dcn, ici)])


def make_multislice_mesh(
    ici_axis_sizes: Mapping[str, int],
    dcn_axis_sizes: Mapping[str, int],
    *,
    ranks: Sequence[int] | None = None,
    device_type: str = "cuda",
):
    """A mesh for several slices (port of the reference's
    ``make_multislice_mesh``): the ``dcn_axis_sizes`` axes span slices
    over the slower network between them (normally dp / fsdp), the
    ``ici_axis_sizes`` axes stay inside a slice (tp / sp / ep).

    A rank's slice is its node under torchrun (``LOCAL_WORLD_SIZE`` ranks
    per node), or the ``slice_index`` of :func:`fake_slice_devices`'
    ranks passed as ``ranks``. With one slice the DCN factors fold into
    the flat :func:`make_mesh` (the same shardings, another placement
    only). With several, the ranks are placed by
    :func:`hybrid_rank_array` in a ``DeviceMesh`` with
    ``mesh_dim_names=MESH_AXES``. Unknown axes and sizes below 1 (no -1
    wildcards) raise ``ValueError`` in either dict."""
    from torch.distributed.device_mesh import DeviceMesh

    for name, sizes in (("ici", ici_axis_sizes), ("dcn", dcn_axis_sizes)):
        unknown = set(sizes) - set(MESH_AXES)
        if unknown:
            raise ValueError(
                f"unknown {name} mesh axes {sorted(unknown)}; valid: "
                f"{MESH_AXES}"
            )
        if any(int(v) < 1 for v in sizes.values()):
            raise ValueError(
                f"{name}_axis_sizes must be explicit positive sizes "
                f"(no -1 wildcards): {dict(sizes)}"
            )
    n = _check_process_group(device_type)
    ranks = list(range(n)) if ranks is None else list(ranks)
    if len(ranks) != n:
        raise ValueError(f"{len(ranks)} ranks given for a world of {n}")
    combined = {
        a: int(ici_axis_sizes.get(a, 1)) * int(dcn_axis_sizes.get(a, 1))
        for a in set(ici_axis_sizes) | set(dcn_axis_sizes)
    }
    if len({slice_index(r) for r in ranks}) <= 1:
        return make_mesh(combined, device_type=device_type)
    dcn = [int(dcn_axis_sizes.get(a, 1)) for a in MESH_AXES]
    ici = _resolve_sizes({a: int(ici_axis_sizes.get(a, 1))
                          for a in MESH_AXES}, n // int(np.prod(dcn)))
    array = hybrid_rank_array([ici[a] for a in MESH_AXES], dcn, ranks)
    return DeviceMesh(device_type, torch.from_numpy(array),
                      mesh_dim_names=MESH_AXES)


def axis_size(mesh, axis: str) -> int:
    """Size of mesh axis ``axis`` (1 without a mesh)."""
    if mesh is None:
        return 1
    return mesh.size(MESH_AXES.index(axis))


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on mesh axis ``axis``."""
    return mesh.get_local_rank(axis)
