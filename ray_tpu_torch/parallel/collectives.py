"""Autograd-aware collectives over the axes of a mesh (the explicit SPMD
side of the port's parallel layer).

The reference writes the model once and lets XLA's SPMD partitioner place
the collectives (``with_sharding_constraint``, ``shard_map``). The port
runs one process per device on local shards, so the model states its
collectives itself, Megatron-style. Each function here takes the mesh
(``DeviceMesh`` with the ``MESH_AXES`` names, or None) and one axis name
or a tuple of them (outer first); axes of size 1 are skipped, so a call
without a mesh or over axes of size 1 is the identity and issues no
collective.

==================  ========================  ==========================
function            forward                   backward
==================  ========================  ==========================
:func:`copy_to`     identity                  all-reduce (sum)
:func:`reduce_from` all-reduce (sum or mean)  identity (times 1/n: mean)
:func:`gather_from` all-gather along ``dim``  this rank's slice
:func:`scatter_to`  this rank's slice         all-gather along ``dim``
:func:`all_gather`  all-gather along ``dim``  reduce-scatter (sum)
:func:`all_to_all`  all-to-all                all-to-all back
:func:`ring_shift`  rank i's tensor to i + 1  gradient to i - 1
:func:`all_max`     all-reduce (max)          none (not differentiable)
==================  ========================  ==========================

A tensor that every rank of an axis holds whole is either *replicated*
(its gradient is the full gradient on every rank) or *partial* (the sum
over the axis of its per-rank gradients is the full one); the pairs above
move a value between the two, so every parameter's gradient reaches the
placements of its shard (sharding.py).

They run ``torch.distributed``'s process-group collectives on the mesh's
per-axis groups, on whatever backend the process group was started with
(NCCL across GPUs; gloo on the CPU). gloo's collectives take CUDA tensors
(copying them through host memory themselves), but its point-to-point
sends do not: on the H100 machine a gloo send of a CUDA tensor aborts the
process with ``gloo::IoException ... writev ... Bad address``
(``sharded_chip.py gloo``). So :func:`ring_shift` copies a CUDA tensor to the
host on a gloo group, sends it there, and copies the result back. Two
ranks sharing one card over gloo is a correctness check, never a fast
path.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ray_tpu_torch.parallel.mesh import MESH_AXES, axis_index, axis_size


def _axes(mesh, axes) -> tuple[str, ...]:
    """The axes of ``axes`` (a name or a tuple, outer first) with size > 1."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    for a in axes:
        if a not in MESH_AXES:
            raise ValueError(f"unknown mesh axis {a!r}")
    return tuple(a for a in axes if axis_size(mesh, a) > 1)


def group_size(mesh, axes) -> int:
    """Number of ranks over ``axes``."""
    n = 1
    for a in _axes(mesh, axes):
        n *= axis_size(mesh, a)
    return n


def group_index(mesh, axes) -> int:
    """This rank's row-major index over ``axes`` (outer first)."""
    i = 0
    for a in _axes(mesh, axes):
        i = i * axis_size(mesh, a) + axis_index(mesh, a)
    return i


def local_chunk(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` along ``dim`` over ``axes`` (equal
    slices, outer axis major; raises when they do not divide)."""
    n = group_size(mesh, axes)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"into {n} equal shards over {axes}")
    step = x.shape[dim] // n
    return x.narrow(dim, group_index(mesh, axes) * step, step)


# reduce_scatter_single is the name from torch 2.12 on.
_reduce_scatter_op = getattr(dist, "reduce_scatter_single",
                             dist.reduce_scatter_tensor)


def _all_reduce(x, mesh, axes):
    y = x.contiguous().clone()
    for a in axes:
        dist.all_reduce(y, group=mesh.get_group(a))
    return y


def _all_gather(x, mesh, axes, dim):
    # Inner axis first: the result is ordered outer-major.
    for a in reversed(axes):
        n = axis_size(mesh, a)
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0], *src.shape[1:]))
        dist.all_gather_into_tensor(out, src, group=mesh.get_group(a))
        x = out.movedim(0, dim)
    return x.contiguous()


def _reduce_scatter(x, mesh, axes, dim):
    # Outer axis first: the inverse of _all_gather's order.
    for a in axes:
        n = axis_size(mesh, a)
        src = x.movedim(dim, 0).contiguous()
        if src.shape[0] % n:
            raise ValueError(f"dim {dim} of size {src.shape[0]} does not "
                             f"split into {n} shards over {a!r}")
        out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
        _reduce_scatter_op(out, src, group=mesh.get_group(a))
        x = out.movedim(0, dim)
    return x.contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.mesh, ctx.axes), None, None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, scale):
        ctx.scale = scale
        y = _all_reduce(x, mesh, axes)
        return y if scale == 1.0 else y * scale

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.scale == 1.0 else g * ctx.scale), None, None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (local_chunk(g, ctx.mesh, ctx.axes, ctx.dim).contiguous(),
                None, None, None)


class _ScatterTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return local_chunk(x, mesh, axes, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return _all_gather(x, mesh, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.mesh, ctx.axes, ctx.dim), None, None, None


def copy_to(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """Identity forward; the gradient is summed over ``axes``: a value
    replicated over ``axes`` enters per-rank work whose gradients are
    partial."""
    axes = _axes(mesh, axes)
    return _CopyTo.apply(x, mesh, axes) if axes else x


def reduce_from(x: torch.Tensor, mesh, axes, mean: bool = False
                ) -> torch.Tensor:
    """Sum (or mean) over ``axes``; the gradient passes through (times
    1/n for the mean): per-rank partial values become one replicated
    value whose gradient each rank applies to its own part."""
    axes = _axes(mesh, axes)
    if not axes:
        return x
    scale = 1.0 / group_size(mesh, axes) if mean else 1.0
    return _ReduceFrom.apply(x, mesh, axes, scale)


def gather_from(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` (outer axis major);
    the gradient of the whole is replicated, so each rank keeps its own
    slice of it."""
    axes = _axes(mesh, axes)
    return _GatherFrom.apply(x, mesh, axes, dim) if axes else x


def scatter_to(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """This rank's slice of ``x`` (the same on every rank of ``axes``)
    along ``dim``; the gradients of the slices are gathered back, so the
    gradient of the whole is replicated (the adjoint of
    :func:`gather_from`)."""
    axes = _axes(mesh, axes)
    return _ScatterTo.apply(x, mesh, axes, dim) if axes else x


def all_max(x: torch.Tensor, mesh, axes) -> torch.Tensor:
    """The elementwise max of ``x`` over ``axes`` (``jax.lax.pmax``),
    detached: it carries no gradient."""
    axes = _axes(mesh, axes)
    y = x.detach().contiguous().clone()
    for a in axes:
        dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.get_group(a))
    return y


def all_gather(x: torch.Tensor, mesh, axes, dim: int) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim``; the gradient of the
    whole is partial, so it is summed and scattered back (a shard
    gathered for use: ZeRO-3)."""
    axes = _axes(mesh, axes)
    return _AllGather.apply(x, mesh, axes, dim) if axes else x


class _AllToAll(torch.autograd.Function):
    """[n, ...] chunks: chunk j goes to rank j of the group; the result
    holds rank j's chunk at j. Its own adjoint."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _a2a(x, group)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group), None


def _a2a(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


def all_to_all(x: torch.Tensor, mesh, axis: str, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    ``x`` is cut into n equal pieces along ``split_dim``, piece j goes to
    rank j of ``axis``, and the pieces received are concatenated along
    ``concat_dim`` in rank order. Differentiable."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of size "
                         f"{x.shape[split_dim]} does not split over {n}")
    shape = list(x.shape)
    pieces = x.unflatten(split_dim, (n, shape[split_dim] // n))
    sent = pieces.movedim(split_dim, 0)  # [n, ...]
    got = _AllToAll.apply(sent, mesh.get_group(axis))  # [n(src), ...]
    got = got.movedim(0, concat_dim)
    return got.flatten(concat_dim, concat_dim + 1)


def _shift(x, group, step):
    n = dist.get_world_size(group)
    me = dist.get_rank(group)
    staged = x.device.type != "cpu" and dist.get_backend(group) == "gloo"
    src = x.cpu() if staged else x.contiguous()
    out = torch.empty_like(src)
    ops = [dist.P2POp(dist.isend, src,
                      dist.get_global_rank(group, (me + step) % n), group),
           dist.P2POp(dist.irecv, out,
                      dist.get_global_rank(group, (me - step) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out.to(x.device) if staged else out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.ppermute`` around the ring of ``axis``: rank i's ``x``
    arrives at rank i + 1 (mod n); the gradient travels back."""
    if axis_size(mesh, axis) == 1:
        return x
    return _RingShift.apply(x, mesh.get_group(axis))
