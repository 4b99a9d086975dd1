"""Pipeline parallelism: the GPipe microbatch schedule over the ``pp`` mesh
axis (port of ray_tpu/parallel/pipeline.py).

Each rank along ``pp`` holds one stage's parameters and runs the same
lockstep schedule as the reference's ``lax.scan``: M + P - 1 steps; at
step t stage 0 takes microbatch t (clamped), every other stage takes what
the stage before it sent at step t - 1, and the last stage completes
microbatch t - (P - 1). The activations move one stage forward by
:func:`~ray_tpu_torch.parallel.collectives.ring_shift` (the reference's
``ppermute``), and ``torch.autograd`` through the schedule gives the
backward, as ``jax.grad`` does there: each shift's gradient travels one
stage back.

Every rank builds the same autograd graph: which input a stage takes and
whether it keeps its output are chosen by ``torch.where`` on its stage
index, as the reference's ``jnp.where``, never by a Python branch, so the
backward's collectives (the shifts and whatever ``stage_fn`` states) run
in the same order on every rank.

Bubble fraction is GPipe's (P - 1) / (M + P - 1): pick M >= 4 P.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard
from torch.utils._pytree import tree_leaves, tree_map

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import MESH_AXES, axis_index, axis_size

StageFn = Callable[[Any, torch.Tensor], torch.Tensor]

DATA = ("dp", "fsdp")


def mesh_spec(*dims) -> tuple[Placement, ...]:
    """The reference's ``PartitionSpec(*dims)`` (per tensor dim a mesh
    axis, a tuple of them outer first, or None) as one placement per mesh
    axis, ``MESH_AXES`` order."""
    placements: list[Placement] = [Replicate()] * len(MESH_AXES)
    for dim, axes in enumerate(dims):
        if axes is None:
            continue
        for a in (axes,) if isinstance(axes, str) else axes:
            placements[MESH_AXES.index(a)] = Shard(dim)
    return tuple(placements)


def _is_spec(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(p, Placement) for p in x)


def _stage_shard(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's shard of a stage parameter, placed by ``spec``, as the
    tensor ``stage_fn`` computes with ([1, ...] squeezed).

    A DTensor gives its local shard (redistributed to ``spec`` first if
    placed otherwise): its gradient comes back as a DTensor with those
    placements. A plain tensor is the whole parameter, the same on every
    rank: each rank takes its slice (:func:`col.scatter_to`), so the
    whole tensor's gradient is gathered back to every rank. Over the data
    axes on which ``spec`` replicates the parameter, the ranks' gradients
    (from their own data) are summed, as JAX sums the cotangent of a
    ``shard_map`` input over the axes it is not split on."""
    if isinstance(t, DTensor):
        if tuple(t.placements) != tuple(spec):
            t = t.redistribute(mesh, spec)
        x = t.to_local()
    else:
        x = t
        for a, p in zip(MESH_AXES, spec):
            if isinstance(p, Shard):
                x = col.scatter_to(x, mesh, a, p.dim)
    for a, p in zip(MESH_AXES, spec):
        if a in DATA and not isinstance(p, Shard):
            x = col.copy_to(x, mesh, a)
    return x[0]


def pipeline_apply(
    stage_params: Any,
    x: torch.Tensor,
    stage_fn: StageFn,
    *,
    mesh,
    num_microbatches: int,
    axis: str = "pp",
    param_specs: Any = None,
) -> torch.Tensor:
    """Run ``x`` [batch, ...] (the whole batch, the same on every rank)
    through P chained stages, microbatched and pipelined; returns the last
    stage's outputs for the whole batch on every rank.

    ``stage_params`` leaves have a leading stage dim P (placed over
    ``axis``): DTensors, or whole tensors the same on every rank. Every
    stage must map [mb, ...] to [mb, ...] of the same shape.

    ``param_specs`` (a tree of placement tuples, :func:`mesh_spec`, whose
    leading dim is over ``axis``; default: only that) splits stage
    parameters over further mesh axes, e.g. ``mesh_spec("pp", "ep")`` for
    expert-stacked weights or ``mesh_spec("pp", None, "fsdp")`` for
    ZeRO-3 stage weights; ``stage_fn`` then uses those axes itself
    (parallel/collectives.py: ``all_gather`` over fsdp, ``reduce_from``
    over ep).

    The batch is cut over the data axes (dp, fsdp) of size > 1; each
    data shard runs its own schedule on its slice. The input enters
    replicated over ``axis`` (:func:`col.copy_to`: only stage 0 reads it,
    so its gradient is summed over the stages), and the outputs leave it
    summed over ``axis`` from the last stage (:func:`col.reduce_from`,
    whose gradient passes as is to every stage: each computes the
    replicated loss head itself)."""
    n_stages = axis_size(mesh, axis)
    for leaf in tree_leaves(stage_params):
        if leaf.shape[0] != n_stages:
            raise ValueError(
                f"stage dim {leaf.shape[0]} != mesh {axis}={n_stages}; a "
                "mismatch would silently drop stages"
            )
    pp = MESH_AXES.index(axis)
    if param_specs is None:
        param_specs = tree_map(lambda _: mesh_spec(axis), stage_params)
    else:
        for spec in tree_leaves(param_specs, is_leaf=_is_spec):
            if spec[pp] != Shard(0):
                raise ValueError(
                    f"param_specs leaf {spec} must shard its LEADING "
                    f"dim over {axis!r}; otherwise every device would "
                    "silently run stage 0's weights"
                )
    data = tuple(a for a in DATA if axis_size(mesh, a) > 1)
    dp_total = col.group_size(mesh, data)
    batch = x.shape[0]
    m = num_microbatches
    if batch % (m * dp_total):
        raise ValueError(
            f"batch {batch} not divisible by microbatches "
            f"{m} x data shards {dp_total}"
        )
    mb = batch // dp_total // m

    params = tree_map(lambda t, s: _stage_shard(t, s, mesh), stage_params,
                      param_specs)
    x = col.copy_to(col.scatter_to(x, mesh, data, 0), mesh, axis)
    micro = x.reshape(m, mb, *x.shape[1:])
    stage = axis_index(mesh, axis) if n_stages > 1 else 0
    first = torch.tensor(stage == 0, device=x.device)
    last = torch.tensor(stage == n_stages - 1, device=x.device)

    n_steps = m + n_stages - 1
    recv = torch.zeros_like(micro[0])
    outputs = []
    for t in range(n_steps):
        y = stage_fn(params, torch.where(first, micro[min(t, m - 1)], recv))
        if t >= n_stages - 1:  # the last stage completes t - (P - 1)
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
        if t != n_steps - 1:  # the reference's last shift is never read
            recv = col.ring_shift(y, mesh, axis)
    out = col.reduce_from(torch.cat(outputs), mesh, axis)
    return col.gather_from(out, mesh, data, 0)


def pipeline_loss_fn(
    stage_params: Any,
    batch: dict,
    stage_fn: StageFn,
    loss_head: Callable[[torch.Tensor, dict], torch.Tensor],
    *,
    mesh,
    num_microbatches: int,
    param_specs: Any = None,
) -> torch.Tensor:
    """Differentiable pipelined loss: ``batch["inputs"]`` through the
    stages, then the replicated ``loss_head(outputs, batch)`` (a scalar,
    the same on every rank)."""
    y = pipeline_apply(
        stage_params,
        batch["inputs"],
        stage_fn,
        mesh=mesh,
        num_microbatches=num_microbatches,
        param_specs=param_specs,
    )
    return loss_head(y, batch)
