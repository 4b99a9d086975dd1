"""Logical-axis sharding rules for the canonical mesh (port of
ray_tpu/parallel/sharding.py).

Every tensor carries a tuple of *logical* axis names; the rules map each
to zero or more mesh axes. Where the reference turns them into
``PartitionSpec``s for XLA, the port turns them into DTensor placements,
one per mesh axis (``MESH_AXES`` order): ``Shard(i)`` on each mesh axis
that tensor dim ``i`` maps to, ``Replicate()`` elsewhere. A dim mapped to
a tuple of mesh axes (``batch -> ("dp", "fsdp")``) is sharded over all of
them, the first outermost, as the reference's spec does.

Parameters and optimizer state are DTensors with these placements. The
model computes on local tensors (``to_local``) and states its collectives
(collectives.py): :func:`gather_param` turns a parameter's shard into the
tensor a rank multiplies with, gathering what the rank does not hold
(ZeRO-3: a weight sharded over fsdp is all-gathered at use and its
gradient reduce-scattered back) and summing the gradient over the data
axes, so each gradient arrives with its parameter's own placements.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Any, Sequence

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard

from ray_tpu_torch.parallel import collectives as col
from ray_tpu_torch.parallel.mesh import MESH_AXES, axis_size

# (logical axis, mesh axis or tuple of mesh axes or None)
#
# Activation axes:
#   batch      -> sharded over both data axes (dp outer, fsdp inner)
#   act_seq    -> sequence parallelism
#   act_embed  -> replicated (activations keep the full model dim)
#   act_heads  -> tensor parallelism over attention heads
#   act_mlp    -> tensor parallelism over the ffn hidden dim
# Parameter axes:
#   embed      -> fsdp-sharded (ZeRO-3: each data shard owns a slice)
#   heads      -> tp-sharded fused (n_heads * head_dim) dim
#   kv_heads   -> tp-sharded fused kv dim
#   mlp        -> tp-sharded ffn hidden dim
#   vocab      -> tp-sharded vocabulary dim
#   layers     -> stacked-layer leading dim, never sharded
#   expert     -> expert parallelism
DEFAULT_RULES: tuple[tuple[str, Any], ...] = (
    ("batch", ("dp", "fsdp")),
    ("act_seq", "sp"),
    ("act_embed", None),
    ("act_heads", "tp"),
    ("act_mlp", "tp"),
    ("embed", "fsdp"),
    ("heads", "tp"),
    ("kv_heads", "tp"),
    ("mlp", "tp"),
    ("vocab", "tp"),
    ("layers", None),
    ("stage", "pp"),
    ("expert", "ep"),
    (None, None),
)

# Axes whose ranks hold different data: a parameter's gradient is summed
# over them.
DATA_AXES = ("dp", "fsdp", "sp")


def logical_spec(
    logical_axes: Sequence[str | None],
    rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES,
) -> tuple[Placement, ...]:
    """One placement per mesh axis (``MESH_AXES`` order) for a tensor with
    ``logical_axes``: ``Shard(i)`` where tensor dim i maps to that mesh
    axis, ``Replicate()`` elsewhere."""
    table = dict(rules)
    placements: list[Placement] = [Replicate()] * len(MESH_AXES)
    for dim, ax in enumerate(logical_axes):
        if ax not in table:
            raise ValueError(f"no sharding rule for logical axis {ax!r}")
        mesh_axes = table[ax]
        if mesh_axes is None:
            continue
        for m in (mesh_axes,) if isinstance(mesh_axes, str) else mesh_axes:
            i = MESH_AXES.index(m)
            if placements[i] != Replicate():
                raise ValueError(f"mesh axis {m!r} shards two dims of "
                                 f"{tuple(logical_axes)}")
            placements[i] = Shard(dim)
    return tuple(placements)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and the placements of one tensor on it (the reference's
    ``NamedSharding``)."""

    mesh: Any
    placements: tuple[Placement, ...]


def logical_sharding(
    mesh,
    logical_axes: Sequence[str | None],
    rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES,
) -> NamedSharding:
    return NamedSharding(mesh, logical_spec(logical_axes, rules))


def is_axes_leaf(x: Any) -> bool:
    """True for a tuple of logical axis names (not a NamedTuple container)."""
    return (
        isinstance(x, tuple)
        and not hasattr(x, "_fields")
        and all(e is None or isinstance(e, str) for e in x)
    )


def tree_map_axes(fn, logical_tree: Any, *trees: Any) -> Any:
    """``fn(axes, *leaves)`` over a tree of logical-axis tuples and trees of
    the same structure: dicts, NamedTuples, dataclasses and lists are
    traversed; a tuple of axis names is a leaf."""
    if is_axes_leaf(logical_tree):
        return fn(logical_tree, *trees)
    if isinstance(logical_tree, dict):
        return {k: tree_map_axes(fn, v, *(t[k] for t in trees))
                for k, v in logical_tree.items()}
    if hasattr(logical_tree, "_fields"):
        return type(logical_tree)(*(
            tree_map_axes(fn, getattr(logical_tree, f),
                          *(getattr(t, f) for t in trees))
            for f in logical_tree._fields))
    if dataclasses.is_dataclass(logical_tree):
        return type(logical_tree)(**{
            f.name: tree_map_axes(fn, getattr(logical_tree, f.name),
                                  *(getattr(t, f.name) for t in trees))
            for f in dataclasses.fields(logical_tree)})
    if isinstance(logical_tree, list):
        return [tree_map_axes(fn, v, *(t[i] for t in trees))
                for i, v in enumerate(logical_tree)]
    raise TypeError(f"not a tree of logical axes: {logical_tree!r}")


def tree_shardings(
    mesh,
    logical_tree: Any,
    rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES,
) -> Any:
    """A tree of logical-axis tuples as a tree of :class:`NamedSharding`."""
    return tree_map_axes(lambda axes: logical_sharding(mesh, axes, rules),
                         logical_tree)


def distribute(x: torch.Tensor, mesh,
               placements: Sequence[Placement]) -> DTensor:
    """``x``, the whole tensor (the same on every rank), as a DTensor with
    ``placements``: each rank keeps its own slice, copied; no collective
    runs. Shards must be equal."""
    local = x
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local = col.local_chunk(local, mesh, MESH_AXES[i], p.dim)
    return DTensor.from_local(local.contiguous().clone(), mesh,
                              tuple(placements), run_check=False)


def shard_pytree(
    tree: Any,
    mesh,
    logical_tree: Any,
    rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES,
) -> Any:
    """Each tensor of ``tree`` (whole, the same on every rank) as a DTensor
    placed by its logical axes; a tensor that requires grad gives a leaf
    that does too. Non-tensor leaves (a step count) stay as they are."""

    def place(axes, x):
        if not isinstance(x, torch.Tensor):
            return x
        return distribute(x.detach(), mesh, logical_spec(axes, rules)
                          ).requires_grad_(x.requires_grad)

    return tree_map_axes(place, logical_tree, tree)


_ACTIVE = threading.local()


@contextlib.contextmanager
def use_mesh(
    mesh, rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES
):
    """Make (mesh, rules) ambient for the model code: :func:`constrain`,
    :func:`active_mesh` and the collectives the model states. Outside a
    ``use_mesh`` scope the same model runs unsharded."""
    with mesh_scope((mesh, tuple(rules))):
        yield


def active_mesh():
    """The mesh of the enclosing :func:`use_mesh`, or None (also for a
    mesh of one rank, which runs the plain single-device code)."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None or ctx[0].size() == 1:
        return None
    return ctx[0]


def current_scope():
    """The ambient (mesh, rules), or None: what :func:`mesh_scope` takes."""
    return getattr(_ACTIVE, "ctx", None)


@contextlib.contextmanager
def mesh_scope(scope):
    """Run under the (mesh, rules) ``scope`` that :func:`current_scope`
    returned. Autograd replays a checkpointed region on its own device
    thread, which does not see the caller's :func:`use_mesh`; a region
    that reads the mesh takes its scope as an argument and enters it."""
    prev = getattr(_ACTIVE, "ctx", None)
    _ACTIVE.ctx = scope
    try:
        yield
    finally:
        _ACTIVE.ctx = prev


def constrain(x, *logical_axes: str | None):
    """The reference's ``with_sharding_constraint`` by logical axes: under
    :func:`use_mesh` a DTensor is redistributed to the rule's placements.
    Outside a mesh, or on a plain tensor (the model's local shards, whose
    layout the SPMD code fixes), it is the identity."""
    ctx = getattr(_ACTIVE, "ctx", None)
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return x.redistribute(mesh, logical_spec(logical_axes, rules))


def gather_param(x: torch.Tensor, logical_axes: Sequence[str | None],
                 mesh, whole: Sequence[str] = (),
                 rules: Sequence[tuple[str | None, Any]] = DEFAULT_RULES
                 ) -> torch.Tensor:
    """The tensor a rank computes with, from its local shard ``x`` of a
    parameter with ``logical_axes``.

    - Over the data axes (dp, fsdp, sp) a sharded dim is all-gathered and
      its gradient reduce-scattered back; a replicated one passes as is
      and its gradient is summed. The parameter's gradient is then the
      sum over every rank's data.
    - Over tp and ep a sharded dim stays sharded (each rank computes with
      its slice), except on the axes named in ``whole``, where it is
      all-gathered and its gradient, partial, reduce-scattered back.
    """
    pl = logical_spec(logical_axes, rules)
    for i in reversed(range(len(MESH_AXES))):
        a = MESH_AXES[i]
        if axis_size(mesh, a) == 1:
            continue
        sharded = isinstance(pl[i], Shard)
        if a in DATA_AXES:
            x = (col.all_gather(x, mesh, a, pl[i].dim) if sharded
                 else col.copy_to(x, mesh, a))
        elif sharded and a in whole:
            x = col.all_gather(x, mesh, a, pl[i].dim)
    return x


def local(x):
    """A DTensor's local shard (autograd-aware: its gradient comes back as
    a DTensor with the same placements); a plain tensor as it is."""
    return x.to_local() if isinstance(x, DTensor) else x


def per_shard(kernel, mesh, batch_axes=("dp", "fsdp"), seq_axis=None,
              head_axis="tp"):
    """``kernel`` (q, k, v -> o on this rank's shards) as an attention
    function over ``mesh``: the reference's ``shard_map`` with spec
    ``P(batch_axes, seq_axis, head_axis, None)``. DTensor inputs are
    redistributed to that spec and the output is a DTensor with it; plain
    tensors are this rank's shards already (what the model hands it
    under :func:`use_mesh`)."""
    placements = [Replicate()] * len(MESH_AXES)
    for a in batch_axes:
        placements[MESH_AXES.index(a)] = Shard(0)
    if seq_axis is not None:
        placements[MESH_AXES.index(seq_axis)] = Shard(1)
    placements[MESH_AXES.index(head_axis)] = Shard(2)
    placements = tuple(placements)

    def attn(q, k, v):
        if not isinstance(q, DTensor):
            return kernel(q, k, v)
        q, k, v = (t.redistribute(mesh, placements).to_local()
                   for t in (q, k, v))
        return DTensor.from_local(kernel(q, k, v), mesh, placements,
                                  run_check=False)

    return attn


def sequence_gathered(kernel, mesh):
    """``kernel`` (q, k, v -> o over whole sequences) as an attention
    function over this rank's sequence block along sp: q, k and v
    [B, S / sp, H, D] are gathered along the sequence (``all_gather``: the
    gradient each rank computes of the whole comes only from its own
    output rows, so it is summed over the ranks and scattered back), the
    kernel runs on the whole sequence on every rank, and each rank keeps
    its own rows of the output. The reference's ``shard_map`` spec
    ``P(batch, None, tp, None)`` does the same for its flash kernel, and
    its partitioner for the dense attention, when the activations are
    split over sp."""

    def attn(q, k, v):
        q, k, v = (col.all_gather(t, mesh, "sp", 1) for t in (q, k, v))
        return col.local_chunk(kernel(q, k, v), mesh, "sp", 1)

    attn.seq_sharded = True
    attn.keeps_residuals = getattr(kernel, "keeps_residuals", False)
    return attn
