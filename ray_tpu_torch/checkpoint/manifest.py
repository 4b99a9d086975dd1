"""Checkpoint manifests: the leaf → chunk mapping and its assembly.

A checkpoint is a set of per-rank manifests committed to the head. Each
manifest entry describes one pytree leaf this rank owns: global shape,
dtype, and the shard windows it persisted (index ranges into the global
array plus the content hashes of the chunks holding that window's
bytes). The manifest is the ONLY record that a checkpoint exists —
chunks without a committed manifest are invisible garbage, which is what
makes a save that dies mid-write harmless (the previous manifest still
resolves, the orphan chunks get collected).

Ownership is ZeRO-flavored (arXiv:2004.13336): optimizer/parameter state
that is replicated across data-parallel workers is partitioned leaf-wise
round-robin by rank so each worker persists a disjoint 1/world of the
bytes with no gather; a leaf that is genuinely sharded across processes
(a DTensor on a mesh of several ranks) is instead persisted by every
rank as its local shard's window (coordinate 0 of each replicated mesh
dimension only), which is the same no-gather property at sub-leaf
granularity.

Leaves are torch tensors (or numbers and numpy arrays, taken as
tensors). Keys are the JAX package's key strings (``['params']['wq']``
for a dict, ``[0]`` for a list or tuple, ``.step`` for a NamedTuple or
dataclass field), and a leaf's bytes are its elements as stored, bf16
included, under numpy's dtype names: the same tree gives the same
manifest, chunk hashes included, in both packages.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Any, Callable

import numpy as np

# torch is imported where a tensor is handled: the head and the nodes
# import this module (manifest bookkeeping, chunk sets) and never torch.


def _np_dtype(name: str) -> "torch.dtype":
    """The torch dtype of a manifest dtype name (numpy's names, and
    ``bfloat16`` as the JAX package writes it)."""
    import torch

    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise TypeError(f"checkpoint dtype {name!r} has no torch dtype")
    return dt


def dtype_name(t: torch.Tensor) -> str:
    """The manifest name of a tensor's dtype (numpy's: ``float32``,
    ``int32``, ``bool``; ``bfloat16``)."""
    return str(t.dtype).removeprefix("torch.")


def host_bytes(t: torch.Tensor) -> np.ndarray:
    """A host tensor's elements as a flat uint8 array (no copy when
    contiguous): the bytes a chunk holds."""
    import torch

    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _as_tensor(leaf: Any) -> "torch.Tensor":
    import torch

    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))


def _is_node(tree: Any) -> bool:
    return (isinstance(tree, (dict, list, tuple))
            or (dataclasses.is_dataclass(tree) and not isinstance(tree, type)))


def _children(tree: Any) -> list[tuple[str, Any]]:
    """(key piece, child) of one node, in flatten order."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(f".{f}", getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return [(f".{f.name}", getattr(tree, f.name))
            for f in dataclasses.fields(tree)]


def tree_flatten_with_keys(tree: Any,
                           prefix: str = "") -> list[tuple[str, Any]]:
    """(key string, leaf) pairs in flatten order (dict keys sorted),
    keyed as ``jax.tree_util.keystr`` keys the same structure; None holds
    no leaf."""
    if tree is None:
        return []
    if not _is_node(tree):
        return [(prefix, tree)]
    out = []
    for piece, child in _children(tree):
        out += tree_flatten_with_keys(child, prefix + piece)
    return out


def tree_unflatten(like: Any, leaves) -> Any:
    """``like``'s structure with its leaves replaced by ``leaves`` (in
    :func:`tree_flatten_with_keys` order)."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if not _is_node(node):
            return next(it)
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(getattr(node, f))
                                for f in node._fields))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return dataclasses.replace(node, **{
            f.name: build(getattr(node, f.name))
            for f in dataclasses.fields(node)})

    return build(like)


def flatten_with_keys(tree: Any) -> list[tuple[str, Any]]:
    """(key, leaf) pairs in a stable, sorted order. The key is the jax
    path string — identical across processes for identical structures,
    which is what makes round-robin ownership a consistent partition."""
    out = tree_flatten_with_keys(tree)
    out.sort(key=lambda kv: kv[0])
    return out


def _is_dtensor(leaf: Any) -> bool:
    # No DTensor exists before torch is imported: a numpy tree never
    # imports it.
    if "torch" not in sys.modules:
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(leaf, DTensor)


def _is_process_sharded(leaf: Any) -> bool:
    return _is_dtensor(leaf) and leaf.device_mesh.size() > 1


def owned_items(
    tree: Any,
    rank: int,
    world: int,
    local_prefixes: tuple[str, ...] = (),
) -> list[tuple[str, Any]]:
    """The (key, leaf) items THIS rank persists: its round-robin slice of
    the replicated leaves plus every process-sharded leaf (each process
    then persists only its addressable windows).

    ``local_prefixes`` marks subtrees that are ALREADY a disjoint
    per-rank shard (the ZeRO-sharded optimizer state, train/zero.py:
    each rank's tree holds only the leaves it owns): every present leaf
    under such a prefix is persisted unconditionally — round-robin
    re-partitioning a per-rank-distinct key set would be inconsistent
    across ranks. The head merges all ranks' entries by key, so the
    committed manifest carries the full sharded state with no gather."""
    items = flatten_with_keys(tree)
    # Round-robin indexes count only the replicated (non-local) leaves
    # so the partition stays consistent whatever each rank's local
    # shard happens to contain.
    out = []
    i = 0
    for key, leaf in items:
        if local_prefixes and any(
            key.startswith(p) for p in local_prefixes
        ):
            out.append((key, leaf))
            continue
        if _is_process_sharded(leaf) or i % max(1, world) == rank % max(
            1, world
        ):
            out.append((key, leaf))
        i += 1
    return out


def dtensor_window(leaf) -> list | None:
    """[[start, stop], ...] per dimension of a DTensor's local shard in
    the global tensor, from its placements and this rank's mesh
    coordinate (shards as ``torch.chunk`` cuts them, mesh dimensions in
    order); None when a replicated mesh dimension's coordinate is not 0
    (that rank holds a replica, not a window to write)."""
    from torch.distributed.tensor import Replicate, Shard

    mesh = leaf.device_mesh
    coord = mesh.get_coordinate()
    window = [[0, d] for d in leaf.shape]
    for i, p in enumerate(leaf.placements):
        if isinstance(p, Shard):
            start, stop = window[p.dim]
            n = mesh.size(i)
            chunk = -(-(stop - start) // n)
            lo = min(start + coord[i] * chunk, stop)
            window[p.dim] = [lo, min(lo + chunk, stop)]
        elif isinstance(p, Replicate):
            if coord[i] != 0:
                return None
        else:
            raise ValueError(f"checkpoint: cannot persist a DTensor with "
                             f"placement {p} (a partial sum)")
    return window


def local_shards(leaf: Any) -> list[tuple[list | None, torch.Tensor]]:
    """(index_spec, host tensor) windows of this leaf owned by this
    process. index_spec is [[start, stop], ...] per dim (None = the whole
    array). A DTensor contributes its local shard (at coordinate 0 of
    every replicated mesh dimension only — replicas would write identical
    chunks, wasted hashing; elsewhere nothing); anything else is one full
    window. The tensors may still be on the device: the caller copies."""
    if not _is_dtensor(leaf):
        return [(None, _as_tensor(leaf).detach())]
    spec = dtensor_window(leaf)
    if spec is None:
        return []
    if all(a == 0 and b == dim for (a, b), dim in zip(spec, leaf.shape)):
        spec = None
    return [(spec, leaf.to_local().detach())]


def shard_shape(entry_shape: list, index: list | None) -> tuple:
    if index is None:
        return tuple(entry_shape)
    return tuple(b - a for a, b in index)


def assemble_leaf(
    key: str,
    shape: list,
    dtype: str,
    shards: list[dict],
    fetch_chunk: Callable[[str], bytes],
) -> "torch.Tensor":
    """Rebuild one leaf as a host tensor from its shard windows, pulling
    chunk bytes through ``fetch_chunk(hash)`` (each chunk copied once,
    into its place). Works for any surviving-replica set: windows may
    come from different ranks' manifests."""
    import torch

    out = torch.empty(tuple(shape), dtype=_np_dtype(dtype))
    covered = 0
    for sh in shards:
        index = sh.get("index")
        window = out if index is None else torch.empty(
            shard_shape(shape, index), dtype=out.dtype)
        flat = window.reshape(-1).view(torch.uint8).numpy()
        off = 0
        for h in sh["chunks"]:
            data = np.frombuffer(fetch_chunk(h), dtype=np.uint8)
            flat[off:off + data.size] = data
            off += data.size
        if off != flat.size:
            raise ValueError(f"checkpoint leaf {key}: a window's chunks "
                             f"hold {off} of its {flat.size} bytes")
        if index is not None:
            out[tuple(slice(a, b) for a, b in index)] = window
        covered += window.numel()
    if covered < out.numel():
        raise ValueError(
            f"checkpoint leaf {key}: shard windows cover {covered} of "
            f"{out.numel()} elements — a rank's manifest is "
            "missing (incomplete checkpoint exposed?)"
        )
    return out


def entry_bytes(entry: dict) -> int:
    return sum(int(sh.get("nbytes", 0)) for sh in entry.get("shards", ()))


def manifest_chunks(entries: dict | list) -> set[str]:
    """Every chunk hash referenced by a manifest's entries (dict keyed by
    leaf or a plain list of entries)."""
    vals = entries.values() if isinstance(entries, dict) else entries
    out: set[str] = set()
    for e in vals:
        for sh in e.get("shards", ()):
            out.update(sh.get("chunks", ()))
    return out


# Parity groups ride the manifest next to the entries: each record is
# {"data": [hash...], "parity": [hash...], "lens": [int...]} — the k
# data members (in matrix-row order), the m parity chunk hashes, and
# the true byte length of each data member (parity is computed over
# zero-padded equal-width rows; lens trims the reconstruction).

def parity_chunks(parity: list | None) -> set[str]:
    """Every PARITY chunk hash recorded by a manifest's parity groups
    (the data members are already covered by manifest_chunks)."""
    out: set[str] = set()
    for g in parity or ():
        out.update(g.get("parity", ()))
    return out


def parity_group_index(parity: list | None) -> dict[str, dict]:
    """chunk hash → its parity-group record, for every member (data and
    parity) of every group. First group wins on (rare) dedup overlap."""
    out: dict[str, dict] = {}
    for g in parity or ():
        for h in list(g.get("data", ())) + list(g.get("parity", ())):
            out.setdefault(h, g)
    return out
