"""ZeRO-style cross-replica sharded optimizer (arXiv:2004.13336).

Every dp replica holding full fp32 optimizer state is a capacity wall
(the AdamW moments are twice the fp32 parameters). This module shards
the *weight update* across replicas instead: leaf ownership is
round-robin over the sorted leaf keys — the EXACT
partition ``checkpoint/manifest.py owned_items`` uses — so each rank
keeps optimizer state for ~1/world of the leaves, applies the update
only to those, and the sharded state it checkpoints is the state it
already holds (no gather on save, no full materialization on restore).

The dataplane half lives in ``collective/bucketer.py``
(:meth:`GradBucketer.sync_sharded_async`): reduce-scatter delivers each
owner its reduced gradients, the shard-local update runs here, and the
weight all-gather rebuilds full params on every rank.

The optimizer (train/step.py's hand-written ``AdamW``) is applied PER
LEAF, so its clip by the global norm would silently become a per-leaf
clip: :meth:`ZeroOptimizer.apply` hands it the norm it is given, the
true global norm from :func:`global_grad_norm` (one scalar allreduce),
or none (no clip).
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch

from ray_tpu_torch.checkpoint import manifest as _manifest

#: Key prefix of the sharded optimizer subtree in a checkpoint state —
#: leaves under it are persisted by WHOEVER HOLDS THEM (they are a
#: disjoint shard by construction), not round-robin re-partitioned.
CKPT_PREFIX = "['zero_opt']"
# The one key of the single-leaf tree each leaf's AdamW state is kept as.
_LEAF = "leaf"


def partition(keys, world: int) -> dict[str, int]:
    """Round-robin leaf ownership over SORTED keys: key i belongs to
    rank ``i % world``. Deterministic in (keys, world) — a resize
    re-partitions identically on every worker."""
    return {k: i % max(1, int(world)) for i, k in enumerate(sorted(keys))}


def global_grad_norm(owned_sq_sum: float, group_name: str | None = None):
    """True global gradient norm from this rank's owned-leaf square
    sum: one scalar allreduce over the group (each leaf is owned by
    exactly one rank, so the sum is exact). Without a group (world 1 /
    tests) the local sum is the global one."""
    total = float(owned_sq_sum)
    if group_name:
        import ray_tpu_torch.collective as col

        total = float(
            np.asarray(
                col.allreduce(
                    np.asarray(total, np.float64), group_name=group_name
                )
            )
        )
    return float(np.sqrt(total))


class ZeroOptimizer:
    """Shard-local optimizer state for one dp rank.

    ::

        zo = zero.ZeroOptimizer(make_optimizer(1e-3), params, rank, world)
        pending = bucketer.sync_sharded_async(grads)
        updated = zo.apply(pending.wait(), params)     # owned leaves
        params = bucketer.zero_unflatten(
            params, pending.allgather_updated(updated).wait())

    The resident optimizer footprint is claimed in the device-memory
    ledger under ``train.state.optimizer`` (the same tag the replicated
    path uses), priced at the SHARD's bytes — the HBM ledger then
    attributes the ~1/world footprint honestly, and a repartition
    closes the stale claim before registering the new one (TPU404's
    no-leaked-Registration discipline)."""

    def __init__(
        self,
        optimizer,
        params,
        rank: int,
        world: int,
        mem_tag: str = "train.state.optimizer",
    ):
        self.optimizer = optimizer
        self.mem_tag = mem_tag
        self._mem_reg = None
        self.rank = 0
        self.world = 1
        self.keys: list[str] = []
        self.owners: dict[str, int] = {}
        #: leaf key → AdamW state for the leaves THIS rank owns
        self.states: dict[str, Any] = {}
        self.repartition(rank, world, params)

    # ------------------------------------------------------- partition
    def owned_keys(self) -> list[str]:
        return [k for k in self.keys if self.owners[k] == self.rank]

    def leaf_map(self, tree) -> dict[str, Any]:
        """{key: leaf} of a params-shaped tree (manifest key order)."""
        return dict(_manifest.flatten_with_keys(tree))

    def repartition(self, rank: int, world: int, params) -> None:
        """Re-own after a world change (elastic resize): recompute the
        round-robin partition, keep states for still-owned leaves, init
        fresh states for newly-owned ones, drop the rest, and replace
        the memory claim (the stale shard's Registration is closed, not
        leaked)."""
        self.rank = int(rank)
        self.world = max(1, int(world))
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {rank} out of range for world {world}"
            )
        leaves = self.leaf_map(params)
        self.keys = list(leaves)
        self.owners = partition(self.keys, self.world)
        fresh: dict[str, Any] = {}
        for key in self.owned_keys():
            prev = self.states.get(key)
            fresh[key] = (
                prev if prev is not None
                else self.optimizer.init(
                    {_LEAF: torch.as_tensor(leaves[key])})
            )
        self.states = fresh
        self._register_memory()

    # ---------------------------------------------------------- update
    def apply(
        self,
        owned_grads: dict[str, Any],
        params,
        grad_scale: float | None = None,
        update_fn: Callable | None = None,
        grad_norm=None,
    ) -> dict[str, Any]:
        """Shard-local weight update: for every owned leaf, apply the
        optimizer to its reduced gradient and return ``{key: updated
        param}`` (the owned params, updated in place) — the input of
        :meth:`~ray_tpu_torch.collective.bucketer.PendingZeroSync.allgather_updated`.
        ``grad_scale`` pre-multiplies gradients (1/world for a mean
        over a SUM-reduced sync, or a global-norm clip factor);
        ``grad_norm`` is the norm AdamW clips by (the whole gradient
        tree's, :func:`global_grad_norm`; None: no clip);
        ``update_fn(key, grad, state, param) -> (new_param, new_state)``
        overrides the AdamW application (hand-rolled deterministic
        updates in the parity twin)."""
        leaves = self.leaf_map(params)
        norm = torch.as_tensor(0.0 if grad_norm is None else grad_norm,
                               dtype=torch.float32)
        out: dict[str, Any] = {}
        for key in self.owned_keys():
            if key not in owned_grads:
                raise KeyError(
                    f"sharded sync delivered no gradient for owned "
                    f"leaf {key}; got {sorted(owned_grads)[:4]}…"
                )
            grad = owned_grads[key]
            if grad_scale is not None:
                grad = grad * grad_scale
            if update_fn is not None:
                out[key], self.states[key] = update_fn(
                    key, grad, self.states[key], leaves[key]
                )
                continue
            param = torch.as_tensor(leaves[key])
            self.states[key] = self.optimizer.apply(
                {_LEAF: param}, {_LEAF: torch.as_tensor(grad)},
                self.states[key], grad_norm=norm.to(param.device),
            )
            out[key] = param
        return out

    # ------------------------------------------------------ checkpoint
    def checkpoint_tree(self) -> dict:
        """The sharded-state subtree to merge into the checkpointed
        state: ``{"zero_opt": {leaf key: AdamW state}}`` holding ONLY
        this rank's shard. Pass ``local_prefixes=(zero.CKPT_PREFIX,)``
        to the saver so these leaves persist as-held instead of being
        round-robin re-partitioned."""
        return {"zero_opt": dict(self.states)}

    def restore_target(self, params) -> dict:
        """A freshly-initialized checkpoint subtree for the leaves this
        rank NOW owns — the ``target=`` for a resharded restore (M ≠ N
        workers): each new owner pulls exactly its shard's chunks from
        whichever replicas survive."""
        leaves = self.leaf_map(params)
        return {
            "zero_opt": {
                key: self.optimizer.init(
                    {_LEAF: torch.as_tensor(leaves[key])})
                for key in self.owned_keys()
            }
        }

    def load_checkpoint_tree(self, tree: dict) -> None:
        """Adopt restored optimizer states (the ``zero_opt`` subtree of
        a :meth:`restore_target`-shaped restore)."""
        states = tree.get("zero_opt", tree)
        for key in self.owned_keys():
            if key in states:
                self.states[key] = states[key]
        self._register_memory()

    # ---------------------------------------------------------- memory
    def shard_bytes(self) -> int:
        return int(
            sum(
                leaf.nbytes
                for state in self.states.values()
                for _key, leaf in _manifest.tree_flatten_with_keys(state)
                if hasattr(leaf, "nbytes")
            )
        )

    def _register_memory(self) -> None:
        from ray_tpu_torch.runtime import memory as rmem

        if self._mem_reg is not None:
            self._mem_reg.close()
            self._mem_reg = None
        if not rmem.enabled():
            return
        self._mem_reg = rmem.track(
            self.mem_tag, kind="optimizer", nbytes=self.shard_bytes()
        )
        rmem.tag_arrays(self.mem_tag, "optimizer", list(self.states.values()))

    def close(self) -> None:
        if self._mem_reg is not None:
            self._mem_reg.close()
            self._mem_reg = None
