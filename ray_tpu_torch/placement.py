"""Placement groups: gang-reserved resource bundles.

Public surface mirrors the reference (reference:
python/ray/util/placement_group.py — placement_group(), ready(),
remove_placement_group(); strategies PACK/SPREAD/STRICT_*), including a
whole-slice reservation helper in the spirit of
ray.util.tpu.SlicePlacementGroup (util/tpu.py:223) that makes a gang of
GPU hosts the bundle unit.
"""

from __future__ import annotations

from typing import Sequence

from ray_tpu_torch._private.ids import ActorID


class PlacementGroup:
    def __init__(
        self,
        pg_id: str,
        bundles: list[dict],
        strategy: str,
        node_infos: list[dict],
    ):
        self.id = pg_id
        self.bundles = bundles
        self.strategy = strategy
        self.node_infos = node_infos  # per-bundle {node_id, addr}

    def bundle_node_addr(self, index: int) -> str:
        return self.node_infos[index]["addr"]

    def ready(self) -> bool:
        return True  # creation is synchronous in this runtime

    def __reduce__(self):
        return (
            PlacementGroup,
            (self.id, self.bundles, self.strategy, self.node_infos),
        )

    def __repr__(self):
        return f"PlacementGroup({self.id[:8]}…, {len(self.bundles)} bundles)"


def placement_group(
    bundles: Sequence[dict],
    strategy: str = "PACK",
    name: str | None = None,
) -> PlacementGroup:
    import ray_tpu_torch.api as api

    rt = api._runtime
    pg_id = ActorID.random().hex()
    reply = rt.run(
        rt.core.head.call(
            "create_placement_group",
            pg_id=pg_id,
            bundles=[dict(b) for b in bundles],
            strategy=strategy,
        )
    )
    if not reply.get("ok"):
        raise ValueError(
            f"placement group creation failed: {reply.get('error')}"
        )
    return PlacementGroup(pg_id, list(bundles), strategy, reply["nodes"])


def remove_placement_group(pg: PlacementGroup) -> None:
    import ray_tpu_torch.api as api

    rt = api._runtime
    rt.run(rt.core.head.call("remove_placement_group", pg_id=pg.id))


def slice_placement_group(
    num_hosts: int, chips_per_host: int = 4, strategy: str = "STRICT_SPREAD"
) -> PlacementGroup:
    """Reserve a slice of GPU hosts as one gang: one bundle per host,
    each holding that host's cards (reference:
    ray.util.tpu.slice_placement_group util/tpu.py:458 approximates this
    with label selectors)."""
    return placement_group(
        [{"GPU": float(chips_per_host), "CPU": 1.0}] * num_hosts,
        strategy=strategy,
    )


def cross_slice_placement_group(
    num_bundles: int, bundle: "dict | None" = None
) -> PlacementGroup:
    """Reserve ``num_bundles`` bundles on ``num_bundles`` DISTINCT
    slices (strategy ``STRICT_SPREAD_SLICES``): the fault-domain dual of
    :func:`slice_placement_group`. A whole-slice preemption then takes
    at most ONE bundle — the placement shape for checkpoint replica
    holders, replicated serve deployments, and anything else that must
    survive a slice going away as a unit. Nodes without a ``slice``
    label count as their own singleton fault domain. Fails when the
    cluster has fewer distinct slices than bundles."""
    return placement_group(
        [dict(bundle or {"CPU": 1.0})] * num_bundles,
        strategy="STRICT_SPREAD_SLICES",
    )
