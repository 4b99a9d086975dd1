"""Scheduling strategies (reference surface:
python/ray/util/scheduling_strategies.py —
PlacementGroupSchedulingStrategy :17, NodeAffinitySchedulingStrategy :43,
NodeLabelSchedulingStrategy :164).

Passed via ``.options(scheduling_strategy=...)`` on tasks and actors.
TPU note: node labels are the reference's mechanism for slice topology
("TPU-<ver>-head", slice names — util/tpu.py:345 _reserve_slice), so
label scheduling is what pins work to a specific slice or host kind."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any


@dataclass
class PlacementGroupSchedulingStrategy:
    """Run on a reserved bundle of a placement group."""

    placement_group: Any
    placement_group_bundle_index: int = 0
    placement_group_capture_child_tasks: bool = False


@dataclass
class NodeAffinitySchedulingStrategy:
    """Pin to a node by id. ``soft=False`` fails when the node cannot
    take the work; ``soft=True`` falls back to normal scheduling."""

    node_id: str
    soft: bool = False


@dataclass
class NodeLabelSchedulingStrategy:
    """Match nodes by label. ``hard`` constraints filter candidate
    nodes (label → value or list of acceptable values); ``soft``
    constraints only raise a matching node's score."""

    hard: dict = field(default_factory=dict)
    soft: dict = field(default_factory=dict)


def to_scheduling_spec(strategy) -> dict | None:
    """Strategy object → wire dict for the lease path (None for the
    default hybrid policy)."""
    if strategy is None or strategy == "DEFAULT":
        return None
    if isinstance(strategy, NodeAffinitySchedulingStrategy):
        return {"node_id": strategy.node_id, "soft": strategy.soft}
    if isinstance(strategy, NodeLabelSchedulingStrategy):
        return {
            "labels_hard": dict(strategy.hard),
            "labels_soft": dict(strategy.soft),
        }
    raise TypeError(f"unsupported scheduling strategy: {strategy!r}")


def labels_match(node_labels: dict, constraints: dict) -> bool:
    for key, want in (constraints or {}).items():
        have = node_labels.get(key)
        if isinstance(want, (list, tuple, set)):
            if have not in want:
                return False
        elif have != want:
            return False
    return True
