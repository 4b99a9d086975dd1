"""Demand → node-type bin-packing (reference: autoscaler/v2/scheduler.py
ResourceDemandScheduler — first-fit-decreasing over node type shapes).
"""

from __future__ import annotations


def _fits(avail: dict, req: dict) -> bool:
    return all(avail.get(k, 0) >= v for k, v in req.items())


def _take(avail: dict, req: dict) -> None:
    for k, v in req.items():
        avail[k] = avail.get(k, 0) - v


def fit_demand(
    demand: list[dict],
    node_types: dict[str, dict],
    existing_counts: dict[str, int],
    free_by_node: list[dict],
) -> dict[str, int]:
    """Return {node_type: count} of nodes to add so `demand` fits.

    `node_types`: {name: {"resources": {...}, "max_workers": int}}.
    `free_by_node`: currently-available resources per live node (demand
    that fits existing headroom needs no new nodes).
    """
    # Largest requests first: better packing, fewer nodes.
    pending = sorted(
        (dict(d) for d in demand),
        key=lambda d: -sum(d.values()),
    )
    headroom = [dict(f) for f in free_by_node]
    to_add: dict[str, int] = {}
    virtual: list[dict] = []  # capacity of nodes we've decided to add

    for req in pending:
        placed = False
        for avail in headroom + virtual:
            if _fits(avail, req):
                _take(avail, req)
                placed = True
                break
        if placed:
            continue
        # Pick the cheapest (smallest total capacity) node type that can
        # ever fit the request, respecting max_workers.
        candidates = []
        for name, cfg in node_types.items():
            if not _fits(cfg["resources"], req):
                continue
            used = existing_counts.get(name, 0) + to_add.get(name, 0)
            if used >= cfg.get("max_workers", 2**31):
                continue
            candidates.append((sum(cfg["resources"].values()), name))
        if not candidates:
            continue  # permanently infeasible: surface via status, not nodes
        _, chosen = min(candidates)
        to_add[chosen] = to_add.get(chosen, 0) + 1
        cap = dict(node_types[chosen]["resources"])
        _take(cap, req)
        virtual.append(cap)
    return to_add
