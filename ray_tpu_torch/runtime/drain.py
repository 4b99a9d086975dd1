"""Process-local drain-notice registry.

The head fans node-drain notices out on the "collective" pubsub channel
(the same channel PR 1's member-death fan-out uses, so any process that
already watches for collective deaths learns about drains with no extra
subscription). Each process records the notices here; the train session
reads them to decide on emergency checkpoints (`train.preemption_notice`)
and the typed `PreemptedError` unwind.

Notices are advisory state, not commands: a notice for a node this
process does not run on still matters (rank 0 persists the emergency
checkpoint for a peer's draining node), so the registry keeps every
node's notice and lets callers filter by node address.
"""

from __future__ import annotations

import logging
import time
from typing import Callable

from ray_tpu_torch.util.metrics import Counter

logger = logging.getLogger(__name__)

EVACUATED = Counter(
    "ray_tpu_objects_evacuated_total",
    "general (non-checkpoint) objects moved off a draining node, by "
    "outcome: 'peer' (owner pushed to a healthy node), 'remote_tier' "
    "(no peer fit), 'failed'",
    tag_keys=("outcome",),
)

# Keep an expired notice in the registry for a while (forensics: WHY is
# my node about to die / why did it drain), but stop reporting it as
# ACTIVE shortly after its deadline — a preemption scare that never
# killed the node must not keep forcing emergency checkpoints.
_EXPIRED_KEEP_S = 300.0
_ACTIVE_GRACE_S = 10.0

# node_id → {node_id, node_addr, reason, deadline_ts, since}
_notices: dict[str, dict] = {}

# Callbacks invoked with each freshly recorded notice (object owners
# hook drain-time evacuation here without stealing the one-per-channel
# pubsub handler slot the collective death watch owns).
_listeners: list[Callable[[dict], None]] = []


def add_listener(fn: Callable[[dict], None]) -> None:
    """Register a callback for future drain notices. Idempotent per
    function object; exceptions are logged, never propagated into the
    pubsub handler."""
    if fn not in _listeners:
        _listeners.append(fn)


def remove_listener(fn: Callable[[dict], None]) -> None:
    try:
        _listeners.remove(fn)
    except ValueError:
        pass


def record(msg: dict) -> None:
    """Fold one "node_draining" fan-out message into the registry."""
    node_id = msg.get("node_id")
    if not node_id:
        return
    now = time.time()
    deadline_ts = msg.get("deadline_ts")
    if deadline_ts is None:
        deadline_ts = now + float(msg.get("deadline_s") or 0.0)
    _notices[str(node_id)] = {
        "node_id": str(node_id),
        "node_addr": msg.get("node_addr"),
        "reason": msg.get("reason") or "",
        "deadline_ts": float(deadline_ts),
        "since": now,
    }
    for fn in list(_listeners):
        try:
            fn(dict(_notices[str(node_id)]))
        # tpulint: allow(broad-except reason=a listener bug must not break the registry or the pubsub handler that feeds it)
        except Exception:
            logger.warning("drain listener %r failed", fn, exc_info=True)


def clear(node_id: str | None) -> None:
    if node_id:
        _notices.pop(str(node_id), None)


def _prune() -> None:
    now = time.time()
    for nid, n in list(_notices.items()):
        if now > n["deadline_ts"] + _EXPIRED_KEEP_S:
            del _notices[nid]


def notices() -> dict[str, dict]:
    _prune()
    return {nid: dict(n) for nid, n in _notices.items()}


def _is_active(n: dict) -> bool:
    return time.time() <= n["deadline_ts"] + _ACTIVE_GRACE_S


def for_node_addr(node_addr: str | None) -> dict | None:
    """The ACTIVE notice for a specific node address (this process's
    own node, usually), or None."""
    if not node_addr:
        return None
    _prune()
    for n in _notices.values():
        if n.get("node_addr") == node_addr and _is_active(n):
            return dict(n)
    return None


def any_notice() -> dict | None:
    """Any ACTIVE notice, soonest deadline first (cluster-wide view —
    lets rank 0 checkpoint for a peer's draining node)."""
    _prune()
    live = [n for n in _notices.values() if _is_active(n)]
    if not live:
        return None
    return dict(min(live, key=lambda n: n["deadline_ts"]))


def reset() -> None:
    """Test hook: forget every notice and listener (process-local state
    otherwise leaks across in-process cluster fixtures)."""
    _notices.clear()
    _listeners.clear()
