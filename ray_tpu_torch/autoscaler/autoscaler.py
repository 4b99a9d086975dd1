"""The autoscaler control loop.

Reference: v2 Autoscaler (autoscaler/v2/autoscaler.py:50): each tick,
read cluster resource state from the head, bin-pack unmet demand into new
nodes (scheduler.py), launch via the provider, and reap nodes idle past
the timeout. Runs in the driver process as a plain thread-driven loop
(the reference runs it in the monitor process on the head node).
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass, field

logger = logging.getLogger("ray_tpu_torch.autoscaler")

from ray_tpu_torch import api as core_api
from ray_tpu_torch.autoscaler.providers import NodeProvider
from ray_tpu_torch.autoscaler.scheduler import fit_demand
from ray_tpu_torch.util.metrics import Gauge

_CHRONIC_STRAGGLER = Gauge(
    "ray_tpu_autoscaler_chronic_straggler",
    "slowest/missing collective-contribution count of a node flagged "
    "for replacement",
    tag_keys=("node",),
)


@dataclass
class NodeTypeConfig:
    resources: dict
    min_workers: int = 0
    max_workers: int = 10


@dataclass
class _TrackedNode:
    provider_id: str
    node_type: str
    idle_since: float | None = None
    launched_at: float = field(default_factory=time.monotonic)


class Autoscaler:
    def __init__(
        self,
        provider: NodeProvider,
        node_types: dict[str, NodeTypeConfig],
        *,
        idle_timeout_s: float = 30.0,
        interval_s: float = 1.0,
        boot_grace_s: float = 600.0,
        straggler_threshold: int = 20,
        straggler_drain: bool = True,
        straggler_drain_deadline_s: float = 120.0,
    ):
        self.provider = provider
        self.node_types = node_types
        self.idle_timeout_s = idle_timeout_s
        self.interval_s = interval_s
        self.boot_grace_s = boot_grace_s
        # A node whose collective_straggler_total (slowest or missing
        # contributor, summed across its ranks/groups) reaches this is
        # flagged as a chronic straggler — and, with straggler_drain on,
        # DRAINED through the head and replaced through the provider
        # (drain-and-replace, not just log-and-gauge).
        self.straggler_threshold = straggler_threshold
        self.straggler_drain = straggler_drain
        self.straggler_drain_deadline_s = straggler_drain_deadline_s
        self._flagged_stragglers: set[str] = set()
        self._drained_stragglers: set[str] = set()
        # Draining runtime node ids we already launched a replacement
        # for: one drain notice buys exactly one proactive launch.
        self._drain_replaced: set[str] = set()
        self._tracked: dict[str, _TrackedNode] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.last_status: dict = {}

    # ----------------------------------------------------------- control
    def start(self):
        # Adopt capacity that already exists (an autoscaler RESTART must
        # not double-provision slices it forgot, nor leak ones it can
        # no longer reap — the provider's API listing is authoritative).
        try:
            for pid, ntype in self.provider.non_terminated_nodes().items():
                if ntype in self.node_types and pid not in self._tracked:
                    self._tracked[pid] = _TrackedNode(pid, ntype)
        except Exception:  # noqa: BLE001 - provider may be offline
            logger.exception("could not list pre-existing nodes")
        for name, cfg in self.node_types.items():
            existing = sum(
                1 for t in self._tracked.values() if t.node_type == name
            )
            for _ in range(max(0, cfg.min_workers - existing)):
                self._launch(name)
        self._thread = threading.Thread(
            target=self._loop, name="ray_tpu_autoscaler", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=10)

    def _loop(self):
        while not self._stop.wait(self.interval_s):
            try:
                self.update()
            except Exception as e:  # noqa: BLE001 - keep autoscaling alive
                logger.exception("autoscaler tick failed")
                self.last_status = {"error": repr(e), "ts": time.time()}

    # ------------------------------------------------------------- tick
    def _cluster_status(self) -> dict:
        rt = core_api._runtime

        async def go():
            return await rt.core.head.call("cluster_status")

        return rt.run(go())

    def _straggler_node_counts(self) -> dict[str, float]:
        """Per-node chronic-straggler counts from the head (summed
        collective_straggler_total resolved through the collective
        membership table)."""
        rt = core_api._runtime

        async def go():
            return await rt.core.head.call("collective_straggler_stats")

        try:
            return rt.run(go()).get("nodes") or {}
        except Exception:  # noqa: BLE001 - telemetry must not stop ticks
            logger.debug(
                "straggler stats unavailable this tick", exc_info=True
            )
            return {}

    def _check_stragglers(
        self, node_counts: dict[str, float]
    ) -> dict[str, float]:
        """Flag chronic collective stragglers (log once + gauge). The
        autoscaler does not kill them itself — a straggler is slow, not
        dead, and may host other work — it surfaces the replacement
        signal (metric + last_status) for the operator/policy layer."""
        chronic: dict[str, float] = {}
        for nid, count in node_counts.items():
            if count < self.straggler_threshold:
                continue
            chronic[nid] = count
            _CHRONIC_STRAGGLER.set(count, tags={"node": nid})
            if nid not in self._flagged_stragglers:
                self._flagged_stragglers.add(nid)
                logger.warning(
                    "node %s was the slowest/missing collective "
                    "contributor %d times (threshold %d): chronic "
                    "straggler, flagging for replacement",
                    nid[:12], int(count), self.straggler_threshold,
                )
        return chronic

    def _launch(self, node_type: str):
        pid = self.provider.create_node(
            node_type, self.node_types[node_type].resources
        )
        self._tracked[pid] = _TrackedNode(pid, node_type)

    def _drain_node_via_head(self, node_id: str, reason: str) -> bool:
        rt = core_api._runtime

        async def go():
            return await rt.core.head.call(
                "drain_node",
                node_id=node_id,
                reason=reason,
                deadline_s=self.straggler_drain_deadline_s,
            )

        try:
            return bool(rt.run(go()).get("ok"))
        except Exception:  # noqa: BLE001 - retried next tick
            logger.warning(
                "drain request for node %s failed; retrying next tick",
                node_id[:12], exc_info=True,
            )
            return False

    def _node_type_for(self, node_id: str, node: dict) -> str | None:
        """Which configured node type a runtime node corresponds to:
        the provider-tracked type when we launched it, else the first
        type whose resource shape the node covers (static nodes)."""
        for pid, tracked in self._tracked.items():
            if self.provider.runtime_node_id(pid) == node_id:
                return tracked.node_type
        for name, cfg in self.node_types.items():
            if all(
                node.get("resources", {}).get(k, 0) >= v
                for k, v in cfg.resources.items()
            ):
                return name
        return None

    @staticmethod
    def _drain_unit(nid: str, node: dict) -> str:
        """Replacement-dedupe key for a draining node: its SLICE label
        when it has one (the provider's create_node provisions a whole
        slice, so a slice going away buys exactly ONE launch however
        many hosts it has), else the node itself."""
        slice_id = (node.get("labels") or {}).get("slice")
        return f"slice:{slice_id}" if slice_id else nid

    def _handle_draining(
        self, draining: dict, nodes: dict, counts: dict[str, int]
    ) -> None:
        """Act on drain notices: (1) proactively provision a replacement
        per draining FAULT UNIT — one launch per draining slice (all its
        hosts drain together under slice fault domains; the replacement
        slice boots as a unit WHILE the old one finishes its work),
        else per node — and (2) terminate provider-owned drained nodes
        once they are empty or past their deadline."""
        now_wall = time.time()
        for nid, dinfo in draining.items():
            unit = self._drain_unit(nid, nodes.get(nid, {}))
            if unit in self._drain_replaced:
                continue
            self._drain_replaced.add(unit)
            ntype = self._node_type_for(nid, nodes.get(nid, {}))
            if ntype is None:
                continue
            if counts.get(ntype, 0) < self.node_types[ntype].max_workers:
                logger.info(
                    "%s draining (%s): provisioning a replacement %s",
                    unit if unit.startswith("slice:")
                    else f"node {nid[:12]}",
                    dinfo.get("reason", ""), ntype,
                )
                self._launch(ntype)
                counts[ntype] = counts.get(ntype, 0) + 1
        # Reap provider-owned drained nodes. Ignores min_workers — the
        # replacement is already tracked against the same type. Nodes
        # sharing a draining SLICE reap as ONE provider call
        # (terminate_nodes) once the whole unit is empty/expired: the
        # slice tears down as the unit it was provisioned as, not N
        # per-host API round-trips.
        unit_members: dict[str, list[str]] = {}
        unit_ready: dict[str, list[str]] = {}
        for pid, tracked in list(self._tracked.items()):
            rid = self.provider.runtime_node_id(pid)
            if rid is None or rid not in draining:
                continue
            node = nodes.get(rid)
            unit = self._drain_unit(rid, node or {})
            unit_members.setdefault(unit, []).append(pid)
            emptied = node is not None and not node.get("pending") and all(
                node["available"].get(k, 0) >= v
                for k, v in node["resources"].items()
            )
            expired = now_wall > draining[rid].get("deadline_ts", 0.0)
            if node is None or emptied or expired:
                unit_ready.setdefault(unit, []).append(pid)
        for unit, pids in unit_ready.items():
            if len(pids) < len(unit_members[unit]):
                # Part of the slice still holds work inside its notice
                # window: the unit reaps together on a later tick (the
                # drain deadline bounds the wait).
                continue
            logger.info(
                "terminating drained %s as one unit: %s",
                unit if unit.startswith("slice:") else f"node {unit[:12]}",
                pids,
            )
            try:
                self.provider.terminate_nodes(pids)
            finally:
                for pid in pids:
                    self._tracked.pop(pid, None)
        # Forget replacement markers for units no longer draining/alive.
        self._drain_replaced &= {
            self._drain_unit(nid, nodes.get(nid, {})) for nid in draining
        }

    def update(self):
        """One reconcile tick (public for deterministic tests)."""
        status = self._cluster_status()
        nodes = status["nodes"]
        draining = status.get("draining") or {}

        # Demand = per-node queued leases + cluster-wide unschedulable.
        demand = list(status.get("unschedulable", []))
        for n in nodes.values():
            demand.extend(n.get("pending", []))

        counts: dict[str, int] = {}
        for t in self._tracked.values():
            counts[t.node_type] = counts.get(t.node_type, 0) + 1

        # Chronic stragglers → drain-and-replace: the drain excludes the
        # node from new placements and fans the notice out; the generic
        # drain handling below provisions its replacement.
        chronic = self._check_stragglers(self._straggler_node_counts())
        if self.straggler_drain:
            for nid in chronic:
                if nid in self._drained_stragglers or nid not in nodes:
                    continue
                if self._drain_node_via_head(nid, "chronic straggler"):
                    self._drained_stragglers.add(nid)
                    draining = dict(draining)
                    draining.setdefault(
                        nid,
                        {
                            "reason": "chronic straggler",
                            "deadline_ts": time.time()
                            + self.straggler_drain_deadline_s,
                        },
                    )

        self._handle_draining(draining, nodes, counts)

        # A draining node's capacity is spoken for — counting it as free
        # would cancel out the very demand its replacement should absorb.
        free = [
            dict(n["available"])
            for nid, n in nodes.items()
            if nid not in draining
        ]
        # Credit capacity of launched-but-not-yet-registered nodes (real
        # providers take minutes to boot a slice): without this, every
        # tick re-launches for the same unmet demand. The credit expires
        # after boot_grace_s — a provider that cannot map provider ids to
        # runtime node ids (runtime_node_id → None) must not accrue
        # phantom capacity forever.
        registered = set(nodes)
        now = time.monotonic()
        for pid, tracked in list(self._tracked.items()):
            rid = self.provider.runtime_node_id(pid)
            if rid is not None and rid in registered:
                continue
            if now - tracked.launched_at < self.boot_grace_s:
                free.append(
                    dict(self.node_types[tracked.node_type].resources)
                )
            elif rid is not None:
                # Mappable provider, node never registered within the
                # grace window: a failed launch. Reap it — leaving it
                # tracked would pin a max_workers slot (and the cloud
                # bill) forever while contributing nothing.
                logger.warning(
                    "node %s (%s) failed to register within %.0fs; "
                    "terminating",
                    pid, tracked.node_type, self.boot_grace_s,
                )
                try:
                    self.provider.terminate_node(pid)
                finally:
                    del self._tracked[pid]
            # rid is None (provider can't map ids, e.g. the GKE stub):
            # keep it tracked but uncredited — reaping on a blind signal
            # would kill healthy registered nodes.
        to_add = fit_demand(
            demand,
            {
                name: {
                    "resources": cfg.resources,
                    "max_workers": cfg.max_workers,
                }
                for name, cfg in self.node_types.items()
            },
            counts,
            free,
        )
        for name, count in to_add.items():
            for _ in range(count):
                self._launch(name)

        # Idle termination: a provider-launched node whose available ==
        # total (nothing leased) for idle_timeout_s goes away, floored at
        # min_workers per type.
        now = time.monotonic()
        runtime_ids = {
            self.provider.runtime_node_id(pid): pid for pid in self._tracked
        }
        for nid, n in nodes.items():
            pid = runtime_ids.get(nid)
            if pid is None:
                continue
            tracked = self._tracked[pid]
            busy = any(
                n["available"].get(k, 0) < v
                for k, v in n["resources"].items()
            ) or n.get("pending")
            if busy:
                tracked.idle_since = None
            elif tracked.idle_since is None:
                tracked.idle_since = now

        for pid, tracked in list(self._tracked.items()):
            cfg = self.node_types[tracked.node_type]
            alive_of_type = sum(
                1
                for t in self._tracked.values()
                if t.node_type == tracked.node_type
            )
            if (
                tracked.idle_since is not None
                and now - tracked.idle_since > self.idle_timeout_s
                and alive_of_type > cfg.min_workers
            ):
                self.provider.terminate_node(pid)
                del self._tracked[pid]

        # Serve replica deficits (controller autoscale reports relayed
        # through cluster_status): a deployment below target means its
        # replica leases are or will be in the demand list above — the
        # deficit view ties the two control loops together for the
        # operator (`ray_tpu_torch status`, last_status asserts in tests).
        serve_deficits = {
            key: {
                "target": rec.get("target", 0),
                "replicas": rec.get("replicas", 0),
                "missing": rec.get("target", 0) - rec.get("replicas", 0),
            }
            for key, rec in (status.get("serve_autoscale") or {}).items()
            if rec.get("target", 0) > rec.get("replicas", 0)
        }

        self.last_status = {
            "demand": demand,
            "added": to_add,
            "tracked": {
                pid: t.node_type for pid, t in self._tracked.items()
            },
            "draining": {nid: dict(d) for nid, d in draining.items()},
            "chronic_stragglers": chronic,
            "serve_deficits": serve_deficits,
        }
        return self.last_status
