"""Head service: cluster-metadata authority (GCS equivalent).

Mirrors the reference's GCS server responsibilities (reference:
src/ray/gcs/gcs_server.h:100 — node table, actor registry, KV store,
pubsub, health checks, cluster-level scheduling) in one asyncio service.
State lives in process memory behind a tiny storage interface so a
Redis/file backend can slot in for fault tolerance (reference:
gcs/store_client/redis_store_client.h:126).
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time
from typing import Any

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.ids import ActorID, NodeID

logger = logging.getLogger("ray_tpu_torch.head")

class HeadService:
    def __init__(self, journal_path: str | None = None):
        self.server = rpc.Server(self._handle)
        self.addr: str | None = None
        # Durable-state journal (reference: Redis-backed GCS tables,
        # redis_store_client.h:126). Off unless a path is configured —
        # single-driver test clusters don't pay the fsync tax.
        if journal_path is None:
            from ray_tpu_torch._private import config

            journal_path = config.get("HEAD_JOURNAL") or None
        self.journal = None
        if journal_path and journal_path != "off":
            from ray_tpu_torch._private import config
            from ray_tpu_torch.runtime.head_storage import FileJournal

            self.journal = FileJournal(
                journal_path, fsync=config.get("JOURNAL_FSYNC")
            )
        # node_id hex → {addr, resources, labels, last_seen, conn}
        self.nodes: dict[str, dict] = {}
        # node_id hex → {reason, deadline_ts, since}: DRAINING nodes.
        # A draining node stays in the node table (its leases keep
        # running, its heartbeats keep counting) but receives no new
        # task leases, placements, or bundles; the notice fans out on
        # pubsub so workers learn BEFORE the node dies. Journaled: a
        # head restart must not resurrect a preempting node into the
        # schedulable pool.
        self.draining: dict[str, dict] = {}
        self.kv: dict[str, bytes] = {}
        # actor_id hex → {name, state, addr, node_id, class_name}
        self.actors: dict[str, dict] = {}
        self.named_actors: dict[str, str] = {}  # name → actor_id hex
        # channel → set[Connection]
        self.subs: dict[str, set[rpc.Connection]] = {}
        # pg_id → {bundles: [dict], strategy, nodes: [node_id per bundle]}
        self.placement_groups: dict[str, dict] = {}
        # head-initiated client conns to each node (for PG prepare/commit)
        self._node_conns: dict[str, rpc.Connection] = {}
        self._reaper: asyncio.Task | None = None
        # Task-event store (reference: GcsTaskManager gcs_task_manager.h:97
        # buffers worker-flushed task state transitions for the state API
        # and `ray timeline`). Ring-bounded; per-task latest state capped.
        self.task_events: collections.deque = collections.deque(maxlen=20000)
        self.task_latest: collections.OrderedDict = collections.OrderedDict()
        # worker addr → latest metrics snapshot {name: record}
        self.metrics: dict[str, dict] = {}
        # Per-train-job goodput accounting, folded from rank-0
        # "train:step" SPAN events as they arrive on the task-event
        # pipeline: productive step time vs. time lost to stalls
        # (inter-step gaps, data wait, checkpointing) and to elastic
        # attempt restarts (gap between the last step of attempt N and
        # the first step of attempt N+1).
        self.train_runs: dict[str, dict] = {}
        # Per-deployment serve SLO ledger, folded from "serve:ingress"
        # SPAN events the same way train_runs folds "train:step":
        # request/error counts, sliding TTFT/latency windows, SLO
        # attainment over SERVE_SLO_WINDOW_S, and a burn-rate alert
        # (ray_tpu_serve_slo_alert) with an OFF→ON warn log. Keyed
        # "app/deployment".
        self.serve_runs: dict[str, dict] = {}
        # Controller autoscale reports ("app/deployment" → target/
        # desired/replicas/draining/reason/ts): the decisions the serve
        # control loop derived from this ledger, surfaced back through
        # serve_stats and the head-owned target-replicas gauge so they
        # survive controller restarts.
        self.serve_autoscale: dict[str, dict] = {}
        # Device-memory ledger, folded from "mem:sample" SPAN events
        # the same way the goodput/SLO ledgers fold theirs: per-node
        # current/peak used bytes, capacity, headroom alert state (with
        # OFF→ON warn log), and per-job peaks — surfaced via the
        # mem_stats RPC, /api/memory, and `ray_tpu_torch mem`.
        self.mem_nodes: dict[str, dict] = {}
        self.mem_jobs: dict[str, dict] = {}
        # Compiled-program profiler ledger, folded from rank-0
        # "profile:step" SPAN events: per-job latest MFU decomposition
        # (compute_floor/comm_in_program/hbm_bound/host_gap/
        # unattributed shares + dominant gap), surfaced next to the
        # goodput numbers. profile_fp holds the per-step-signature
        # baseline fingerprints the regression sentinel compares new
        # captures against — journaled, so a head restart cannot
        # forget what "normal" looked like.
        self.profile_runs: dict[str, dict] = {}
        self.profile_fp: dict[str, dict] = {}
        # Collective-group membership (the fault-tolerance layer's view):
        # group → {"epoch": int, "members": {rank: {addr, node_addr,
        # worker_id, dead}}}. Node/worker death fans out to survivors on
        # the "collective" pubsub channel so in-flight ops abort instead
        # of burning their full deadline.
        self.collective_members: dict[str, dict] = {}
        # node_id → partial-collective skips escalated by hubs
        # (collective_straggler_report): merged into the chronic-
        # straggler signal and — with COLLECTIVE_SKIP_DRAIN — acted on
        # directly via the drain path.
        self.chronic_skip_reports: dict[str, float] = {}
        # Slice fault domains: slice label → {"nodes": [node_id],
        # "state": healthy|draining|dead, "reason", "since"}. Membership
        # comes from node registrations (the "slice" label); state is
        # journaled like the drain table — a head restart must not
        # forget that a slice was mid-drain (its nodes' DRAINING
        # tombstones survive too, but the SLICE state is what stops the
        # escalation logic from re-firing and what operators see). Real
        # pods fail slice-at-a-time (a GKE maintenance event takes all
        # hosts of a slice atomically), so one host's preemption or
        # death drains the WHOLE slice and the autoscaler replaces the
        # slice as a unit.
        self.slices: dict[str, dict] = {}
        # Cluster-wide infeasible lease demand, deduped per waiting
        # request: requester id → (resources, ts). Each spill-waiting
        # request refreshes its single entry, so one pending lease reads
        # as ONE demand unit, and entries age out seconds after the
        # requester stops polling (granted or gave up).
        self.unschedulable: dict[str, tuple[dict, float]] = {}
        # Distributed checkpoint metadata (the shard store's authority):
        # run → step → {"world", "ranks": {rank: {"entries", "metrics",
        # "ts"}}, "complete_ts"}. A checkpoint EXISTS once every rank of
        # its world has committed — partial shard sets are invisible to
        # restore. Journaled (like the drain table) so replica state
        # survives a head restart.
        self.checkpoints: dict[str, dict[int, dict]] = {}
        # chunk hash → set of node addrs holding a replica.
        self.ckpt_locations: dict[str, set[str]] = {}
        # Sweep-engine table (the Tune orchestrator's durable state):
        # sweep_id → {"trials": {trial_id: {state, config, rung, job,
        # forked_from, node, ...}}, plus orchestrator-reported meta
        # (scheduler, num_samples, forks/preemptions counters, ts).
        # Journaled like the drain/slice tables — a head SIGKILL
        # mid-sweep must not forget which trials were stopped at a rung
        # or which manifest a fork descended from, or the restarted
        # orchestrator would re-run killed trials and double-count
        # population exploits.
        self.sweeps: dict[str, dict] = {}
        self._ckpt_repairing = False
        self._ckpt_last_repair = 0.0
        # Vectorized scheduling columns: per-resource-kind numpy views
        # over a stable node ordering, rebuilt on membership change and
        # updated in place on each resource sync. The label-free pick
        # (the hot path under actor/PG storms) scans these instead of
        # per-node Python dicts — profiled 50→100-node sublinearity was
        # dominated by that scan (PROFILE_r05.md). None = rebuild.
        # Drain/undrain/death flip an `eligible` mask in place (O(1))
        # instead of invalidating — a mass-drain storm interleaved with
        # picks was O(nodes²) in rebuilds.
        self._sched_cols: dict | None = None
        # --- control-plane overload protection ---
        # Admission classes on the dispatch path: control RPCs
        # (keepalive/register/sync/probes) execute immediately;
        # telemetry (add_task_events) enqueues here and a background
        # worker folds it, so a span flood can never starve liveness.
        # Bounded: under sustained overload the OLDEST events shed
        # (freshest telemetry wins) with ray_tpu_head_shed_total
        # counting and an OFF→ON overload alert.
        self._fold_queue: collections.deque = collections.deque()
        self._fold_wakeup = asyncio.Event()
        self._fold_task: asyncio.Task | None = None
        self._shed_total = 0
        self._folded_total = 0
        self._overload_alert = False
        # Pubsub coalescing: publishes buffer per channel and flush once
        # per event-loop tick (or per _pub_batch section), so a
        # correlated-failure storm costs O(subscribers) PUSH frames
        # instead of O(events × subscribers).
        self._pub_pending: dict[str, list] = {}
        self._pub_flush_scheduled = False
        self._pub_batch_depth = 0
        self._pub_msgs_total = 0    # logical messages published
        self._pub_pushes_total = 0  # PUSH frames actually sent
        # node_id → slice label reverse index: _slice_of was an
        # O(slices × nodes) scan and mass death makes it hot.
        self._slice_index: dict[str, str] = {}
        # Journal accounting (watermark-driven snapshot cadence +
        # the head_stats surface).
        self._journal_floor = 0
        self._compacting = False
        self._last_compaction_ts: float | None = None
        self._replayed_records = 0
        self._replay_s = 0.0
        self._started_ts = time.time()

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> str:
        if self.journal is not None:
            self._restore_from_journal()
        p = await self.server.start(host, port)
        self.addr = f"{host}:{p}"
        self._reaper = asyncio.ensure_future(self._health_loop())
        return self.addr

    # --------------------------------------------------------- journal
    def _journal_append(self, table: str, op: str, payload) -> None:
        if self.journal is None:
            return
        self.journal.append((table, op, payload))
        # Online compaction (reference: Redis AOF rewrite): KV churn on
        # a long-lived head must not grow the journal without bound.
        # The 2× floor guard keeps a state set LARGER than the
        # threshold from compacting on every append; the write itself
        # runs off-loop (compact_async) so RPC serving never stalls.
        from ray_tpu_torch._private import config

        size = self.journal.size_bytes
        floor = getattr(self, "_journal_floor", 0)
        due = (
            size > config.get("JOURNAL_COMPACT_BYTES")
            and size > 2 * floor
        )
        # Table-size watermark: when the snapshot itself is large (the
        # 1000-node regime), the 2× floor guard alone lets the replay
        # TAIL grow to `floor` bytes before compacting — restart replay
        # then costs snapshot + an equally large tail. Compacting once
        # the tail alone passes the watermark bounds replay depth
        # independently of table size.
        watermark = config.get("HEAD_SNAPSHOT_WATERMARK_BYTES")
        if watermark > 0 and size - floor > watermark:
            due = True
        if due and not getattr(self, "_compacting", False):
            self._compacting = True
            asyncio.ensure_future(self._compact_bg())

    async def _compact_bg(self) -> None:
        try:
            await self.journal.compact_async(self._snapshot())
        except Exception:  # noqa: BLE001 - keep serving (e.g. disk full)
            logger.warning("journal compaction failed", exc_info=True)
        finally:
            # Raise the floor EVEN ON FAILURE: the next attempt then
            # needs 2× further growth, so a persistently failing disk
            # doesn't re-trigger a full-snapshot pickle on every append.
            self._journal_floor = self.journal.size_bytes
            self._last_compaction_ts = time.time()
            self._compacting = False

    def _restore_from_journal(self) -> None:
        """Replay durable tables (KV, actors, PGs), then compact to one
        snapshot. Node/subscriber state is NOT persisted: nodes
        re-register through their reconnecting heartbeat (the
        NotifyGCSRestart equivalent) and re-dial their subscriptions."""
        t0 = time.monotonic()
        replayed = 0
        for table, op, payload in self.journal.replay():
            replayed += 1
            if table == "snapshot" and op == "set":
                self.kv = dict(payload["kv"])
                self.actors = {
                    aid: dict(a) for aid, a in payload["actors"].items()
                }
                self.named_actors = dict(payload["named_actors"])
                self.placement_groups = {
                    pid: dict(pg)
                    for pid, pg in payload["placement_groups"].items()
                }
                self.draining = {
                    nid: dict(d)
                    for nid, d in payload.get("draining", {}).items()
                }
                self.checkpoints = {
                    run: {int(s): dict(rec) for s, rec in steps.items()}
                    for run, steps in payload.get(
                        "checkpoints", {}
                    ).items()
                }
                self.ckpt_locations = {
                    h: set(addrs)
                    for h, addrs in payload.get(
                        "ckpt_locations", {}
                    ).items()
                }
                self.slices = {
                    sid: dict(rec)
                    for sid, rec in payload.get("slices", {}).items()
                }
                self.profile_fp = {
                    sig: dict(rec)
                    for sig, rec in payload.get(
                        "profile_fp", {}
                    ).items()
                }
                self.sweeps = {
                    sid: {
                        **{
                            k: v
                            for k, v in rec.items()
                            if k != "trials"
                        },
                        "trials": {
                            tid: dict(t)
                            for tid, t in rec.get(
                                "trials", {}
                            ).items()
                        },
                    }
                    for sid, rec in payload.get("sweeps", {}).items()
                }
            elif table == "sweep":
                if op == "put":
                    rec = self.sweeps.setdefault(
                        payload["sweep_id"], {"trials": {}}
                    )
                    fields = dict(payload["fields"])
                    fields.pop("trials", None)
                    rec.update(fields)
                elif op == "trial":
                    rec = self.sweeps.setdefault(
                        payload["sweep_id"], {"trials": {}}
                    )
                    rec["trials"].setdefault(
                        payload["trial_id"], {}
                    ).update(payload["fields"])
                else:
                    self.sweeps.pop(payload["sweep_id"], None)
            elif table == "profile":
                if op == "put":
                    self.profile_fp[payload["sig"]] = dict(
                        payload["fields"]
                    )
                else:
                    self.profile_fp.pop(payload["sig"], None)
            elif table == "slice":
                if op == "put":
                    self.slices[payload["slice_id"]] = dict(
                        payload["fields"]
                    )
                else:
                    self.slices.pop(payload["slice_id"], None)
            elif table == "ckpt":
                self._ckpt_replay(op, payload)
            elif table == "drain":
                if op == "put":
                    self.draining[payload["node_id"]] = dict(
                        payload["fields"]
                    )
                else:
                    self.draining.pop(payload["node_id"], None)
            elif table == "kv":
                if op == "put":
                    self.kv[payload["key"]] = payload["value"]
                else:
                    self.kv.pop(payload["key"], None)
            elif table == "actor":
                aid = payload["actor_id"]
                if op == "put":
                    self.actors[aid] = dict(payload["fields"])
                    name = payload["fields"].get("name")
                    if name:
                        self.named_actors[name] = aid
                elif op == "update" and aid in self.actors:
                    self.actors[aid].update(payload["fields"])
            elif table == "pg":
                if op == "put":
                    self.placement_groups[payload["pg_id"]] = dict(
                        payload["fields"]
                    )
                else:
                    self.placement_groups.pop(payload["pg_id"], None)
        self.journal.compact(self._snapshot())
        self._journal_floor = self.journal.size_bytes
        self._last_compaction_ts = time.time()
        self._replayed_records = replayed
        self._replay_s = time.monotonic() - t0
        # Restored slice membership repopulates the reverse index.
        self._slice_index = {
            nid: sid
            for sid, rec in self.slices.items()
            for nid in rec.get("nodes", ())
        }

    def _snapshot(self) -> dict:
        return {
            "kv": dict(self.kv),
            "actors": {
                aid: self._durable_actor(a)
                for aid, a in self.actors.items()
            },
            "named_actors": dict(self.named_actors),
            "placement_groups": {
                pid: dict(pg)
                for pid, pg in self.placement_groups.items()
            },
            "draining": {
                nid: dict(d) for nid, d in self.draining.items()
            },
            "checkpoints": {
                run: {s: dict(rec) for s, rec in steps.items()}
                for run, steps in self.checkpoints.items()
            },
            "ckpt_locations": {
                h: sorted(addrs)
                for h, addrs in self.ckpt_locations.items()
            },
            "slices": {
                sid: dict(rec) for sid, rec in self.slices.items()
            },
            "profile_fp": {
                sig: dict(rec)
                for sig, rec in self.profile_fp.items()
            },
            "sweeps": {
                sid: {
                    **{k: v for k, v in rec.items() if k != "trials"},
                    "trials": {
                        tid: dict(t)
                        for tid, t in rec.get("trials", {}).items()
                    },
                }
                for sid, rec in self.sweeps.items()
            },
        }

    @staticmethod
    def _durable_actor(actor: dict) -> dict:
        """Actor fields safe to pickle (no asyncio lock)."""
        return {k: v for k, v in actor.items() if k != "_restart_lock"}

    async def stop(self):
        if self._reaper:
            self._reaper.cancel()
        if self._fold_task:
            self._fold_task.cancel()
        await self.server.stop()
        if self.journal is not None:
            self.journal.close()

    # ------------------------------------------------------------ pubsub
    def publish(self, channel: str, msg: Any):
        """Queue one pubsub message. Delivery coalesces per channel per
        event-loop tick: N messages to a channel inside one tick reach
        each subscriber as ONE batched PUSH frame (subscribers unpack
        in order), so a 32-node slice death costs O(subscribers)
        frames, not O(nodes × subscribers)."""
        self._pub_msgs_total += 1
        if not self.subs.get(channel):
            return
        self._pub_pending.setdefault(channel, []).append(msg)
        if self._pub_flush_scheduled or self._pub_batch_depth > 0:
            return
        self._pub_flush_scheduled = True
        try:
            asyncio.get_running_loop().call_soon(self._flush_publishes)
        except RuntimeError:
            # No running loop (handlers driven directly in unit tests):
            # deliver inline.
            self._flush_publishes()

    def _pub_batch(self):
        """Context manager holding pubsub flushes open across an
        await-ful multi-node event (slice drain escalation, mass reap)
        so the whole storm coalesces even though the loop runs between
        its awaits."""
        import contextlib

        @contextlib.contextmanager
        def hold():
            self._pub_batch_depth += 1
            try:
                yield
            finally:
                self._pub_batch_depth -= 1
                if self._pub_batch_depth == 0 and self._pub_pending:
                    self._flush_publishes()

        return hold()

    def _flush_publishes(self) -> None:
        self._pub_flush_scheduled = False
        if self._pub_batch_depth > 0:
            return  # a batch section is open; it flushes on exit
        pending, self._pub_pending = self._pub_pending, {}
        for channel, msgs in pending.items():
            subs = list(self.subs.get(channel, ()))
            if not subs:
                continue
            if len(msgs) == 1:
                frame = {"channel": channel, "msg": msgs[0]}
            else:
                frame = {"channel": channel, "batch": msgs}
            for conn in subs:
                self._pub_pushes_total += 1
                conn.push(frame)

    # ----------------------------------------------------------- handler
    async def _handle(self, method: str, kw: dict, conn: rpc.Connection):
        from ray_tpu_torch._private.test_utils import head_stall_for

        stall = head_stall_for(method)
        if stall > 0:
            await asyncio.sleep(stall)
        fn = getattr(self, f"_on_{method}", None)
        if fn is None:
            raise rpc.RpcError(f"head: unknown method {method!r}")
        return await fn(conn=conn, **rpc.tolerant_kwargs(fn, kw))

    async def _on_register_node(
        self,
        conn,
        node_id: str,
        addr: str,
        resources: dict,
        available: dict | None = None,
        res_version: int = 0,
        labels=None,
        agent_addr=None,
    ):
        self.nodes[node_id] = {
            "addr": addr,
            "resources": dict(resources),
            # A RE-registration (head reconnect) carries the node's live
            # view; defaulting to full totals would over-schedule onto
            # leases the head just forgot about.
            "available": dict(available if available is not None else resources),
            "res_version": res_version,
            "labels": labels or {},
            "agent_addr": agent_addr,
            "last_seen": time.monotonic(),
            "conn": conn,
        }
        conn.state["node_id"] = node_id
        # A RE-registration (reconnect storm after a head restart)
        # updates the maintained columns in place; only a genuinely new
        # node or resource kind forces a rebuild — a 1000-node
        # registration herd with interleaved picks must not rebuild
        # O(nodes)-sized columns per register.
        cols = self._sched_cols
        if cols is not None:
            i = cols["idx"].get(node_id)
            node = self.nodes[node_id]
            kinds = set(node["resources"]) | set(node["available"])
            if i is not None and all(k in cols["total"] for k in kinds):
                for k in cols["total"]:
                    cols["total"][k][i] = float(
                        node["resources"].get(k, 0)
                    )
                    cols["avail"][k][i] = float(
                        node["available"].get(k, 0)
                    )
                cols["eligible"][i] = node_id not in self.draining
            else:
                self._sched_cols = None  # membership changed
        self._slice_register(node_id, labels or {})
        old = self._node_conns.pop(node_id, None)
        if old is not None:
            await old.close()
        self._node_conns[node_id] = await rpc.connect(addr)
        if node_id in self.draining:
            # A draining node re-registering (head restart, conn blip)
            # must come back DRAINING on both sides: re-push the flag so
            # its local lease path keeps refusing work.
            d = self.draining[node_id]
            asyncio.ensure_future(
                self._push_set_draining(node_id, d)
            )
        self.publish("node", {"event": "added", "node_id": node_id, "addr": addr})
        return {"ok": True}

    async def _push_set_draining(self, node_id: str, d: dict):
        conn = self._node_conns.get(node_id)
        if conn is None:
            return
        try:
            await conn.call(
                "set_draining",
                draining=True,
                reason=d.get("reason", ""),
                deadline_ts=d.get("deadline_ts"),
            )
        # tpulint: allow(broad-except reason=the node may be mid-death; the pubsub fan-out already carried the notice, this direct push is belt-and-suspenders)
        except Exception:
            pass

    async def _on_sync(
        self,
        conn,
        node_id: str,
        version: int,
        available: dict,
        pending: list | None = None,
    ):
        """Versioned resource-view update, pushed by nodes ON CHANGE
        (reference: ray_syncer.h:90 versioned component messages). A
        stale version (reordered across a reconnect) is ignored rather
        than rolling the view backwards."""
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "reregister": True}
        node["last_seen"] = time.monotonic()
        if version < node.get("res_version", -1):
            return {"ok": True, "stale": True}
        node["res_version"] = version
        node["available"] = available
        node["pending"] = pending or []
        # Draining nodes stay IN the columns behind the eligible mask
        # (drain/undrain flip one bit instead of invalidating), so
        # their syncs update in place like everyone else's.
        cols = self._sched_cols
        if cols is not None:
            i = cols["idx"].get(node_id)
            if i is None or any(k not in cols["avail"] for k in available):
                self._sched_cols = None  # new node/kind: full rebuild
            else:
                for k, col in cols["avail"].items():
                    col[i] = available.get(k, 0.0)
        return {"ok": True}

    async def _on_keepalive(self, conn, node_id: str):
        """Liveness-only tick for an unchanged resource view."""
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "reregister": True}
        node["last_seen"] = time.monotonic()
        return {"ok": True}

    async def _on_cluster_status(self, conn):
        """Autoscaler poll: per-node totals/available/pending demand
        (reference: GcsAutoscalerStateManager.GetClusterResourceState)."""
        self._expire_unschedulable()
        return {
            "unschedulable": [r for r, _ts in self.unschedulable.values()],
            "draining": {
                nid: dict(d) for nid, d in self.draining.items()
            },
            "slices": {
                sid: dict(rec) for sid, rec in self.slices.items()
            },
            # Serve control-plane state (controller autoscale reports):
            # rides the same poll so the cluster autoscaler sees replica
            # deficits next to the node demand that will absorb them.
            "serve_autoscale": {
                key: dict(rec)
                for key, rec in self.serve_autoscale.items()
            },
            "nodes": {
                nid: {
                    "addr": n["addr"],
                    "resources": n["resources"],
                    "available": n["available"],
                    "pending": n.get("pending", []),
                    "labels": n.get("labels", {}),
                }
                for nid, n in self.nodes.items()
            }
        }

    async def _on_node_table(self, conn):
        return {
            nid: {k: v for k, v in n.items() if k != "conn"}
            for nid, n in self.nodes.items()
        }

    async def _on_get_node(self, conn, node_id: str):
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "error": f"no node {node_id[:12]}…"}
        return {
            "ok": True,
            "node_id": node_id,
            "addr": node["addr"],
            "labels": node.get("labels", {}),
        }

    # ------------------------------------------------------ node drain
    async def _on_drain_node(
        self,
        conn,
        node_id: str,
        reason: str = "",
        deadline_s: float | None = None,
    ):
        """Move a node to DRAINING: excluded from every placement path
        (pick_node, placement groups, actor restarts) while its existing
        leases keep running, with the notice fanned out on pubsub so
        workers learn before the node dies. Idempotent — the first
        notice's deadline wins (a preemption clock does not restart)."""
        node = self.nodes.get(node_id)
        if node is None:
            return {"ok": False, "error": f"unknown node {node_id[:12]}…"}
        rec = self.draining.get(node_id)
        if rec is not None:
            return {"ok": True, "already": True, **rec}
        from ray_tpu_torch._private import config

        if deadline_s is None:
            deadline_s = config.get("DRAIN_DEADLINE_S")
        now = time.time()
        rec = self.draining[node_id] = {
            "reason": reason,
            "deadline_ts": now + float(deadline_s),
            "since": now,
        }
        self._journal_append(
            "drain", "put", {"node_id": node_id, "fields": dict(rec)}
        )
        self._sched_set_eligible(node_id, False)
        self.publish(
            "node",
            {
                "event": "draining",
                "node_id": node_id,
                "addr": node["addr"],
                "reason": reason,
                "deadline_ts": rec["deadline_ts"],
            },
        )
        # Reuse the death fan-out channel: every process watching for
        # collective member deaths learns about the drain with no extra
        # subscription — this is what gives train workers their
        # emergency-checkpoint window.
        self.publish(
            "collective",
            {
                "event": "node_draining",
                "node_id": node_id,
                "node_addr": node["addr"],
                "reason": reason,
                "deadline_s": float(deadline_s),
                "deadline_ts": rec["deadline_ts"],
            },
        )
        await self._push_set_draining(node_id, rec)
        # Drain-aware checkpoint evacuation: chunks whose only replicas
        # live on this node must re-replicate INSIDE the notice window.
        self._schedule_ckpt_repair()
        # Slice fault domain: one host draining means the slice is
        # going away — drain its siblings inside the same window.
        await self._maybe_drain_slice(node_id, reason, deadline_s)
        return {"ok": True, **rec}

    async def _on_undrain_node(self, conn, node_id: str):
        """Cancel a drain (maintenance event cleared, operator abort):
        the node rejoins the schedulable pool."""
        rec = self.draining.pop(node_id, None)
        if rec is None:
            return {"ok": False}
        self._journal_append("drain", "del", {"node_id": node_id})
        self._sched_set_eligible(node_id, True)
        node = self.nodes.get(node_id)
        addr = node["addr"] if node else None
        self.publish(
            "node",
            {"event": "undrained", "node_id": node_id, "addr": addr},
        )
        self.publish(
            "collective",
            {"event": "node_undrain", "node_id": node_id, "node_addr": addr},
        )
        conn_ = self._node_conns.get(node_id)
        if conn_ is not None:
            try:
                await conn_.call("set_draining", draining=False)
            # tpulint: allow(broad-except reason=node may be mid-death; the undrain event already fanned out on pubsub and the table is authoritative)
            except Exception:
                pass
        # Slice state follows its members: once the last draining member
        # of a DRAINING slice is undrained, the slice is healthy again
        # (maintenance event cleared for the whole unit).
        sid = self._slice_of(node_id)
        if sid is not None:
            srec = self.slices[sid]
            if srec["state"] == "draining" and not any(
                n in self.draining for n in srec["nodes"]
            ):
                srec["state"] = "healthy"
                srec["reason"] = ""
                self._slice_journal(sid)
        return {"ok": True}

    async def _on_drain_table(self, conn):
        return {
            "draining": {nid: dict(d) for nid, d in self.draining.items()}
        }

    # ---------------------------------------------- slice fault domains
    def _slice_journal(self, slice_id: str) -> None:
        rec = self.slices.get(slice_id)
        if rec is None:
            self._journal_append("slice", "del", {"slice_id": slice_id})
        else:
            self._journal_append(
                "slice", "put",
                {"slice_id": slice_id, "fields": dict(rec)},
            )

    def _slice_register(self, node_id: str, labels: dict) -> None:
        """Fold one node registration into the slice table. A node of a
        DEAD slice re-registering revives the slice (a replacement
        booted under the same label); a node of a DRAINING slice stays
        draining — its per-node tombstone is re-pushed by the caller."""
        slice_id = (labels or {}).get("slice")
        if not slice_id:
            return
        rec = self.slices.get(slice_id)
        if rec is None or rec.get("state") == "dead":
            rec = self.slices[slice_id] = {
                "nodes": [],
                "state": "healthy",
                "reason": "",
                "since": time.time(),
            }
        if node_id not in rec["nodes"]:
            rec["nodes"].append(node_id)
            self._slice_journal(slice_id)
        self._slice_index[node_id] = slice_id

    def _slice_of(self, node_id: str) -> str | None:
        # O(1) via the maintained reverse index (the full scan was
        # O(slices × nodes) and mass death makes this hot); the scan
        # below only runs to self-heal a stale miss.
        sid = self._slice_index.get(node_id)
        if sid is not None:
            rec = self.slices.get(sid)
            if rec is not None and node_id in rec["nodes"]:
                return sid
            self._slice_index.pop(node_id, None)
        for sid, rec in self.slices.items():
            if node_id in rec["nodes"]:
                self._slice_index[node_id] = sid
                return sid
        return None

    async def _maybe_drain_slice(
        self, node_id: str, reason: str, deadline_s: float | None = None
    ) -> None:
        """Whole-slice drain escalation: one host of a slice draining
        means the slice is going away (GCE maintenance and preemption
        reap slices atomically) — drain every sibling host NOW so their
        work migrates inside the same notice window, and mark the slice
        DRAINING so the autoscaler provisions one replacement slice,
        not a node at a time."""
        from ray_tpu_torch._private import config

        if not config.get("SLICE_FAULT_DOMAINS"):
            return
        slice_id = self._slice_of(node_id)
        if slice_id is None:
            return
        rec = self.slices[slice_id]
        if rec["state"] in ("draining", "dead"):
            return  # escalation already ran (or there is nothing left)
        rec["state"] = "draining"
        rec["reason"] = reason
        rec["since"] = time.time()
        self._slice_journal(slice_id)
        logger.warning(
            "slice %s: host %s is going away (%s); draining the whole "
            "slice (%d hosts)",
            slice_id, node_id[:12], reason, len(rec["nodes"]),
        )
        # One batch section for the whole escalation: the slice notice
        # plus every sibling's draining events reach each subscriber as
        # one coalesced PUSH per channel, not O(hosts × subscribers)
        # frames.
        with self._pub_batch():
            self.publish(
                "collective",
                {
                    "event": "slice_draining",
                    "slice_id": slice_id,
                    "nodes": list(rec["nodes"]),
                    "reason": reason,
                },
            )
            # The anchor node is included too when not already draining
            # (the death path escalates via a SURVIVING sibling as
            # anchor).
            for sibling in list(rec["nodes"]):
                if sibling in self.draining or sibling not in self.nodes:
                    continue
                await self._on_drain_node(
                    None,
                    node_id=sibling,
                    reason=f"slice {slice_id} fault domain: {reason}",
                    deadline_s=deadline_s,
                )

    def _slice_node_gone(self, node_id: str) -> tuple[str, dict] | None:
        """Drop a dead node from its slice's membership; returns the
        (slice_id, record) when the node belonged to one. A slice whose
        last host died is marked DEAD (kept for observability until a
        replacement registers under the label)."""
        slice_id = self._slice_of(node_id)
        if slice_id is None:
            return None
        rec = self.slices[slice_id]
        rec["nodes"].remove(node_id)
        self._slice_index.pop(node_id, None)
        if not rec["nodes"]:
            rec["state"] = "dead"
            rec["since"] = time.time()
        self._slice_journal(slice_id)
        return slice_id, rec

    async def _on_slice_table(self, conn):
        return {
            "slices": {
                sid: dict(rec) for sid, rec in self.slices.items()
            }
        }

    async def _on_collective_slice_report(
        self,
        conn,
        group: str,
        slice_id: str,
        skips: int = 0,
        window_s: float = 0.0,
    ):
        """The hierarchical allreduce escalated a chronically skipped
        SLICE: its DCN-hop skip rate crossed the sliding-window
        threshold. Resolve the slice (label match first, then
        positional index against the sorted table — the collective
        layer sees slice indices, not labels) and — unless
        COLLECTIVE_SKIP_DRAIN is off — drain the whole slice: the
        slice-level twin of collective_straggler_report."""
        from ray_tpu_torch._private import config

        sid = slice_id if slice_id in self.slices else None
        if sid is None:
            try:
                ordered = sorted(self.slices)
                idx = int(slice_id)
                if 0 <= idx < len(ordered):
                    sid = ordered[idx]
            except (TypeError, ValueError):
                sid = None
        if sid is None:
            return {
                "ok": False,
                "error": f"cannot resolve slice {slice_id!r} of group "
                         f"{group!r} to a registered slice",
            }
        logger.warning(
            "slice %s (group %r) was skipped by %d hierarchical "
            "DCN-partial collectives in %.0fs: chronic slice straggler",
            sid, group, int(skips), window_s,
        )
        drained = False
        rec = self.slices[sid]
        if (
            config.get("COLLECTIVE_SKIP_DRAIN")
            and rec["state"] == "healthy"
        ):
            anchor = next(
                (n for n in rec["nodes"] if n in self.nodes), None
            )
            if anchor is not None:
                reply = await self._on_drain_node(
                    conn,
                    node_id=anchor,
                    reason=(
                        f"chronic slice straggler: {int(skips)} DCN-"
                        f"partial skips in {window_s:.0f}s"
                    ),
                )
                drained = bool(reply.get("ok"))
        return {"ok": True, "slice_id": sid, "drained": drained}

    # ------------------------------------------- distributed checkpoints
    def _ckpt_replay(self, op: str, payload: dict) -> None:
        """Fold one journaled "ckpt" op back into the tables."""
        if op == "commit":
            self._ckpt_apply_commit(**payload)
        elif op == "loc":
            self.ckpt_locations.setdefault(
                payload["chunk"], set()
            ).update(payload["addrs"])
        elif op == "loc_many":
            for chunk in payload["chunks"]:
                self.ckpt_locations.setdefault(chunk, set()).add(
                    payload["addr"]
                )
        elif op == "loc_del":
            locs = self.ckpt_locations.get(payload["chunk"])
            if locs is not None:
                locs.difference_update(payload["addrs"])
                if not locs:
                    self.ckpt_locations.pop(payload["chunk"], None)
        elif op == "prune":
            steps = self.checkpoints.get(payload["run"])
            if steps is not None:
                steps.pop(payload["step"], None)
                if not steps:
                    self.checkpoints.pop(payload["run"], None)

    def _ckpt_apply_commit(
        self, run, step, rank, world, entries, metrics=None, ts=None,
        parity=None,
    ) -> bool:
        """Fold one rank's manifest; returns True when this commit
        COMPLETES the checkpoint (every rank of its world committed)."""
        steps = self.checkpoints.setdefault(run, {})
        rec = steps.setdefault(
            step, {"world": int(world), "ranks": {}, "complete_ts": None}
        )
        if rec["world"] != int(world):
            # A retry attempt re-saving the same step at a new world
            # size supersedes the old shape — stale ranks would make
            # completeness undecidable.
            rec["world"] = int(world)
            rec["ranks"] = {}
            rec["complete_ts"] = None
        rec["ranks"][int(rank)] = {
            "entries": list(entries),
            "parity": list(parity or ()),
            "metrics": dict(metrics or {}),
            "ts": ts if ts is not None else time.time(),
        }
        if rec["complete_ts"] is None and set(range(rec["world"])) <= set(
            rec["ranks"]
        ):
            rec["complete_ts"] = ts if ts is not None else time.time()
            return True
        return False

    async def _on_ckpt_commit(
        self,
        conn,
        run: str,
        step: int,
        rank: int,
        world: int,
        entries: list,
        locations: dict | None = None,
        metrics: dict | None = None,
        parity: list | None = None,
    ):
        """Commit one rank's shard manifest. The checkpoint becomes
        visible to restore only once all ranks commit — this is the
        consistency protocol: manifest commit = checkpoint exists."""
        now = time.time()
        completed = self._ckpt_apply_commit(
            run, int(step), int(rank), int(world), entries, metrics, now,
            parity,
        )
        self._journal_append(
            "ckpt",
            "commit",
            {
                "run": run,
                "step": int(step),
                "rank": int(rank),
                "world": int(world),
                "entries": list(entries),
                "parity": list(parity or ()),
                "metrics": dict(metrics or {}),
                "ts": now,
            },
        )
        for chunk, addrs in (locations or {}).items():
            known = self.ckpt_locations.setdefault(chunk, set())
            fresh = [a for a in addrs if a and a not in known]
            if fresh:
                known.update(fresh)
                self._journal_append(
                    "ckpt", "loc", {"chunk": chunk, "addrs": fresh}
                )
        if completed:
            self._ckpt_prune(run)
        rec = self.checkpoints[run][int(step)]
        return {
            "ok": True,
            "complete": rec["complete_ts"] is not None,
            "ranks": len(rec["ranks"]),
            "world": rec["world"],
        }

    async def _on_ckpt_fork(
        self, conn, run: str, new_run: str, step: int | None = None
    ):
        """Fork a complete checkpoint into a new run lineage by
        re-committing its per-rank manifests under ``new_run``. The
        chunk store is content-addressed, so a fork moves ZERO bulk
        bytes — both manifests reference the same chunk hashes and the
        replica/location tables already cover them. This is the PBT
        exploit primitive: copy the winner's manifest, perturb the
        hyperparameters, keep training."""
        from ray_tpu_torch.checkpoint.manifest import manifest_chunks

        steps = self.checkpoints.get(run) or {}
        if step is None:
            complete = [
                s for s, rec in steps.items()
                if rec["complete_ts"] is not None
            ]
            step = max(complete) if complete else None
        if step is None or int(step) not in steps:
            return {"ok": False, "error": f"no complete checkpoint for {run!r}"}
        src = steps[int(step)]
        if src["complete_ts"] is None:
            return {"ok": False, "error": f"{run!r} step {step} incomplete"}
        now = time.time()
        chunks: set[str] = set()
        completed = False
        for rank, r in src["ranks"].items():
            completed = self._ckpt_apply_commit(
                new_run, int(step), int(rank), src["world"],
                r["entries"], r["metrics"], now, r["parity"],
            ) or completed
            self._journal_append(
                "ckpt",
                "commit",
                {
                    "run": new_run,
                    "step": int(step),
                    "rank": int(rank),
                    "world": int(src["world"]),
                    "entries": list(r["entries"]),
                    "parity": list(r["parity"] or ()),
                    "metrics": dict(r["metrics"] or {}),
                    "ts": now,
                },
            )
            chunks |= manifest_chunks(r["entries"])
        if completed:
            self._ckpt_prune(new_run)
        return {
            "ok": True,
            "run": new_run,
            "step": int(step),
            "ranks": len(src["ranks"]),
            "chunks": len(chunks),
            # Content-addressed fork: the manifests are copied, the
            # chunks are not. Callers assert on this.
            "new_bytes": 0,
        }

    def _ckpt_referenced_chunks(self) -> set[str]:
        from ray_tpu_torch.checkpoint.manifest import manifest_chunks, parity_chunks

        out: set[str] = set()
        for steps in self.checkpoints.values():
            for rec in steps.values():
                for r in rec["ranks"].values():
                    out |= manifest_chunks(r["entries"])
                    # Parity chunks are referenced too: GC'ing them
                    # would silently strip the erasure protection.
                    out |= parity_chunks(r.get("parity"))
        return out

    def _ckpt_parity_index(self) -> dict[str, dict]:
        """chunk → its parity-group record across every retained
        manifest (the repair loop's reconstruction lookup)."""
        from ray_tpu_torch.checkpoint.manifest import parity_group_index

        out: dict[str, dict] = {}
        for steps in self.checkpoints.values():
            for rec in steps.values():
                for r in rec["ranks"].values():
                    for h, g in parity_group_index(r.get("parity")).items():
                        out.setdefault(h, g)
        return out

    async def _on_ckpt_locations_add(
        self, conn, addr: str, chunks: list[str]
    ):
        """Batched location report: a node that cached chunks it pulled
        (or reconstructed) during restore registers itself as a replica
        so peers can discover the copy and GC knows to collect it."""
        fresh = []
        for chunk in chunks:
            known = self.ckpt_locations.setdefault(chunk, set())
            if addr not in known:
                known.add(addr)
                fresh.append(chunk)
        if fresh:
            self._journal_append(
                "ckpt", "loc_many", {"addr": addr, "chunks": fresh}
            )
        return {"ok": True, "added": len(fresh)}

    def _ckpt_prune(self, run: str) -> None:
        """Retention: keep the newest CKPT_KEEP complete checkpoints per
        run; older manifests — and incomplete ones a newer complete
        checkpoint has obsoleted — prune, then their now-unreferenced
        chunks are collected off the holder nodes."""
        from ray_tpu_torch._private import config

        steps = self.checkpoints.get(run, {})
        complete = sorted(
            s for s, rec in steps.items() if rec["complete_ts"] is not None
        )
        if not complete:
            return
        keep = set(complete[-max(1, int(config.get("CKPT_KEEP"))):])
        newest = complete[-1]
        victims = [
            s
            for s, rec in steps.items()
            if s not in keep
            and (rec["complete_ts"] is not None or s < newest)
        ]
        if not victims:
            return
        from ray_tpu_torch.checkpoint.manifest import manifest_chunks

        from ray_tpu_torch.checkpoint.manifest import parity_chunks

        victim_chunks: set[str] = set()
        for s in victims:
            rec = steps.pop(s)
            for r in rec["ranks"].values():
                victim_chunks |= manifest_chunks(r["entries"])
                victim_chunks |= parity_chunks(r.get("parity"))
            self._journal_append(
                "ckpt", "prune", {"run": run, "step": s}
            )
        garbage = victim_chunks - self._ckpt_referenced_chunks()
        if garbage:
            asyncio.ensure_future(self._ckpt_gc(garbage))

    async def _ckpt_gc(self, chunks: set[str]) -> None:
        """Delete unreferenced chunks from their holder nodes (best
        effort — a missed delete is shm garbage, not corruption)."""
        by_addr: dict[str, list[str]] = {}
        for chunk in chunks:
            holders = self.ckpt_locations.pop(chunk, set())
            for addr in holders:
                by_addr.setdefault(addr, []).append(chunk)
            if holders:
                self._journal_append(
                    "ckpt",
                    "loc_del",
                    {"chunk": chunk, "addrs": sorted(holders)},
                )
        conn_by_addr = {
            n["addr"]: self._node_conns.get(nid)
            for nid, n in self.nodes.items()
        }
        for addr, oids in by_addr.items():
            conn = conn_by_addr.get(addr)
            if conn is None:
                continue
            try:
                await conn.call("delete_objects", oids=oids)
            except Exception as e:  # noqa: BLE001 - node mid-death:
                logger.debug(        # GC never blocks on a dying holder
                    "checkpoint GC on %s failed: %r", addr, e
                )

    async def _on_ckpt_list(self, conn, run: str | None = None):
        from ray_tpu_torch.checkpoint.manifest import entry_bytes, manifest_chunks

        out: dict[str, list] = {}
        for rname, steps in self.checkpoints.items():
            if run is not None and rname != run:
                continue
            rows = []
            for s in sorted(steps):
                rec = steps[s]
                chunks: set[str] = set()
                nbytes = 0
                n_groups = 0
                for r in rec["ranks"].values():
                    chunks |= manifest_chunks(r["entries"])
                    nbytes += sum(
                        entry_bytes(e) for e in r["entries"]
                    )
                    n_groups += len(r.get("parity") or ())
                replicas = [
                    len(self.ckpt_locations.get(h, ())) for h in chunks
                ]
                rows.append(
                    {
                        "step": s,
                        "world": rec["world"],
                        "ranks": sorted(rec["ranks"]),
                        "complete": rec["complete_ts"] is not None,
                        "ts": rec["complete_ts"],
                        "bytes": nbytes,
                        "chunks": len(chunks),
                        "min_replicas": min(replicas, default=0),
                        # Erasure durability at a glance: >0 parity
                        # groups means losses up to m per group decode
                        # instead of going to the repair/lost path.
                        "parity_groups": n_groups,
                    }
                )
            out[rname] = rows
        return {"ok": True, "runs": out}

    async def _on_ckpt_manifest(
        self, conn, run: str, step: int | None = None
    ):
        """Merged manifest of the newest complete checkpoint (or an
        exact complete step) plus current replica locations for every
        referenced chunk — everything restore needs in one call."""
        from ray_tpu_torch.checkpoint.manifest import manifest_chunks

        steps = self.checkpoints.get(run, {})
        candidates = sorted(
            s
            for s, rec in steps.items()
            if rec["complete_ts"] is not None
            and (step is None or s == int(step))
        )
        if not candidates:
            return {
                "ok": False,
                "error": f"no complete checkpoint for run {run!r}"
                + (f" step {step}" if step is not None else ""),
            }
        s = candidates[-1]
        rec = steps[s]
        entries: dict[str, dict] = {}
        for rank in sorted(rec["ranks"]):
            for e in rec["ranks"][rank]["entries"]:
                cur = entries.get(e["key"])
                if cur is None:
                    entries[e["key"]] = {
                        "key": e["key"],
                        "shape": list(e["shape"]),
                        "dtype": e["dtype"],
                        "shards": list(e["shards"]),
                    }
                else:
                    # Process-sharded leaf: every rank holds disjoint
                    # windows of the same key; restore stitches them.
                    cur["shards"].extend(e["shards"])
        parity: list = []
        for rank in sorted(rec["ranks"]):
            parity.extend(rec["ranks"][rank].get("parity") or ())
        chunks = manifest_chunks(entries)
        from ray_tpu_torch.checkpoint.manifest import parity_chunks

        chunks |= parity_chunks(parity)
        return {
            "ok": True,
            "run": run,
            "step": s,
            "world": rec["world"],
            "entries": entries,
            "parity": parity,
            "locations": {
                h: sorted(self.ckpt_locations.get(h, ()))
                for h in chunks
            },
        }

    async def _on_ckpt_verify(self, conn, run: str | None = None):
        """Probe every retained complete checkpoint's chunks on their
        recorded holders; report under-replicated and lost chunks (the
        `ray_tpu_torch ckpt verify` backend)."""
        from ray_tpu_torch._private import config
        from ray_tpu_torch.checkpoint.manifest import manifest_chunks

        want = int(config.get("CKPT_REPLICATION"))
        alive = {n["addr"]: nid for nid, n in self.nodes.items()}
        conn_by_addr = {
            n["addr"]: self._node_conns.get(nid)
            for nid, n in self.nodes.items()
        }
        addr_slice = {
            n["addr"]: (n.get("labels") or {}).get("slice")
            for n in self.nodes.values()
        }
        reports = []
        for rname, steps in self.checkpoints.items():
            if run is not None and rname != run:
                continue
            for s, rec in sorted(steps.items()):
                if rec["complete_ts"] is None:
                    continue
                from ray_tpu_torch.checkpoint.manifest import parity_chunks

                chunks: set[str] = set()
                groups: list[dict] = []
                for r in rec["ranks"].values():
                    chunks |= manifest_chunks(r["entries"])
                    groups.extend(r.get("parity") or ())
                    chunks |= parity_chunks(r.get("parity"))
                healthy_counts: dict[str, int] = {}
                healthy_holders: dict[str, list[str]] = {}
                for h in sorted(chunks):
                    n_ok = 0
                    holders: list[str] = []
                    for addr in self.ckpt_locations.get(h, ()):
                        node_conn = (
                            conn_by_addr.get(addr)
                            if addr in alive
                            else None
                        )
                        if node_conn is None:
                            continue
                        try:
                            meta = await node_conn.call(
                                "get_object_meta", oid_hex=h
                            )
                        except Exception as e:  # noqa: BLE001
                            logger.debug(  # dead holder = missing replica
                                "verify probe %s on %s: %r", h, addr, e
                            )
                            continue
                        if meta.get("ok"):
                            n_ok += 1
                            holders.append(addr)
                    healthy_counts[h] = n_ok
                    healthy_holders[h] = holders
                # Replica spread: two replicas of a chunk sharing a
                # slice are one preemption away from being one replica
                # — flag them so `ray_tpu_torch ckpt verify` warns before the
                # slice goes away, not after.
                colocated = []
                for h, holders in healthy_holders.items():
                    by_slice: dict[str, int] = {}
                    for addr in holders:
                        sl = addr_slice.get(addr)
                        if sl:
                            by_slice[sl] = by_slice.get(sl, 0) + 1
                    if any(v >= 2 for v in by_slice.values()):
                        colocated.append(h)
                # Erasure-group health: a group is intact while every
                # member has a healthy replica, degraded (but fully
                # reconstructable) while ≤m members are down, lost once
                # more than m are — degraded is the repair loop's work
                # queue, lost is the alarm.
                g_intact = g_degraded = g_lost = 0
                reconstructable: set[str] = set()
                for g in groups:
                    members = list(g.get("data", ())) + list(
                        g.get("parity", ())
                    )
                    m_tol = len(g.get("parity", ()))
                    down = [
                        h
                        for h in members
                        if healthy_counts.get(h, 0) == 0
                    ]
                    if not down:
                        g_intact += 1
                    elif len(down) <= m_tol:
                        g_degraded += 1
                        reconstructable.update(down)
                    else:
                        g_lost += 1
                target = min(want, max(1, len(alive)))
                reports.append(
                    {
                        "run": rname,
                        "step": s,
                        "chunks": len(chunks),
                        "replication_target": target,
                        "healthy": sum(
                            1
                            for v in healthy_counts.values()
                            if v >= target
                        ),
                        "under_replicated": sorted(
                            h
                            for h, v in healthy_counts.items()
                            if 0 < v < target
                        ),
                        "lost": sorted(
                            h
                            for h, v in healthy_counts.items()
                            if v == 0
                        ),
                        "reconstructable": sorted(reconstructable),
                        "groups": {
                            "intact": g_intact,
                            "degraded": g_degraded,
                            "lost": g_lost,
                        },
                        "colocated": sorted(colocated),
                    }
                )
        return {"ok": True, "checkpoints": reports}

    # ------------------------------------------------ checkpoint repair
    def _schedule_ckpt_repair(self) -> None:
        """Kick the repair pass (rate-limited, single-flight). Called
        from the health loop tick and eagerly on node death/drain."""
        from ray_tpu_torch._private import config

        if self._ckpt_repairing or not self.ckpt_locations or not self.nodes:
            return
        if (
            time.monotonic() - self._ckpt_last_repair
            < config.get("CKPT_REPAIR_INTERVAL_S")
        ):
            return
        self._ckpt_repairing = True
        asyncio.ensure_future(self._ckpt_repair_bg())

    async def _ckpt_repair_bg(self) -> None:
        try:
            await self._ckpt_repair()
        except Exception as e:  # noqa: BLE001 - repair must keep ticking
            logger.warning("checkpoint repair pass failed: %r", e)
        finally:
            self._ckpt_last_repair = time.monotonic()
            self._ckpt_repairing = False

    async def _ckpt_repair(self) -> None:
        """Re-replicate under-replicated checkpoint chunks.

        A holder is *live* while its node is registered and *healthy*
        while additionally not DRAINING — so a drain notice immediately
        makes chunks whose only replicas live on the draining node
        eligible for evacuation, before the node dies. Dead holders are
        only forgotten once a chunk is healthy again (never drop the
        last record of where data might still be).

        Target choice is SLICE-AWARE: a replica on the same slice as an
        existing holder dies with it (whole-slice preemption), so
        candidates on slices that do not already hold the chunk come
        first — whole-slice loss then never destroys every copy."""
        from ray_tpu_torch._private import config

        want = int(config.get("CKPT_REPLICATION"))
        alive = {n["addr"]: nid for nid, n in self.nodes.items()}
        draining_addrs = {
            self.nodes[nid]["addr"]
            for nid in self.draining
            if nid in self.nodes
        }
        addr_slice = {
            n["addr"]: (n.get("labels") or {}).get("slice")
            for n in self.nodes.values()
        }
        healthy_addrs = set(alive) - draining_addrs
        if not healthy_addrs:
            return
        referenced = self._ckpt_referenced_chunks()
        # (source, target) → chunks: one batched prefetch per pair.
        plan: dict[tuple[str, str], list[str]] = {}
        # Chunks with ZERO live replicas: unrecoverable by copying, but
        # an erasure group with ≥k surviving members can re-encode them.
        zero_replica: list[str] = []
        for chunk in referenced:
            locs = self.ckpt_locations.get(chunk)
            if not locs:
                zero_replica.append(chunk)
                continue
            live = locs & set(alive)
            healthy = live - draining_addrs
            target_n = min(want, len(healthy_addrs))
            if len(healthy) >= target_n:
                dead = locs - set(alive)
                if dead:
                    locs.difference_update(dead)
                    self._journal_append(
                        "ckpt",
                        "loc_del",
                        {"chunk": chunk, "addrs": sorted(dead)},
                    )
                continue
            sources = sorted(healthy) or sorted(live)
            if not sources:
                # Every replica gone: reconstruction is the only move.
                zero_replica.append(chunk)
                continue
            held_slices = {
                addr_slice.get(a) for a in live if addr_slice.get(a)
            }
            candidates = sorted(
                healthy_addrs - live,
                key=lambda a: (
                    addr_slice.get(a) is not None
                    and addr_slice[a] in held_slices,
                    a,
                ),
            )
            for tgt in candidates[: target_n - len(healthy)]:
                plan.setdefault((sources[0], tgt), []).append(chunk)
        for (src, tgt), chunks in plan.items():
            node_conn = self._node_conns.get(alive.get(tgt, ""))
            if node_conn is None:
                continue
            try:
                reply = await node_conn.call(
                    "prefetch_objects", oids=chunks, owner_addr=src
                )
            except Exception as e:  # noqa: BLE001 - target died
                logger.debug(        # mid-repair: next tick replans
                    "repair prefetch %s→%s failed: %r", src, tgt, e
                )
                continue
            results = reply.get("results", {})
            for chunk in chunks:
                if results.get(chunk):
                    self.ckpt_locations.setdefault(chunk, set()).add(tgt)
                    self._journal_append(
                        "ckpt", "loc", {"chunk": chunk, "addrs": [tgt]}
                    )
        if zero_replica:
            await self._ckpt_reconstruct_lost(
                zero_replica, alive, healthy_addrs
            )

    async def _ckpt_reconstruct_lost(
        self, chunks: list[str], alive: dict, healthy_addrs: set[str]
    ) -> None:
        """Erasure-aware repair: a chunk with zero live replicas is
        re-ENCODED on a healthy node from its parity group's survivors
        (k member pulls + a small GF solve) instead of being written
        off — the whole point of paying the m/k parity bytes."""
        group_of = self._ckpt_parity_index()
        for chunk in chunks:
            g = group_of.get(chunk)
            if g is None:
                continue  # no parity group: stays lost until a holder returns
            members = list(g.get("data", ())) + list(g.get("parity", ()))
            k = len(g.get("data", ()))
            rows = []
            for idx, mh in enumerate(members):
                if mh == chunk:
                    continue
                holders = sorted(
                    a
                    for a in self.ckpt_locations.get(mh, ())
                    if a in alive
                )
                if holders:
                    rows.append(
                        {"member": idx, "hash": mh, "addrs": holders}
                    )
            if len(rows) < k:
                logger.warning(
                    "ckpt chunk %s lost: only %d/%d group members "
                    "survive", chunk[:12], len(rows), k,
                )
                continue
            # Run the decode where the most survivors already live:
            # fewest cross-node member pulls.
            held: dict[str, int] = {}
            for r in rows:
                for a in r["addrs"]:
                    if a in healthy_addrs:
                        held[a] = held.get(a, 0) + 1
            tgt = max(
                sorted(healthy_addrs), key=lambda a: held.get(a, 0)
            )
            node_conn = self._node_conns.get(alive.get(tgt, ""))
            if node_conn is None:
                continue
            try:
                reply = await node_conn.call(
                    "ckpt_reconstruct",
                    chunk=chunk,
                    k=k,
                    m=len(g.get("parity", ())),
                    member=members.index(chunk),
                    rows=rows[: k + 2],
                    lens=g.get("lens"),
                )
            except Exception as e:  # noqa: BLE001 - target died
                logger.debug(        # mid-repair: next tick replans
                    "reconstruct %s on %s failed: %r", chunk[:12], tgt, e
                )
                continue
            if reply.get("ok"):
                self.ckpt_locations.setdefault(chunk, set()).add(tgt)
                self._journal_append(
                    "ckpt", "loc", {"chunk": chunk, "addrs": [tgt]}
                )
                logger.info(
                    "reconstructed lost ckpt chunk %s on %s from its "
                    "parity group", chunk[:12], tgt,
                )

    async def _on_pick_node(
        self,
        conn,
        resources: dict | None = None,
        requester: str | None = None,
        labels_hard: dict | None = None,
        labels_soft: dict | None = None,
    ):
        """Cluster-level placement: pick a feasible node for a lease.

        Reference analogue: the hybrid scheduling policy's feasibility +
        availability scoring (reference:
        src/ray/raylet/scheduling/policy/hybrid_scheduling_policy.h:25)
        plus the node-label policy (node_label_scheduling_policy);
        centralized here (GCS-style) rather than spilled raylet-to-raylet.
        """
        from ray_tpu_torch.util.scheduling_strategies import labels_match

        resources = resources or {}
        if not labels_hard and not labels_soft:
            # Hot path (actor/PG storms are label-free): one vectorized
            # scan over the maintained columns instead of per-node dict
            # work — the O(picks x nodes) Python constant was what bent
            # the 50→100-node curve sublinear (PROFILE_r05.md).
            best = self._pick_node_fast(resources)
            return self._pick_node_reply(best, resources, requester)
        # Hybrid policy (reference: hybrid_scheduling_policy.h:25-50):
        # skip infeasible, prefer nodes that can run NOW, rank by
        # post-placement utilization, then pick RANDOMLY among the top-k
        # so concurrent drivers don't herd onto one node.
        candidates: list[tuple[tuple, str]] = []
        for nid, node in self.nodes.items():
            if nid in self.draining:
                continue  # drained nodes take no new leases
            avail = node["available"]
            total = node["resources"]
            if any(total.get(k, 0) < v for k, v in resources.items()):
                continue  # infeasible
            if labels_hard and not labels_match(
                node.get("labels", {}), labels_hard
            ):
                continue
            soft_hits = (
                sum(
                    1
                    for k, want in (labels_soft or {}).items()
                    if labels_match(node.get("labels", {}), {k: want})
                )
                if labels_soft
                else 0
            )
            available_now = all(
                avail.get(k, 0) >= v for k, v in resources.items()
            )
            # Utilization AFTER placing this request: max over the
            # requested resource kinds (the reference's critical
            # resource), 0 when nothing specific is requested.
            util = max(
                (
                    (total[k] - avail.get(k, 0) + v) / total[k]
                    for k, v in resources.items()
                    if total.get(k, 0) > 0
                ),
                default=0.0,
            )
            candidates.append(
                ((not available_now, -soft_hits, util), nid)
            )
        best = None
        if candidates:
            import random

            candidates.sort(key=lambda c: c[0])
            top_k = candidates[: min(3, len(candidates))]
            # Only mix nodes of the SAME (availability, soft-label)
            # class: never pick a busy node while an idle one is in the
            # slice, and never trade a soft-label match for spread.
            top_k = [
                c for c in top_k if c[0][:2] == top_k[0][0][:2]
            ]
            best = random.choice(top_k)[1]
        return self._pick_node_reply(best, resources, requester)

    def _sched_columns(self) -> dict:
        """(Re)build the vectorized scheduling columns from self.nodes:
        a stable node list plus per-resource-kind total/available numpy
        arrays and an `eligible` mask. Only genuine membership growth
        (new node, new resource kind) invalidates; _on_sync writes
        values in place and drain/undrain/death flip eligibility bits
        (_sched_set_eligible) — O(1) per churn event, where the old
        rebuild-on-every-change made a mass-drain storm interleaved
        with picks O(nodes²)."""
        cols = self._sched_cols
        if cols is None:
            import numpy as np

            nids = list(self.nodes)
            kinds: set[str] = set()
            for nid in nids:
                kinds.update(self.nodes[nid]["resources"])
                kinds.update(self.nodes[nid]["available"])
            cols = self._sched_cols = {
                "nids": nids,
                "idx": {nid: i for i, nid in enumerate(nids)},
                "eligible": np.array(
                    [nid not in self.draining for nid in nids], bool
                ),
                "dead": 0,
                "total": {
                    k: np.array(
                        [
                            float(self.nodes[nid]["resources"].get(k, 0))
                            for nid in nids
                        ]
                    )
                    for k in kinds
                },
                "avail": {
                    k: np.array(
                        [
                            float(self.nodes[nid]["available"].get(k, 0))
                            for nid in nids
                        ]
                    )
                    for k in kinds
                },
            }
        return cols

    def _sched_set_eligible(self, node_id: str, eligible: bool) -> None:
        """O(1) schedulability flip on the maintained columns. Dead
        rows (removed nodes) stay masked-out in place; once they are
        the majority the next pick rebuilds compactly."""
        cols = self._sched_cols
        if cols is None:
            return
        i = cols["idx"].get(node_id)
        if i is None:
            if eligible:
                self._sched_cols = None  # unknown node joining the pool
            return
        cols["eligible"][i] = eligible

    def _sched_drop_node(self, node_id: str) -> None:
        """Mask a removed node out of the columns (O(1)); rebuild only
        when dead rows dominate."""
        cols = self._sched_cols
        if cols is None:
            return
        i = cols["idx"].get(node_id)
        if i is None:
            return
        cols["eligible"][i] = False
        cols["dead"] += 1
        if cols["dead"] * 2 > len(cols["nids"]):
            self._sched_cols = None

    def _pick_node_fast(self, resources: dict) -> str | None:
        """Label-free hybrid pick over the vectorized columns — same
        ranking as the general path (feasible → available-now class →
        post-placement utilization → random among the top-3 of the best
        class), with the per-node work done by numpy."""
        import random

        import numpy as np

        cols = self._sched_columns()
        n = len(cols["nids"])
        if n == 0:
            return None
        feasible = cols["eligible"].copy()
        avail_now = np.ones(n, bool)
        util = np.zeros(n)
        for k, v in resources.items():
            tot = cols["total"].get(k)
            if tot is None:
                if v > 0:
                    return None  # no node has this kind at all
                # Zero demand for an unknown kind constrains nothing
                # (matches the general path: total.get(k, 0) < 0 is
                # never true) — e.g. .options(num_tpus=0).
                continue
            av = cols["avail"][k]
            if v > 0:
                feasible &= tot >= v
                avail_now &= av >= v
            pos = tot > 0
            u = np.zeros(n)
            u[pos] = (tot[pos] - av[pos] + v) / tot[pos]
            util = np.maximum(util, u)
        idx = np.nonzero(feasible)[0]
        if idx.size == 0:
            return None
        # Lexicographic (not available_now, util) folded into one key:
        # util is bounded (~1 + v/min_total), far under the 1e9 class
        # separator.
        comp = (~avail_now[idx]).astype(np.float64) * 1e9 + util[idx]
        k3 = min(3, idx.size)
        part = np.argpartition(comp, k3 - 1)[:k3]
        top = idx[part[np.argsort(comp[part], kind="stable")]]
        best_class = avail_now[top[0]]
        same = [int(t) for t in top if avail_now[t] == best_class]
        return cols["nids"][random.choice(same)]

    def _pick_node_reply(
        self, best: str | None, resources: dict, requester: str | None
    ) -> dict:
        if best is None:
            # Record cluster-wide unschedulable demand: the autoscaler's
            # strongest scale-up signal (reference: pending demand in
            # GetClusterResourceState feeding v2/scheduler.py).
            if requester is not None:
                self.unschedulable[requester] = (
                    dict(resources), time.monotonic()
                )
                if len(self.unschedulable) > 10000:
                    self._expire_unschedulable()
            return {"ok": False, "error": "no feasible node"}
        if requester is not None:
            self.unschedulable.pop(requester, None)
        return {"ok": True, "node_id": best, "addr": self.nodes[best]["addr"]}

    def _expire_unschedulable(self, ttl: float = 5.0):
        now = time.monotonic()
        for key, (_r, ts) in list(self.unschedulable.items()):
            if now - ts > ttl:
                del self.unschedulable[key]

    # ------------------------------------------------------------- kv
    async def _on_kv_put(self, conn, key: str, value: bytes, overwrite=True):
        # overwrite=False callers MUST pass retry=False through their
        # ReconnectingClient: a blind re-send that observes its own
        # first write would report {ok: False, exists: True} to the
        # writer that actually won the race.
        if not overwrite and key in self.kv:
            return {"ok": False, "exists": True}
        self.kv[key] = value
        self._journal_append("kv", "put", {"key": key, "value": value})
        return {"ok": True}

    async def _on_kv_get(self, conn, key: str):
        return {"ok": key in self.kv, "value": self.kv.get(key)}

    async def _on_kv_del(self, conn, key: str):
        existed = self.kv.pop(key, None) is not None
        if existed:
            self._journal_append("kv", "del", {"key": key})
        return {"ok": existed}

    async def _on_kv_keys(self, conn, prefix: str = ""):
        return {"keys": [k for k in self.kv if k.startswith(prefix)]}

    # ----------------------------------------------------------- actors
    async def _on_register_actor(
        self,
        conn,
        actor_id: str,
        name: str | None,
        class_name: str,
        addr: str,
        node_id: str,
        detached: bool = False,
        restart_spec: dict | None = None,
    ):
        if name:
            existing = self.named_actors.get(name)
            if existing and self.actors[existing]["state"] != "DEAD":
                return {"ok": False, "error": f"actor name {name!r} taken"}
            self.named_actors[name] = actor_id
        self.actors[actor_id] = {
            "name": name,
            "state": "ALIVE",
            "addr": addr,
            "node_id": node_id,
            "class_name": class_name,
            "detached": detached,
            "restart_spec": restart_spec,
            "restarts_used": 0,
        }
        self._journal_append(
            "actor",
            "put",
            {
                "actor_id": actor_id,
                "fields": self._durable_actor(self.actors[actor_id]),
            },
        )
        self.publish("actor", {"event": "alive", "actor_id": actor_id})
        return {"ok": True}

    async def _on_restart_actor(self, conn, actor_id: str, failed_addr: str):
        """Caller-reported actor death → restart if budget remains
        (reference: GcsActorManager::RestartActor on worker-failure
        notice; callers resubmit per max_task_retries). Idempotent: all
        concurrent reporters get the single restart's outcome."""
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"ok": False, "state": "DEAD"}
        from ray_tpu_torch._private.sanitize import maybe_async_lock

        lock = actor.setdefault(
            "_restart_lock",
            maybe_async_lock(f"head.actor_restart.{actor_id}"))
        async with lock:
            if actor["state"] == "ALIVE" and actor["addr"] != failed_addr:
                # Another reporter already drove the restart.
                return {"ok": True, "state": "ALIVE", "addr": actor["addr"]}
            if actor["state"] == "DEAD":
                return {"ok": False, "state": "DEAD"}
            spec = actor.get("restart_spec") or {}
            budget = spec.get("max_restarts", 0)
            if budget != -1 and actor["restarts_used"] >= budget:
                actor["state"] = "DEAD"
                self._journal_append(
                    "actor",
                    "update",
                    {"actor_id": actor_id, "fields": {"state": "DEAD"}},
                )
                self.publish("actor", {"event": "dead", "actor_id": actor_id})
                return {"ok": False, "state": "DEAD"}
            actor["restarts_used"] += 1
            actor["state"] = "RESTARTING"
            self.publish(
                "actor", {"event": "restarting", "actor_id": actor_id}
            )
            try:
                addr = await self._recreate_actor(actor_id, actor, spec)
            # tpulint: allow(broad-except reason=not swallowed - the actor is journaled DEAD with the error published to watchers below)
            except Exception as e:
                actor["state"] = "DEAD"
                self._journal_append(
                    "actor",
                    "update",
                    {"actor_id": actor_id, "fields": {"state": "DEAD"}},
                )
                self.publish("actor", {"event": "dead", "actor_id": actor_id})
                return {"ok": False, "state": "DEAD", "error": repr(e)}
            if actor["state"] == "DEAD":
                # A kill landed while the restart was in flight: the kill
                # wins — tear down the instance we just created.
                await self._kill_worker_quietly(addr)
                return {"ok": False, "state": "DEAD"}
            actor.update(state="ALIVE", addr=addr)
            self._journal_append(
                "actor",
                "update",
                {
                    "actor_id": actor_id,
                    "fields": {
                        "state": "ALIVE",
                        "addr": addr,
                        "node_id": actor["node_id"],
                        "restarts_used": actor["restarts_used"],
                    },
                },
            )
            self.publish(
                "actor",
                {"event": "alive", "actor_id": actor_id, "addr": addr},
            )
            return {"ok": True, "state": "ALIVE", "addr": addr}

    async def _kill_worker_quietly(self, addr: str):
        try:
            conn = await rpc.connect(addr)
            try:
                await conn.call("exit_worker")
            finally:
                await conn.close()
        # tpulint: allow(broad-except reason=quiet kill of a superseded worker that may already be gone; success is not required, only attempted cleanup)
        except Exception:
            pass

    def _spawn_restart(self, actor_id: str, failed_addr: str) -> None:
        """Fire-and-forget restart attempt (node-death sweep); tracked so
        the task isn't GC'd. _on_restart_actor handles budget/DEAD."""
        task = asyncio.ensure_future(
            self._on_restart_actor(None, actor_id, failed_addr)
        )
        self._bg_restarts = getattr(self, "_bg_restarts", set())
        self._bg_restarts.add(task)
        task.add_done_callback(self._bg_restarts.discard)

    async def _recreate_actor(self, actor_id: str, actor: dict, spec: dict):
        """Lease a fresh worker and re-run the actor's constructor."""
        placement = spec.get("placement")
        if placement is not None:
            # PG-placed actor: restart on its reserved bundle so
            # co-location (and the bundle's accounting) stays intact.
            pg_id, index = placement[1], placement[2]
            pg = self.placement_groups.get(pg_id)
            if pg is None:
                raise rpc.RpcError(
                    f"placement group {pg_id} gone; cannot restart"
                )
            node_id = pg["nodes"][index]
            node_conn = self._node_conns.get(node_id)
            if node_conn is None:
                raise rpc.RpcError("bundle node is gone; cannot restart")
            lease = await node_conn.call(
                "lease_worker",
                resources=dict(spec["resources"]),
                actor=True,
                bundle=(pg_id, index),
                runtime_env=spec.get("runtime_env"),
            )
        else:
            sched = spec.get("scheduling") or {}
            affinity = sched.get("node_id")
            if affinity is not None and affinity in self.nodes:
                node_id = affinity
            elif affinity is not None and not sched.get("soft"):
                # Hard affinity to a node that no longer exists: the
                # actor must not silently move (core_worker would have
                # refused the first placement the same way).
                raise rpc.RpcError(
                    f"hard node affinity: node {affinity[:12]}… is gone"
                )
            else:
                pick = await self._on_pick_node(
                    None,
                    resources=spec["resources"],
                    labels_hard=sched.get("labels_hard"),
                    labels_soft=sched.get("labels_soft"),
                )
                if not pick.get("ok"):
                    raise rpc.RpcError(pick.get("error", "no feasible node"))
                node_id = pick["node_id"]
            node_conn = self._node_conns[node_id]
            lease = await node_conn.call(
                "lease_worker",
                resources=dict(spec["resources"]),
                actor=True,
                runtime_env=spec.get("runtime_env"),
            )
        if not lease.get("ok"):
            raise rpc.RpcError(lease.get("error", "restart lease failed"))
        try:
            worker_conn = await rpc.connect(lease["addr"])
            try:
                create = await worker_conn.call(
                    "create_actor",
                    actor_id=actor_id,
                    fn_id=spec["fn_id"],
                    args=spec["args"],
                    max_concurrency=spec.get("max_concurrency"),
                )
            finally:
                await worker_conn.close()
            if create.get("status") == "error":
                raise rpc.RpcError("actor constructor failed on restart")
        except Exception:
            # Give the lease (and its worker) back: a failed restart must
            # not strand cluster capacity.
            try:
                await node_conn.call(
                    "return_lease", lease_id=lease["lease_id"]
                )
            except rpc.RpcError:
                pass
            raise
        actor["node_id"] = node_id
        return lease["addr"]

    async def _on_update_actor(self, conn, actor_id: str, state: str):
        actor = self.actors.get(actor_id)
        if actor is None:
            return {"ok": False}
        actor["state"] = state
        self._journal_append(
            "actor", "update", {"actor_id": actor_id, "fields": {"state": state}}
        )
        self.publish("actor", {"event": state.lower(), "actor_id": actor_id})
        return {"ok": True}

    async def _on_get_actor(
        self, conn, name: str | None = None, actor_id: str | None = None
    ):
        if name is not None:
            actor_id = self.named_actors.get(name)
        if actor_id is None or actor_id not in self.actors:
            return {"ok": False, "error": "actor not found"}
        if self.actors[actor_id]["state"] == "DEAD":
            # A killed detached actor must not resolve by name: the
            # get-or-create pattern (serve's controller/proxy bootstrap)
            # would otherwise revive a handle to a corpse right after
            # shutdown (reference: ray.get_actor raises for dead
            # actors).
            return {"ok": False, "error": "actor not found (dead)"}
        return {
            "ok": True,
            "actor_id": actor_id,
            **self._public_actor(self.actors[actor_id]),
        }

    @staticmethod
    def _public_actor(actor: dict) -> dict:
        """Strip non-serializable / internal fields (restart lock, spec)."""
        return {
            k: v
            for k, v in actor.items()
            if k not in ("_restart_lock", "restart_spec")
        }

    async def _on_list_actors(self, conn):
        return {
            "actors": {
                aid: self._public_actor(a) for aid, a in self.actors.items()
            }
        }

    # ----------------------------------------------------------- pubsub
    async def _on_subscribe(self, conn, channel: str):
        self.subs.setdefault(channel, set()).add(conn)
        conn.state.setdefault("channels", []).append(channel)
        return {"ok": True}

    async def _on_publish(self, conn, channel: str, msg):
        # Worker-death reports from node reap loops double as collective
        # abort triggers: a SIGKILLed member on a LIVE node must poison
        # its groups without waiting for any op deadline.
        if (
            channel == "worker"
            and isinstance(msg, dict)
            and msg.get("event") == "died"
        ):
            self._collective_member_died(worker_id=msg.get("worker_id"))
        self.publish(channel, msg)
        return {"ok": True}

    # ------------------------------------------------ collective groups
    async def _on_collective_register(
        self,
        conn,
        group: str,
        rank: int,
        epoch: int = 0,
        addr: str | None = None,
        node_addr: str | None = None,
        worker_id: str | None = None,
    ):
        """Membership registration (reference: the NCCL group's named
        rendezvous actor, here head-owned so death detection can cross-
        reference the node table). A higher epoch — a reform — replaces
        the previous incarnation wholesale."""
        rec = self.collective_members.get(group)
        if rec is None or epoch > rec["epoch"]:
            rec = self.collective_members[group] = {
                "epoch": int(epoch),
                "members": {},
            }
        if epoch < rec["epoch"]:
            return {"ok": False, "stale": True}
        rec["members"][int(rank)] = {
            "addr": addr,
            "node_addr": node_addr,
            "worker_id": worker_id,
            "dead": False,
        }
        return {"ok": True}

    async def _on_collective_deregister(
        self, conn, group: str, epoch: int | None = None, rank=None
    ):
        rec = self.collective_members.get(group)
        if rec is None:
            return {"ok": False}
        if epoch is not None and rec["epoch"] != int(epoch):
            return {"ok": False, "stale": True}
        if rank is None:
            del self.collective_members[group]
        else:
            rec["members"].pop(int(rank), None)
            if not rec["members"]:
                del self.collective_members[group]
        return {"ok": True}

    def _collective_member_died(
        self,
        node_addr: str | None = None,
        worker_id: str | None = None,
    ):
        """Cross-reference a dead node/worker against every collective
        group and fan the member deaths out to the survivors."""
        for group, rec in self.collective_members.items():
            dead = []
            for r, m in rec["members"].items():
                if m.get("dead"):
                    continue
                if (node_addr is not None and m.get("node_addr") == node_addr) or (
                    worker_id is not None
                    and m.get("worker_id") == worker_id
                ):
                    m["dead"] = True
                    dead.append(r)
            if dead:
                self.publish(
                    "collective",
                    {
                        "event": "member_dead",
                        "group": group,
                        "epoch": rec["epoch"],
                        "ranks": sorted(dead),
                    },
                )

    async def _on_collective_straggler_stats(self, conn):
        """Straggler telemetry aggregated to NODES: sum the hub-reported
        collective_straggler_total series across worker snapshots and
        resolve each (group, rank) to its member's node through the
        membership table. This is the autoscaler's chronic-straggler
        signal — a node that is repeatedly the slowest (or missing)
        contributor is a replacement candidate before it becomes a
        timeout."""
        from ray_tpu_torch.util.metrics import parse_tag_str

        per_pair: dict[tuple[str, str], float] = {}
        for rec in self.metrics.values():
            m = rec["snap"].get("collective_straggler_total")
            if not m:
                continue
            for tag_str, val in m.get("series", {}).items():
                tags = parse_tag_str(tag_str)
                key = (tags.get("group", ""), tags.get("rank", ""))
                per_pair[key] = per_pair.get(key, 0.0) + float(val)
        nodes: dict[str, float] = {}
        groups: dict[str, dict] = {}
        addr_to_nid = {n["addr"]: nid for nid, n in self.nodes.items()}
        for (group, rank), val in per_pair.items():
            groups.setdefault(group, {})[rank] = val
            members = self.collective_members.get(group, {}).get(
                "members", {}
            )
            try:
                node_addr = members.get(int(rank), {}).get("node_addr")
            except (TypeError, ValueError):
                node_addr = None
            nid = addr_to_nid.get(node_addr) if node_addr else None
            if nid is not None:
                nodes[nid] = nodes.get(nid, 0.0) + val
        # Hub-escalated partial skips count too — they arrive ahead of
        # the metric-snapshot flush latency.
        for nid, val in self.chronic_skip_reports.items():
            nodes[nid] = max(nodes.get(nid, 0.0), float(val))
        return {"ok": True, "nodes": nodes, "groups": groups}

    async def _on_collective_straggler_report(
        self,
        conn,
        group: str,
        rank: int,
        skips: int = 0,
        window_s: float = 0.0,
    ):
        """A hub escalated a chronic partial-collective straggler: its
        skip rate crossed the sliding-window threshold. Resolve the rank
        to its node and — unless COLLECTIVE_SKIP_DRAIN is off — put the
        node on the same drain-and-replace path the autoscaler uses for
        chronic stragglers: DRAINING excludes it from new placements,
        the notice fans out, and the autoscaler provisions a
        replacement. A slow host becomes a bounded throughput dip that
        self-heals instead of a stall-then-collapse."""
        from ray_tpu_torch._private import config

        rec = self.collective_members.get(group)
        members = (rec or {}).get("members", {})
        node_addr = members.get(int(rank), {}).get("node_addr")
        nid = next(
            (
                i
                for i, n in self.nodes.items()
                if node_addr and n["addr"] == node_addr
            ),
            None,
        )
        if nid is None:
            return {"ok": False, "error": f"cannot resolve rank {rank} "
                                          f"of group {group!r} to a node"}
        self.chronic_skip_reports[nid] = max(
            self.chronic_skip_reports.get(nid, 0.0), float(skips)
        )
        logger.warning(
            "node %s (rank %d of collective group %r) was skipped by %d "
            "partial collectives in %.0fs: chronic straggler",
            nid[:12], int(rank), group, int(skips), window_s,
        )
        drained = False
        if config.get("COLLECTIVE_SKIP_DRAIN") and nid not in self.draining:
            reply = await self._on_drain_node(
                conn,
                node_id=nid,
                reason=(
                    f"chronic straggler: {int(skips)} partial-collective "
                    f"skips in {window_s:.0f}s"
                ),
            )
            drained = bool(reply.get("ok"))
        return {"ok": True, "node_id": nid, "drained": drained}

    async def _on_collective_probe(
        self, conn, group: str, ranks=None
    ):
        """Active member health check, fired by a group when an op
        deadline expires (reference: gcs_health_check_manager.h:45 active
        probes vs passive heartbeats). Confirms whether the silent ranks
        are actually dead — a dead NODE is removed from the cluster now
        (instead of aging out of HEALTH_TIMEOUT_S), a dead WORKER on a
        live node fans out member death; a merely-slow member is left
        alone."""
        rec = self.collective_members.get(group)
        if rec is None:
            return {"ok": False, "error": f"unknown group {group!r}"}
        members = rec["members"]
        targets = (
            [int(r) for r in ranks] if ranks is not None else list(members)
        )
        confirmed: list[int] = []
        for r in targets:
            m = members.get(r)
            if m is None or m.get("dead"):
                continue
            node_addr = m.get("node_addr")
            nid = next(
                (
                    i
                    for i, n in self.nodes.items()
                    if n["addr"] == node_addr
                ),
                None,
            )
            if node_addr and nid is None:
                # Node already gone from the table: the member died with it.
                self._collective_member_died(node_addr=node_addr)
                confirmed.append(r)
                continue
            node_conn = self._node_conns.get(nid) if nid else None
            if node_conn is not None:
                try:
                    reply = await node_conn.call("list_workers", timeout=2.0)
                # tpulint: allow(broad-except reason=any probe failure means the node is unreachable - acted on by removing the node, not swallowed)
                except Exception:
                    await self._remove_node(nid)
                    confirmed.append(r)
                    continue
                wid = m.get("worker_id")
                if wid is not None and wid not in {
                    w["worker_id"] for w in reply.get("workers", [])
                }:
                    self._collective_member_died(worker_id=wid)
                    confirmed.append(r)
        return {"ok": True, "dead_ranks": sorted(confirmed)}

    # -------------------------------------------------- placement groups
    async def _on_create_placement_group(
        self, conn, pg_id: str, bundles: list, strategy: str = "PACK"
    ):
        """Gang-reserve resource bundles (reference:
        GcsPlacementGroupManager gcs_placement_group_manager.h:50 with the
        2PC prepare/commit scheduler gcs_placement_group_scheduler.h:115;
        strategies python/ray/util/placement_group.py).

        The plan comes from the head's resource VIEW, which can lag a
        just-finished scheduling burst (sync is push-on-change); a node
        may therefore refuse its reservation at prepare time. Like the
        reference's scheduler, the refusal reschedules the group around
        the refusing node instead of failing the creation.
        """
        excluded: set[str] = set()
        last_error = "no nodes"
        for _attempt in range(4):
            plan = self._plan_placement(bundles, strategy, excluded)
            if not plan.get("ok"):
                return plan
            placed = plan["placed"]
            committed = []
            failing: str | None = None
            try:
                for (nid, i), bundle in zip(placed, bundles):
                    # Any failure against THIS node — an explicit
                    # refusal (stale view), a dropped conn, or a node
                    # that died after planning — reschedules around it;
                    # other nodes may still fit the group.
                    failing = nid
                    conn_ = self._node_conns.get(nid)
                    if conn_ is None:
                        raise rpc.RpcError(f"node {nid} has no conn")
                    reply = await conn_.call(
                        "reserve_bundle",
                        pg_id=pg_id,
                        index=i,
                        resources=bundle,
                    )
                    if not reply.get("ok"):
                        raise rpc.RpcError(
                            reply.get("error", "reserve failed")
                        )
                    failing = None
                    committed.append((nid, i))
            # tpulint: allow(broad-except reason=not swallowed - prepares are rolled back and the error is returned or retried with the failing node excluded)
            except Exception as e:
                for nid, i in committed:
                    # A node that died between reserve and rollback must
                    # not abort freeing the remaining nodes' bundles
                    # (its own reservations die with it), so: tolerate a
                    # missing conn and catch broadly — any per-node
                    # failure here is that node's problem, not the
                    # rollback's.
                    conn_ = self._node_conns.get(nid)
                    if conn_ is None:
                        continue
                    try:
                        await conn_.call(
                            "free_bundle", pg_id=pg_id, index=i
                        )
                    # tpulint: allow(broad-except reason=a node that died between reserve and rollback frees its own bundles by dying; the loop must keep freeing the others)
                    except Exception:
                        pass
                last_error = str(e)
                if failing is None:
                    return {"ok": False, "error": last_error}
                excluded.add(failing)
                continue
            self.placement_groups[pg_id] = {
                "bundles": bundles,
                "strategy": strategy,
                "nodes": [nid for nid, _ in placed],
            }
            self._journal_append(
                "pg",
                "put",
                {
                    "pg_id": pg_id,
                    "fields": dict(self.placement_groups[pg_id]),
                },
            )
            return {
                "ok": True,
                "nodes": [
                    {"node_id": nid, "addr": self.nodes[nid]["addr"]}
                    for nid, _ in placed
                ],
            }
        return {
            "ok": False,
            "error": f"placement retries exhausted: {last_error}",
        }

    def _plan_placement(
        self, bundles: list, strategy: str, excluded: set
    ) -> dict:
        """Pick a host node per bundle from the head's resource view.
        Returns {"ok": True, "placed": [(node_id, idx)]} or an error."""
        placed: list[tuple[str, int]] = []  # (node_id, bundle_idx)
        avail = {
            nid: dict(n["available"])
            for nid, n in self.nodes.items()
            if nid not in excluded and nid not in self.draining
        }

        def fits(nid, bundle):
            return all(avail[nid].get(k, 0) >= v for k, v in bundle.items())

        def take(nid, bundle):
            for k, v in bundle.items():
                avail[nid][k] = avail[nid].get(k, 0) - v

        node_ids = list(avail)
        if not node_ids:
            return {"ok": False, "error": "no nodes"}

        def fits_all(nid) -> bool:
            need: dict[str, float] = {}
            for b in bundles:
                for k, v in b.items():
                    need[k] = need.get(k, 0) + v
            return all(avail[nid].get(k, 0) >= v for k, v in need.items())

        if strategy == "STRICT_PACK":
            # All bundles on ONE node: try each node as the sole host.
            host = next((n for n in node_ids if fits_all(n)), None)
            if host is None:
                return {
                    "ok": False,
                    "error": "STRICT_PACK: no single node fits all bundles",
                }
            for i, bundle in enumerate(bundles):
                take(host, bundle)
                placed.append((host, i))
        else:
            used: set[str] = set()
            used_slices: set[str] = set()

            def slice_of(nid: str) -> str:
                # Unlabeled nodes are their own singleton fault domain.
                labels = self.nodes[nid].get("labels") or {}
                return labels.get("slice") or f"node:{nid}"

            for i, bundle in enumerate(bundles):
                if strategy == "PACK":
                    order = node_ids
                elif strategy == "STRICT_SPREAD":
                    # Each bundle on a DISTINCT node, or fail.
                    order = [n for n in node_ids if n not in used]
                elif strategy == "STRICT_SPREAD_SLICES":
                    # Each bundle on a DISTINCT SLICE, or fail: the
                    # cross-fault-domain gang (checkpoint replica
                    # holders, replicated services) — whole-slice loss
                    # then takes at most one bundle.
                    order = [
                        n for n in node_ids
                        if slice_of(n) not in used_slices
                    ]
                else:  # SPREAD: best-effort rotation
                    order = (
                        node_ids[i % len(node_ids) :]
                        + node_ids[: i % len(node_ids)]
                    )
                chosen = next((n for n in order if fits(n, bundle)), None)
                if chosen is None:
                    detail = ""
                    if strategy == "STRICT_SPREAD":
                        detail = (
                            " (STRICT_SPREAD needs a distinct node per "
                            "bundle)"
                        )
                    elif strategy == "STRICT_SPREAD_SLICES":
                        detail = (
                            " (STRICT_SPREAD_SLICES needs a distinct "
                            "slice per bundle)"
                        )
                    return {
                        "ok": False,
                        "error": f"bundle {i} {bundle} infeasible"
                        + detail,
                    }
                take(chosen, bundle)
                used.add(chosen)
                used_slices.add(slice_of(chosen))
                placed.append((chosen, i))
        return {"ok": True, "placed": placed}

    async def _on_remove_placement_group(self, conn, pg_id: str):
        pg = self.placement_groups.pop(pg_id, None)
        if pg is None:
            return {"ok": False}
        self._journal_append("pg", "del", {"pg_id": pg_id})
        for i, nid in enumerate(pg["nodes"]):
            node_conn = self._node_conns.get(nid)
            if node_conn is not None:
                try:
                    await node_conn.call("free_bundle", pg_id=pg_id, index=i)
                except rpc.RpcError:
                    pass
        return {"ok": True}

    async def _on_list_placement_groups(self, conn):
        return {
            "placement_groups": {
                pid: {k: v for k, v in pg.items()}
                for pid, pg in self.placement_groups.items()
            }
        }

    async def _on_get_placement_group(self, conn, pg_id: str):
        pg = self.placement_groups.get(pg_id)
        if pg is None:
            return {"ok": False}
        return {
            "ok": True,
            **pg,
            "node_addrs": [self.nodes[n]["addr"] for n in pg["nodes"]],
        }

    # ------------------------------------------------- task events/metrics
    _STATE_RANK = {
        "SUBMITTED": 0, "RUNNING": 1,
        "FINISHED": 2, "FAILED": 2, "CANCELLED": 2,
    }

    # Telemetry admission class: add_task_events only ENQUEUES (O(1)
    # amortized per event) and a background worker folds — a span flood
    # from 1000 nodes used to fold ledgers inline on the dispatch path,
    # monopolizing the loop and starving keepalives/registrations (the
    # control class). The queue is bounded: under sustained overload
    # the OLDEST events shed with an OFF→ON alert instead of unbounded
    # memory growth or latency collapse. The chunk is the fold loop's
    # scheduling quantum: control-RPC p99 under telemetry overload is
    # roughly a few chunks' worth of fold work, so it stays small.
    _FOLD_CHUNK = 64

    async def _on_add_task_events(self, conn, events: list):
        return self._enqueue_task_events(events)

    def _enqueue_task_events(self, events: list) -> dict:
        from ray_tpu_torch._private import config

        qmax = config.get("HEAD_FOLD_QUEUE_MAX")
        q = self._fold_queue
        if (qmax if qmax > 0 else None) != q.maxlen:
            # Bound change (config override mid-run): rebuild keeping
            # the newest records, same as the shed policy.
            q = self._fold_queue = collections.deque(
                q, maxlen=qmax if qmax > 0 else None
            )
        before = len(q)
        # A maxlen deque drops from the LEFT on append — the
        # oldest-first shed is a single C-speed extend, not a Python
        # pop-per-event loop (which itself became a head hotspot at
        # 100k+ events/s of sustained overload).
        q.extend(events)
        shed = (
            max(0, before + len(events) - qmax) if qmax > 0 else 0
        )
        if shed:
            self._shed_total += shed
            if not self._overload_alert:
                self._overload_alert = True
                logger.warning(
                    "head overload: telemetry fold queue hit its "
                    "HEAD_FOLD_QUEUE_MAX=%d bound; shedding oldest "
                    "events (ray_tpu_head_shed_total)", qmax,
                )
        self._fold_wakeup.set()
        if self._fold_task is None or self._fold_task.done():
            self._fold_task = asyncio.ensure_future(self._fold_loop())
        return {"ok": True, "queued": len(q), "shed": shed}

    async def _fold_loop(self):
        """Background telemetry folder: drains the bounded queue in
        chunks, yielding to the event loop between chunks so control
        RPCs interleave even under a sustained span flood."""
        from ray_tpu_torch._private.test_utils import head_stall_for

        while True:
            if not self._fold_queue:
                self._fold_wakeup.clear()
                if self._overload_alert:
                    # OFF transition: the backlog fully drained.
                    self._overload_alert = False
                    logger.info(
                        "head overload cleared: telemetry fold queue "
                        "drained (lifetime shed total %d)",
                        self._shed_total,
                    )
                await self._fold_wakeup.wait()
            stall = head_stall_for("fold")
            if stall > 0:
                await asyncio.sleep(stall)
            n = 0
            q = self._fold_queue
            while q and n < self._FOLD_CHUNK:
                self._fold_one(q.popleft())
                n += 1
            await asyncio.sleep(0)

    def _drain_folds(self) -> None:
        """Fold everything queued NOW. Read-your-writes for the state
        surfaces: a worker that flushed telemetry and then queries
        stats/events must see it folded, queue or no queue."""
        q = self._fold_queue
        while q:
            self._fold_one(q.popleft())

    def _fold_one(self, ev: dict) -> None:
        self._folded_total += 1
        self.task_events.append(ev)
        tid = ev.get("task_id")
        if ev.get("state") == "SPAN":
            # Spans live in the raw stream only, not the merged task
            # table (they would evict real task states). Rank-0 train
            # step spans additionally drive per-job goodput.
            if ev.get("name") == "train:step" and ev.get("train_job"):
                self._train_step_event(ev)
            # Ingress spans additionally drive the per-deployment
            # serve SLO ledger.
            elif (
                ev.get("name") == "serve:ingress"
                and ev.get("deployment")
            ):
                self._serve_request_event(ev)
            # Per-node memory samples additionally drive the head
            # memory ledger.
            elif ev.get("name") == "mem:sample" and ev.get("mem_node"):
                self._mem_event(ev)
            # Capture reports additionally drive the MFU-decomposition
            # ledger and the profile regression sentinel.
            elif (
                ev.get("name") == "profile:step"
                and ev.get("train_job")
            ):
                self._profile_step_event(ev)
            return
        if tid:
            prev = self.task_latest.pop(tid, None)
            merged = dict(prev or {})
            # Events from different processes arrive out of order
            # (driver flushes FINISHED; the worker's RUNNING may land
            # later) — never let a terminal state regress.
            old_state = merged.get("state")
            merged.update(ev)
            if old_state is not None and self._STATE_RANK.get(
                ev.get("state"), 0
            ) < self._STATE_RANK.get(old_state, 0):
                merged["state"] = old_state
            self.task_latest[tid] = merged
            while len(self.task_latest) > 20000:
                self.task_latest.popitem(last=False)

    async def _on_list_task_events(
        self,
        conn,
        limit: int = 1000,
        raw: bool = False,
        state: str | None = None,
    ):
        """`state` filters BEFORE `limit` applies: a span query must not
        come back empty just because busy task traffic fills the
        newest-N window."""
        self._drain_folds()  # read-your-writes past the fold queue
        if raw:
            events = list(self.task_events)
            if state is not None:
                events = [e for e in events if e.get("state") == state]
            return {"events": events[-limit:]}
        items = list(self.task_latest.values())
        if state is not None:
            items = [e for e in items if e.get("state") == state]
        return {"events": items[-limit:]}

    # ------------------------------------------------- train goodput
    def _train_step_event(self, ev: dict) -> None:
        """Fold one rank-0 train-step span into the job's goodput
        ledger. Attempt boundaries (TrainContext.attempt) mark elastic
        restarts: the wall-clock hole between attempts is restart-lost
        time, including any partial step the dying attempt never
        finished."""
        if ev.get("train_rank") != 0:
            return
        job = str(ev["train_job"])
        rec = self.train_runs.get(job)
        if rec is None:
            if len(self.train_runs) >= 200:
                oldest = min(
                    self.train_runs, key=lambda j: self.train_runs[j]["first_ts"]
                )
                del self.train_runs[oldest]
            rec = self.train_runs[job] = {
                "attempt": -1,
                "attempts_seen": 0,
                "steps": 0,
                "productive_s": 0.0,
                "stall_s": 0.0,
                "degraded_s": 0.0,
                "restart_lost_s": 0.0,
                # comm-exposure attribution (rank 0's step spans):
                # collective seconds NOT hidden behind compute vs the
                # overlapped remainder, and the step-second denominator.
                "comm_exposed_s": 0.0,
                "comm_overlapped_s": 0.0,
                # Host-sync exposure (PR 13's sanitizer tracer): wall
                # seconds of block_until_ready/device_get inside the
                # compute phase — the host-side twin of comm_exposed_s.
                "host_sync_exposed_s": 0.0,
                "step_s": 0.0,
                "first_ts": float(ev.get("ts") or 0.0),
                "last_end_ts": None,
                "mfu": None,
                # Latest reported training loss (train:step span attr):
                # what the sweep engine's ledger-driven schedulers rank
                # trials by — no reporting path beyond the span fold.
                "loss": None,
                "phase_s": {},
                # sliding alert window: (step_end_ts, total_s, lost_s)
                "window": [],
                "alert": False,
            }
        try:
            attempt = int(ev.get("train_attempt") or 0)
            start = float(ev["ts"])
            dur = max(0.0, float(ev.get("dur") or 0.0))
        except (TypeError, ValueError):
            return
        if attempt < rec["attempt"]:
            return  # straggling flush from a superseded attempt
        gap = 0.0
        if attempt > rec["attempt"]:
            if rec["attempt"] >= 0 and rec["last_end_ts"] is not None:
                rec["restart_lost_s"] += max(
                    0.0, start - rec["last_end_ts"]
                )
            rec["attempt"] = attempt
            rec["attempts_seen"] += 1
        elif rec["last_end_ts"] is not None:
            # Same attempt: the hole between consecutive steps is stall.
            gap = max(0.0, start - rec["last_end_ts"])
            rec["stall_s"] += gap
        phases = ev.get("phases") or {}
        in_step_lost = 0.0
        for ph, s in phases.items():
            try:
                s = float(s)
            except (TypeError, ValueError):
                continue
            rec["phase_s"][ph] = rec["phase_s"].get(ph, 0.0) + s
            if ph in ("data_wait", "checkpoint"):
                in_step_lost += s
        in_step_lost = min(in_step_lost, dur)
        # Degraded: the fraction of this step a partial collective ran
        # without every rank's contribution — progress was made, but on
        # a thinner gradient; a category of its own so "slow because
        # skipping" never masquerades as productive OR as stall.
        try:
            dfrac = min(1.0, max(0.0, float(ev.get("degraded_frac") or 0.0)))
        except (TypeError, ValueError):
            dfrac = 0.0
        degraded = min(dfrac * dur, dur - in_step_lost)
        rec["steps"] += 1
        rec["productive_s"] += dur - in_step_lost - degraded
        rec["degraded_s"] += degraded
        rec["stall_s"] += in_step_lost
        rec["step_s"] += dur
        for key in (
            "comm_exposed_s", "comm_overlapped_s", "host_sync_exposed_s",
        ):
            try:
                rec[key] += max(0.0, float(ev.get(key) or 0.0))
            except (TypeError, ValueError):
                pass
        if isinstance(ev.get("mfu"), (int, float)):
            rec["mfu"] = float(ev["mfu"])
        if isinstance(ev.get("loss"), (int, float)):
            rec["loss"] = float(ev["loss"])
        rec["last_end_ts"] = max(rec["last_end_ts"] or 0.0, start + dur)
        self._goodput_alert_check(
            job, rec, start + dur, dur + gap, gap + in_step_lost + degraded
        )

    def _goodput_alert_check(
        self, job: str, rec: dict, end_ts: float, total_s: float,
        lost_s: float,
    ) -> None:
        """Per-phase goodput alerting: warn (log + gauge) when the lost
        fraction — inter-step stalls, data-wait/checkpoint phases, and
        the degraded partial-collective fraction — over the sliding
        window exceeds the configured ratio. Log fires on the OFF→ON
        transition only; the gauge tracks the current state."""
        from ray_tpu_torch._private import config

        window_s = config.get("TRAIN_GOODPUT_ALERT_WINDOW_S")
        ratio = config.get("TRAIN_GOODPUT_ALERT_RATIO")
        rec["window"].append((end_ts, total_s, lost_s))
        cutoff = end_ts - window_s
        rec["window"] = [w for w in rec["window"] if w[0] >= cutoff]
        total = sum(w[1] for w in rec["window"])
        lost = sum(w[2] for w in rec["window"])
        alert = total > 0 and lost / total > ratio
        if alert and not rec["alert"]:
            logger.warning(
                "train job %r: %.0f%% of the last %.0fs was lost to "
                "stalls/degraded collectives (alert ratio %.0f%%)",
                job, 100.0 * lost / total, window_s, 100.0 * ratio,
            )
        rec["alert"] = alert

    @staticmethod
    def _train_job_public(rec: dict) -> dict:
        denom = (
            rec["productive_s"] + rec["stall_s"] + rec["degraded_s"]
            + rec["restart_lost_s"]
        )
        step_s = rec.get("step_s", 0.0)
        exposed = rec.get("comm_exposed_s", 0.0)
        return {
            "goodput": rec["productive_s"] / denom if denom > 0 else 1.0,
            "productive_s": rec["productive_s"],
            "stall_s": rec["stall_s"],
            "degraded_s": rec["degraded_s"],
            "restart_lost_s": rec["restart_lost_s"],
            "comm_exposed_s": exposed,
            "comm_overlapped_s": rec.get("comm_overlapped_s", 0.0),
            "comm_exposed_ratio": (
                exposed / step_s if step_s > 0 else 0.0
            ),
            "host_sync_exposed_s": rec.get("host_sync_exposed_s", 0.0),
            "host_sync_exposed_ratio": (
                rec.get("host_sync_exposed_s", 0.0) / step_s
                if step_s > 0 else 0.0
            ),
            "steps": rec["steps"],
            "attempts": rec["attempts_seen"],
            "current_attempt": rec["attempt"],
            "mfu": rec["mfu"],
            "loss": rec.get("loss"),
            "phase_s": dict(rec["phase_s"]),
            "first_ts": rec["first_ts"],
            "last_ts": rec["last_end_ts"],
            "alert": rec["alert"],
        }

    async def _on_train_stats(self, conn):
        """Per-job goodput/MFU rollup (dashboard /api/train, agent
        passthrough, `ray_tpu_torch goodput`). The ONE fold path joining the
        goodput ledger with the profiler's in-program decomposition:
        a job with a capture report carries it under "profile"."""
        self._drain_folds()  # read-your-writes past the fold queue
        jobs = {}
        for job, rec in self.train_runs.items():
            pub = self._train_job_public(rec)
            prof = self.profile_runs.get(job)
            if prof is not None:
                pub["profile"] = self._profile_public(prof)
            jobs[job] = pub
        return {"jobs": jobs}

    # ------------------------------------- compiled-program profiler
    def _profile_step_event(self, ev: dict) -> None:
        """Fold one rank-0 ``profile:step`` span (train/profile.py's
        capture report) into the decomposition ledger and run the
        regression sentinel against the journaled fingerprint for the
        step signature. First sight of a signature RECORDS the
        fingerprint; later captures compare against it."""
        if ev.get("train_rank") != 0:
            return
        job = str(ev["train_job"])
        shares = ev.get("profile_shares")
        if not isinstance(shares, dict):
            return
        clean: dict[str, float] = {}
        for cat, v in shares.items():
            if isinstance(v, (int, float)):
                clean[str(cat)] = float(v)
        if not clean:
            return
        sig = str(ev.get("profile_sig") or job)
        try:
            step_s = float(ev.get("profile_step_s") or 0.0)
            steps = int(ev.get("profile_steps") or 0)
            ts = float(ev.get("ts") or 0.0)
        except (TypeError, ValueError):
            return
        rec = {
            "sig": sig,
            "shares": clean,
            "step_s": step_s,
            "steps": steps,
            "dominant_gap": str(ev.get("profile_dominant") or ""),
            "path": str(ev.get("path") or ""),
            "ts": ts,
            "alert": False,
            "drift": {},
        }
        baseline = self.profile_fp.get(sig)
        if baseline is None:
            fp = {
                "job": job,
                "shares": dict(clean),
                "step_s": step_s,
                "ts": ts,
            }
            self.profile_fp[sig] = fp
            self._journal_append(
                "profile", "put", {"sig": sig, "fields": fp}
            )
        else:
            self._profile_regression_check(job, rec, baseline)
        if job not in self.profile_runs and len(self.profile_runs) >= 200:
            oldest = min(
                self.profile_runs,
                key=lambda j: self.profile_runs[j]["ts"],
            )
            del self.profile_runs[oldest]
        self.profile_runs[job] = rec

    def _profile_regression_check(
        self, job: str, rec: dict, baseline: dict
    ) -> None:
        """Flag category shares that drifted past
        PROFILE_REGRESSION_PCT relative to the fingerprint. Shares
        under 2% on both sides are noise, not regressions; the
        denominator is floored at 2% so a tiny baseline can't turn
        rounding into an alert. Warn-log fires on the OFF→ON
        transition only; the gauge tracks current state."""
        from ray_tpu_torch._private import config

        pct = config.get("PROFILE_REGRESSION_PCT") / 100.0
        drift: dict[str, float] = {}
        cats = set(baseline.get("shares", {})) | set(rec["shares"])
        for cat in cats:
            base = float(baseline.get("shares", {}).get(cat, 0.0))
            cur = rec["shares"].get(cat, 0.0)
            if base < 0.02 and cur < 0.02:
                continue
            d = (cur - base) / max(base, 0.02)
            if abs(d) > pct:
                drift[cat] = round(d, 4)
        rec["drift"] = drift
        rec["alert"] = bool(drift)
        prev = self.profile_runs.get(job)
        if rec["alert"] and not (prev and prev.get("alert")):
            logger.warning(
                "train job %r: profile regression vs fingerprint %s — "
                "category share drift past %.0f%%: %s",
                job, rec["sig"], 100.0 * pct, drift,
            )

    @staticmethod
    def _profile_public(rec: dict) -> dict:
        return {
            "sig": rec["sig"],
            "shares": dict(rec["shares"]),
            "step_s": rec["step_s"],
            "steps": rec["steps"],
            "dominant_gap": rec["dominant_gap"],
            "drift": dict(rec["drift"]),
            "alert": rec["alert"],
            "path": rec["path"],
            "ts": rec["ts"],
        }

    async def _on_profile_stats(self, conn):
        """Per-job MFU decomposition + fingerprints (dashboard
        /api/profile, `ray_tpu_torch profile`)."""
        self._drain_folds()  # read-your-writes past the fold queue
        return {
            "jobs": {
                job: self._profile_public(rec)
                for job, rec in self.profile_runs.items()
            },
            "fingerprints": {
                sig: dict(rec)
                for sig, rec in self.profile_fp.items()
            },
        }

    async def _on_profile_capture(self, conn, steps: int | None = None):
        """Fan a capture request out to every rank: riders of the
        "collective" channel (the same fan-out that delivers member
        death and drain notices) arm their local per-step profiler
        hook; reports come back as ``profile:step`` spans on the
        ordinary telemetry pipeline."""
        msg = {"event": "profile_capture"}
        if steps is not None:
            msg["steps"] = int(steps)
        self.publish("collective", msg)
        return {"ok": True, "steps": steps}

    def _profile_metrics_snapshot(self) -> dict | None:
        """Head-owned profiler gauges in worker-snapshot format: the
        per-category MFU decomposition and the regression-sentinel
        alert, attributed to the head pseudo-worker like the goodput
        gauges."""
        if not self.profile_runs:
            return None
        from ray_tpu_torch.util.metrics import escape_label_value as _esc

        decomp: dict[str, float] = {}
        alert: dict[str, float] = {}
        for job, rec in self.profile_runs.items():
            jtag = f'job="{_esc(job)}"'
            for cat, share in rec["shares"].items():
                decomp[f'{jtag},category="{_esc(cat)}"'] = round(
                    share, 6
                )
            alert[jtag] = 1.0 if rec["alert"] else 0.0
        return {
            "ray_tpu_train_mfu_decomposition": {
                "kind": "gauge",
                "description": "share of the measured step wall per "
                               "profiler category (compute_floor/"
                               "comm_in_program/hbm_bound/host_gap/"
                               "unattributed), from the latest "
                               "compiled-program capture",
                "series": decomp,
                "boundaries": None,
            },
            "ray_tpu_profile_regression_alert": {
                "kind": "gauge",
                "description": "1 when a category's share drifted "
                               "past PROFILE_REGRESSION_PCT vs the "
                               "journaled fingerprint for the job's "
                               "step signature",
                "series": alert,
                "boundaries": None,
            },
        }

    # --------------------------------------------------- serve SLO ledger
    def _serve_request_event(self, ev: dict) -> None:
        """Fold one proxy ``serve:ingress`` span into the deployment's
        SLO ledger (the serving twin of _train_step_event). A request
        ATTAINS its SLO when it succeeded AND its TTFT is within
        SERVE_SLO_TTFT_S AND its end-to-end latency is within
        SERVE_SLO_LATENCY_S; attainment over the sliding window below
        SERVE_SLO_TARGET flips the burn-rate alert."""
        key = f'{ev.get("app") or "default"}/{ev["deployment"]}'
        rec = self.serve_runs.get(key)
        if rec is None:
            if len(self.serve_runs) >= 200:
                oldest = min(
                    self.serve_runs,
                    key=lambda k: self.serve_runs[k]["first_ts"],
                )
                del self.serve_runs[oldest]
            rec = self.serve_runs[key] = {
                "requests": 0,
                "errors": 0,
                "streamed": 0,
                "items": 0,
                "first_ts": float(ev.get("ts") or 0.0),
                "last_ts": None,
                # sliding window: (end_ts, latency_s, ttft_s, attained)
                "window": [],
                "alert": False,
            }
        try:
            start = float(ev["ts"])
            dur = max(0.0, float(ev.get("dur") or 0.0))
        except (TypeError, ValueError):
            return
        try:
            ttft = float(ev.get("ttft_s")) if ev.get("ttft_s") is not None \
                else dur
        except (TypeError, ValueError):
            ttft = dur
        try:
            status = int(ev.get("status") or 0)
        except (TypeError, ValueError):
            status = 0
        from ray_tpu_torch._private import config

        ok = status < 400
        attained = (
            ok
            and ttft <= config.get("SERVE_SLO_TTFT_S")
            and dur <= config.get("SERVE_SLO_LATENCY_S")
        )
        rec["requests"] += 1
        rec["errors"] += 0 if ok else 1
        rec["streamed"] += 1 if ev.get("streamed") else 0
        try:
            rec["items"] += int(ev.get("items") or 0)
        except (TypeError, ValueError):
            pass
        end_ts = start + dur
        rec["last_ts"] = max(rec["last_ts"] or 0.0, end_ts)
        window_s = config.get("SERVE_SLO_WINDOW_S")
        rec["window"].append((end_ts, dur, ttft, attained))
        cutoff = end_ts - window_s
        rec["window"] = [w for w in rec["window"] if w[0] >= cutoff]
        attain_frac = (
            sum(1 for w in rec["window"] if w[3]) / len(rec["window"])
            if rec["window"] else 1.0
        )
        alert = (
            bool(rec["window"])
            and attain_frac < config.get("SERVE_SLO_TARGET")
        )
        if alert and not rec["alert"]:
            logger.warning(
                "serve deployment %r: SLO attainment %.0f%% over the "
                "last %.0fs fell below the %.0f%% target "
                "(ttft<=%.2fs, latency<=%.2fs)",
                key, 100.0 * attain_frac, window_s,
                100.0 * config.get("SERVE_SLO_TARGET"),
                config.get("SERVE_SLO_TTFT_S"),
                config.get("SERVE_SLO_LATENCY_S"),
            )
        rec["alert"] = alert

    @staticmethod
    def _percentile(values: list[float], q: float) -> float | None:
        if not values:
            return None
        ordered = sorted(values)
        idx = min(len(ordered) - 1, int(q * (len(ordered) - 1) + 0.5))
        return ordered[idx]

    def _serve_deployment_public(self, key: str, rec: dict) -> dict:
        from ray_tpu_torch._private import config

        ttfts = [w[2] for w in rec["window"]]
        lats = [w[1] for w in rec["window"]]
        attained = sum(1 for w in rec["window"] if w[3])
        n = len(rec["window"])
        window_s = config.get("SERVE_SLO_WINDOW_S")
        return {
            "requests": rec["requests"],
            "errors": rec["errors"],
            "streamed": rec["streamed"],
            "items": rec["items"],
            "window_requests": n,
            # The autoscaler's rate signal: requests finishing per
            # second over the SLO window.
            "request_rate_per_s": (
                n / window_s if window_s > 0 else 0.0
            ),
            "ttft_p50_s": self._percentile(ttfts, 0.50),
            "ttft_p99_s": self._percentile(ttfts, 0.99),
            "latency_p50_s": self._percentile(lats, 0.50),
            "latency_p99_s": self._percentile(lats, 0.99),
            "attainment": attained / n if n else 1.0,
            "alert": rec["alert"],
            "first_ts": rec["first_ts"],
            "last_ts": rec["last_ts"],
            # The control loop's last word on this deployment (None
            # until a controller reports).
            "autoscale": self.serve_autoscale.get(key),
        }

    async def _on_serve_stats(self, conn):
        """Per-deployment serve SLO rollup (dashboard /api/serve, agent
        passthrough, `ray_tpu_torch slo`) — the ledger-read API the serve
        control loop polls for attainment/alert/request-rate, plus the
        autoscale decisions it reported back."""
        self._drain_folds()  # read-your-writes past the fold queue
        out = {
            key: self._serve_deployment_public(key, rec)
            for key, rec in self.serve_runs.items()
        }
        # Deployments that reported autoscale state but have no ledger
        # rows yet (no proxy traffic since boot) still surface their
        # targets — schema-complete, so /api/serve consumers see one
        # row shape.
        for key, asc in self.serve_autoscale.items():
            if key not in out:
                out[key] = {
                    "requests": 0, "errors": 0, "streamed": 0,
                    "items": 0, "window_requests": 0,
                    "request_rate_per_s": 0.0,
                    "ttft_p50_s": None, "ttft_p99_s": None,
                    "latency_p50_s": None, "latency_p99_s": None,
                    "attainment": 1.0, "alert": False,
                    "first_ts": None, "last_ts": None,
                    "autoscale": asc,
                }
        return {"deployments": out}

    async def _on_serve_autoscale_report(
        self,
        conn,
        app: str,
        deployment: str,
        target: int,
        replicas: int = 0,
        draining: int = 0,
        desired: "int | None" = None,
        reason: "str | None" = None,
    ):
        """Controller → head: one deployment's current autoscale state
        (target, live/draining replica counts, last decision). Folded
        into serve_stats and the ray_tpu_serve_target_replicas gauge."""
        key = f"{app or 'default'}/{deployment}"
        if key not in self.serve_autoscale and \
                len(self.serve_autoscale) >= 200:
            oldest = min(
                self.serve_autoscale,
                key=lambda k: self.serve_autoscale[k]["ts"],
            )
            del self.serve_autoscale[oldest]
        self.serve_autoscale[key] = {
            "target": int(target),
            "replicas": int(replicas),
            "draining": int(draining),
            "desired": desired if desired is None else int(desired),
            "reason": reason,
            "ts": time.time(),
        }
        return {"ok": True}

    # --------------------------------------------------- memory ledger
    def _mem_event(self, ev: dict) -> None:
        """Fold one ``mem:sample`` span into the per-node (and per-job)
        memory ledger — the memory twin of _train_step_event /
        _serve_request_event. Headroom below
        MEM_HEADROOM_ALERT_FRACTION of capacity flips the node's alert
        with an OFF→ON warn log."""
        node = str(ev["mem_node"])
        rec = self.mem_nodes.get(node)
        if rec is None:
            if len(self.mem_nodes) >= 500:
                oldest = min(
                    self.mem_nodes,
                    key=lambda n: self.mem_nodes[n]["first_ts"],
                )
                del self.mem_nodes[oldest]
            rec = self.mem_nodes[node] = {
                "used_bytes": 0,
                "peak_bytes": 0,
                "capacity_bytes": None,
                "headroom_bytes": None,
                "host_rss_bytes": None,
                "by_kind": {},
                "samples": 0,
                "alert": False,
                "first_ts": float(ev.get("ts") or 0.0),
                "last_ts": None,
            }
        try:
            used = int(ev.get("mem_used_bytes") or 0)
            peak = int(ev.get("mem_peak_bytes") or used)
        except (TypeError, ValueError):
            return
        cap = ev.get("mem_capacity_bytes")
        try:
            cap = int(cap) if cap is not None else None
        except (TypeError, ValueError):
            cap = None
        rec["used_bytes"] = used
        rec["peak_bytes"] = max(rec["peak_bytes"], peak)
        rec["capacity_bytes"] = cap
        rec["headroom_bytes"] = cap - used if cap is not None else None
        rss = ev.get("mem_host_rss_bytes")
        rec["host_rss_bytes"] = int(rss) if isinstance(rss, int) else None
        by_kind = ev.get("mem_by_kind")
        # Keep the last non-empty attribution: the emitter drops zero
        # kinds, so an idle sample's {} must not wipe what we know
        # about who owned the bytes.
        if isinstance(by_kind, dict) and by_kind:
            rec["by_kind"] = {
                str(k): int(v)
                for k, v in by_kind.items()
                if isinstance(v, (int, float))
            }
        rec["samples"] += 1
        rec["last_ts"] = float(ev.get("ts") or 0.0)
        from ray_tpu_torch._private import config

        frac = config.get("MEM_HEADROOM_ALERT_FRACTION")
        alert = bool(
            cap and rec["headroom_bytes"] is not None
            and rec["headroom_bytes"] < cap * frac
        )
        if alert and not rec["alert"]:
            top = sorted(
                rec["by_kind"].items(), key=lambda kv: -kv[1]
            )[:3]
            logger.warning(
                "node %s device memory headroom low: %.2f GiB free of "
                "%.2f GiB (alert below %.0f%%) — top kinds: %s",
                node, (rec["headroom_bytes"] or 0) / (1 << 30),
                cap / (1 << 30), 100.0 * frac,
                ", ".join(
                    f"{k}={v / (1 << 30):.2f}GiB" for k, v in top
                ) or "none registered",
            )
        rec["alert"] = alert
        job = ev.get("mem_job")
        if job:
            jrec = self.mem_jobs.get(str(job))
            if jrec is None:
                if len(self.mem_jobs) >= 200:
                    oldest = min(
                        self.mem_jobs,
                        key=lambda j: self.mem_jobs[j]["first_ts"],
                    )
                    del self.mem_jobs[oldest]
                jrec = self.mem_jobs[str(job)] = {
                    "peak_bytes": 0,
                    "used_bytes": 0,
                    "nodes": [],
                    "first_ts": float(ev.get("ts") or 0.0),
                    "last_ts": None,
                }
            jrec["peak_bytes"] = max(jrec["peak_bytes"], peak)
            jrec["used_bytes"] = used
            if node not in jrec["nodes"]:
                jrec["nodes"].append(node)
            jrec["last_ts"] = float(ev.get("ts") or 0.0)

    async def _on_mem_stats(self, conn):
        """Per-node and per-job memory rollup (dashboard /api/memory,
        agent passthrough, `ray_tpu_torch mem`)."""
        self._drain_folds()  # read-your-writes past the fold queue
        return {
            "nodes": {n: dict(rec) for n, rec in self.mem_nodes.items()},
            "jobs": {j: dict(rec) for j, rec in self.mem_jobs.items()},
        }

    def _mem_metrics_snapshot(self) -> dict | None:
        """Head-owned memory gauges in worker-snapshot format (the
        memory twin of _serve_metrics_snapshot): per-node used/peak/
        headroom-alert, surviving the workers they were sampled at."""
        if not self.mem_nodes:
            return None
        from ray_tpu_torch.util.metrics import escape_label_value as _esc

        used: dict[str, float] = {}
        peak: dict[str, float] = {}
        alert: dict[str, float] = {}
        for node, rec in self.mem_nodes.items():
            tag = f'node="{_esc(node)}"'
            used[tag] = float(rec["used_bytes"])
            peak[tag] = float(rec["peak_bytes"])
            alert[tag] = 1.0 if rec["alert"] else 0.0
        return {
            "ray_tpu_mem_node_used_bytes": {
                "kind": "gauge",
                "description": "device bytes in use at each node's "
                               "last memory sample",
                "series": used,
                "boundaries": None,
            },
            "ray_tpu_mem_node_peak_bytes": {
                "kind": "gauge",
                "description": "peak device bytes in use each node has "
                               "reported",
                "series": peak,
                "boundaries": None,
            },
            "ray_tpu_mem_headroom_alert": {
                "kind": "gauge",
                "description": "1 when a node's device headroom is "
                               "below MEM_HEADROOM_ALERT_FRACTION of "
                               "capacity",
                "series": alert,
                "boundaries": None,
            },
        }

    def _serve_metrics_snapshot(self) -> dict | None:
        """Head-owned serve SLO gauges in worker-snapshot format (the
        serving twin of _train_metrics_snapshot): attainment + alert per
        deployment, surviving the proxies they were measured at."""
        if not self.serve_runs and not self.serve_autoscale:
            return None
        from ray_tpu_torch.util.metrics import escape_label_value as _esc

        attain: dict[str, float] = {}
        alert: dict[str, float] = {}
        for key, rec in self.serve_runs.items():
            pub = self._serve_deployment_public(key, rec)
            tag = f'deployment="{_esc(key)}"'
            attain[tag] = round(pub["attainment"], 6)
            alert[tag] = 1.0 if rec["alert"] else 0.0
        target: dict[str, float] = {}
        for key, asc in self.serve_autoscale.items():
            target[f'deployment="{_esc(key)}"'] = float(asc["target"])
        out_extra = (
            {
                "ray_tpu_serve_target_replicas": {
                    "kind": "gauge",
                    "description": "controller-reported target replica "
                                   "count per deployment (the "
                                   "autoscaler's output)",
                    "series": target,
                    "boundaries": None,
                },
            }
            if target
            else {}
        )
        return {
            **out_extra,
            "ray_tpu_serve_slo_attainment": {
                "kind": "gauge",
                "description": "fraction of requests meeting their "
                               "TTFT/latency SLO over the sliding "
                               "window, per deployment",
                "series": attain,
                "boundaries": None,
            },
            "ray_tpu_serve_slo_alert": {
                "kind": "gauge",
                "description": "1 when a deployment's SLO attainment "
                               "over the window is below "
                               "SERVE_SLO_TARGET",
                "series": alert,
                "boundaries": None,
            },
        }

    def _train_metrics_snapshot(self) -> dict | None:
        """Head-owned train gauges in worker-snapshot format, merged
        into cluster_metrics under the pseudo-worker "head" — goodput
        survives the workers (and attempts) it is computed from."""
        if not self.train_runs:
            return None
        from ray_tpu_torch.util.metrics import escape_label_value as _esc

        gp: dict[str, float] = {}
        lost: dict[str, float] = {}
        degraded: dict[str, float] = {}
        alert: dict[str, float] = {}
        mfu: dict[str, float] = {}
        for job, rec in self.train_runs.items():
            pub = self._train_job_public(rec)
            tag = f'job="{_esc(job)}"'
            gp[tag] = round(pub["goodput"], 6)
            lost[tag] = round(rec["restart_lost_s"], 6)
            degraded[tag] = round(rec["degraded_s"], 6)
            alert[tag] = 1.0 if rec["alert"] else 0.0
            if rec["mfu"] is not None:
                mfu[tag] = rec["mfu"]
        out = {
            "ray_tpu_train_goodput_ratio": {
                "kind": "gauge",
                "description": "productive step time / (productive + "
                               "stalls + degraded + restart loss) per "
                               "train job",
                "series": gp,
                "boundaries": None,
            },
            "ray_tpu_train_restart_lost_seconds": {
                "kind": "gauge",
                "description": "wall time lost to elastic attempt "
                               "restarts per train job",
                "series": lost,
                "boundaries": None,
            },
            "ray_tpu_train_degraded_seconds": {
                "kind": "gauge",
                "description": "step time degraded by partial "
                               "collectives skipping straggler "
                               "contributions, per train job",
                "series": degraded,
                "boundaries": None,
            },
            "ray_tpu_train_goodput_alert": {
                "kind": "gauge",
                "description": "1 when the job's stall+degraded "
                               "fraction over the alert window exceeds "
                               "TRAIN_GOODPUT_ALERT_RATIO",
                "series": alert,
                "boundaries": None,
            },
        }
        if mfu:
            out["ray_tpu_train_mfu"] = {
                "kind": "gauge",
                "description": "model FLOPs utilization of this "
                               "worker's most recent step",
                "series": mfu,
                "boundaries": None,
            }
        return out

    # ------------------------------------------------------ sweep table
    async def _on_sweep_put(self, conn, sweep_id: str, fields: dict):
        """Upsert sweep-level orchestrator state (scheduler, sample
        count, fork/preemption counters, terminal status). Journaled:
        the sweep table is what a restarted head — or a restarted
        orchestrator reading sweep_stats — resumes from."""
        rec = self.sweeps.setdefault(sweep_id, {"trials": {}})
        clean = {k: v for k, v in dict(fields).items() if k != "trials"}
        rec.update(clean)
        self._journal_append(
            "sweep", "put", {"sweep_id": sweep_id, "fields": clean}
        )
        return {"ok": True}

    async def _on_sweep_trial(
        self, conn, sweep_id: str, trial_id: str, fields: dict
    ):
        """Upsert one trial's durable record (state transitions, rung
        promotions, fork lineage, migration target)."""
        rec = self.sweeps.setdefault(sweep_id, {"trials": {}})
        rec["trials"].setdefault(trial_id, {}).update(dict(fields))
        self._journal_append(
            "sweep",
            "trial",
            {
                "sweep_id": sweep_id,
                "trial_id": trial_id,
                "fields": dict(fields),
            },
        )
        return {"ok": True}

    async def _on_sweep_stats(self, conn, sweep_id: str | None = None):
        """Sweep table joined against the goodput ledger: each trial
        that names a train job gets that job's public ledger row
        (goodput, steps, restart_lost_s …) inlined, so the scheduler,
        dashboard /api/tune, and `ray_tpu_torch tune` read ONE surface."""
        self._drain_folds()  # read-your-writes past the fold queue
        out = {}
        items = (
            [(sweep_id, self.sweeps[sweep_id])]
            if sweep_id is not None and sweep_id in self.sweeps
            else list(self.sweeps.items())
        )
        for sid, rec in items:
            trials = {}
            for tid, t in rec.get("trials", {}).items():
                pub = dict(t)
                job = t.get("job")
                run = self.train_runs.get(job) if job else None
                if run is not None:
                    pub["ledger"] = self._train_job_public(run)
                trials[tid] = pub
            out[sid] = {
                **{k: v for k, v in rec.items() if k != "trials"},
                "trials": trials,
            }
        return {"sweeps": out}

    def _tune_metrics_snapshot(self) -> dict | None:
        """Head-owned sweep gauges in worker-snapshot format (the tune
        twin of _train_metrics_snapshot): per-sweep trial-state counts
        plus fork/preemption counters, surviving the orchestrator that
        reported them."""
        if not self.sweeps:
            return None
        from ray_tpu_torch.util.metrics import escape_label_value as _esc

        running: dict[str, float] = {}
        done: dict[str, float] = {}
        errored: dict[str, float] = {}
        forks: dict[str, float] = {}
        preempt: dict[str, float] = {}
        for sid, rec in self.sweeps.items():
            tag = f'sweep="{_esc(sid)}"'
            states = [
                t.get("state") for t in rec.get("trials", {}).values()
            ]
            running[tag] = float(
                sum(1 for s in states if s in ("RUNNING", "PENDING"))
            )
            done[tag] = float(
                sum(1 for s in states if s == "TERMINATED")
            )
            errored[tag] = float(
                sum(1 for s in states if s == "ERROR")
            )
            forks[tag] = float(rec.get("forks", 0))
            preempt[tag] = float(rec.get("preemptions", 0))
        return {
            "ray_tpu_tune_trials_running": {
                "kind": "gauge",
                "description": "trials pending admission or running, "
                               "per sweep",
                "series": running,
                "boundaries": None,
            },
            "ray_tpu_tune_trials_terminated": {
                "kind": "gauge",
                "description": "trials finished or stopped at a rung "
                               "boundary, per sweep",
                "series": done,
                "boundaries": None,
            },
            "ray_tpu_tune_trials_errored": {
                "kind": "gauge",
                "description": "trials failed on a non-retryable "
                               "error, per sweep",
                "series": errored,
                "boundaries": None,
            },
            "ray_tpu_tune_forks_total": {
                "kind": "gauge",
                "description": "PBT checkpoint forks performed (each "
                               "a zero-byte manifest copy), per sweep",
                "series": forks,
                "boundaries": None,
            },
            "ray_tpu_tune_preemptions_total": {
                "kind": "gauge",
                "description": "trial preemptions/migrations absorbed "
                               "by re-admission, per sweep",
                "series": preempt,
                "boundaries": None,
            },
        }

    METRICS_TTL_S = 60.0

    async def _on_report_metrics(self, conn, worker: str, metrics: dict):
        self.metrics[worker] = {"ts": time.monotonic(), "snap": metrics}
        return {"ok": True}

    async def _on_cluster_metrics(self, conn):
        # Entries from workers that stopped reporting (exited job
        # drivers, dead workers) age out — otherwise the map grows with
        # every short-lived job and dead gauges report forever.
        now = time.monotonic()
        self._drain_folds()  # ledger gauges must reflect queued spans
        for w, rec in list(self.metrics.items()):
            if now - rec["ts"] > self.METRICS_TTL_S:
                del self.metrics[w]
        workers = {w: rec["snap"] for w, rec in self.metrics.items()}
        head_snap = dict(self._train_metrics_snapshot() or {})
        head_snap.update(self._serve_metrics_snapshot() or {})
        head_snap.update(self._mem_metrics_snapshot() or {})
        head_snap.update(self._profile_metrics_snapshot() or {})
        head_snap.update(self._tune_metrics_snapshot() or {})
        head_snap.update(self._head_metrics_snapshot())
        if head_snap:
            workers["head"] = head_snap
        return {"workers": workers}

    def _head_metrics_snapshot(self) -> dict:
        """Head-load gauges in worker-snapshot format: the overload-
        protection surface (shed counter + OFF→ON alert + queue depth)
        and pubsub coalescing counters, attributed to the head pseudo-
        worker like the ledger gauges above."""
        tag = 'node="head"'
        return {
            "ray_tpu_head_shed_total": {
                "kind": "gauge",
                "description": "telemetry events shed by the bounded "
                               "head fold queue (lifetime; >0 means "
                               "the head ran past HEAD_FOLD_QUEUE_MAX)",
                "series": {tag: float(self._shed_total)},
                "boundaries": None,
            },
            "ray_tpu_head_overload": {
                "kind": "gauge",
                "description": "1 while the head is shedding telemetry "
                               "(OFF→ON transition warn-logged; clears "
                               "when the fold queue drains)",
                "series": {tag: 1.0 if self._overload_alert else 0.0},
                "boundaries": None,
            },
            "ray_tpu_head_fold_queue_depth": {
                "kind": "gauge",
                "description": "telemetry events waiting in the head "
                               "fold queue",
                "series": {tag: float(len(self._fold_queue))},
                "boundaries": None,
            },
        }

    async def _on_head_stats(self, conn):
        """Control-plane load/health surface (`ray_tpu_torch head`, dashboard
        /api/head): admission/fold-queue state, shed counter, overload
        alert, pubsub coalescing counters, and journal size/compaction
        — the numbers BENCH_head.json pins and operators watch at
        scale."""
        from ray_tpu_torch._private import config

        journal = None
        if self.journal is not None:
            journal = {
                "path": self.journal.path,
                "size_bytes": self.journal.size_bytes,
                "floor_bytes": self._journal_floor,
                "compacting": bool(self._compacting),
                "last_compaction_ts": self._last_compaction_ts,
                "replayed_records": self._replayed_records,
                "replay_s": self._replay_s,
                "watermark_bytes": config.get(
                    "HEAD_SNAPSHOT_WATERMARK_BYTES"
                ),
            }
        return {
            "uptime_s": time.time() - self._started_ts,
            "nodes": len(self.nodes),
            "draining": len(self.draining),
            "slices": len(self.slices),
            "actors": len(self.actors),
            "subscriptions": {
                ch: len(s) for ch, s in self.subs.items() if s
            },
            "fold_queue_depth": len(self._fold_queue),
            "fold_queue_max": config.get("HEAD_FOLD_QUEUE_MAX"),
            "folded_total": self._folded_total,
            "shed_total": self._shed_total,
            "overload_alert": self._overload_alert,
            "pub_msgs_total": self._pub_msgs_total,
            "pub_pushes_total": self._pub_pushes_total,
            "journal": journal,
        }

    # ----------------------------------------------------------- health
    async def _remove_node(self, nid: str):
        """Declare a node dead: drop it from every table, fan collective
        member death out to surviving group members, and restart its
        actors within budget. Shared by the passive heartbeat reaper and
        the active collective probe."""
        node = self.nodes.pop(nid, None)
        if node is None:
            return
        if self.draining.pop(nid, None) is not None:
            # The drain completed in death; a journal replay must not
            # carry the tombstone forward.
            self._journal_append("drain", "del", {"node_id": nid})
        self._sched_drop_node(nid)
        conn = self._node_conns.pop(nid, None)
        if conn is not None:
            await conn.close()
        self.publish(
            "node",
            {"event": "removed", "node_id": nid, "addr": node["addr"]},
        )
        self._collective_member_died(node_addr=node["addr"])
        # Checkpoint chunks this node held are now under-replicated.
        self._schedule_ckpt_repair()
        # Slice fault domain: an UNEXPECTED member death implicates the
        # whole slice (preemption reaps hosts together; the stragglers
        # are seconds behind) — drain the siblings before they die with
        # work still on them. _slice_node_gone already moved the slice
        # to "dead" when this was the last host.
        gone = self._slice_node_gone(nid)
        if gone is not None:
            slice_id, rec = gone
            if rec["nodes"] and rec["state"] == "healthy":
                await self._maybe_drain_slice(
                    rec["nodes"][0],
                    f"slice {slice_id} host {nid[:12]}… died unexpectedly",
                )
        for aid, actor in self.actors.items():
            if actor["node_id"] == nid and actor["state"] == "ALIVE":
                # Node death goes through the same restart budget as
                # worker death (reference: actors on dead nodes are
                # rescheduled while max_restarts remains,
                # gcs_actor_manager).
                self._spawn_restart(aid, actor["addr"])

    async def _health_loop(self):
        """Mark nodes dead on heartbeat timeout (reference:
        gcs_health_check_manager.h:45 does active gRPC probes)."""
        from ray_tpu_torch._private import config

        while True:
            await asyncio.sleep(
                min(5.0, config.get("HEALTH_TIMEOUT_S") / 3)
            )
            now = time.monotonic()
            # One batch section per reap tick: a correlated failure
            # (whole slice, whole rack) that times out together fans
            # out as one coalesced PUSH per channel per subscriber.
            with self._pub_batch():
                for nid, node in list(self.nodes.items()):
                    if (
                        now - node["last_seen"]
                        > config.get("HEALTH_TIMEOUT_S")
                    ):
                        await self._remove_node(nid)
            self._schedule_ckpt_repair()
