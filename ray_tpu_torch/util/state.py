"""State API: inspect live cluster state (reference:
python/ray/util/state/api.py — `ray list tasks/actors/nodes/...` backed by
GCS task events and tables).

All calls query the head service through the driver's core worker.
"""

from __future__ import annotations

import json
from typing import Any

from ray_tpu_torch import api as core_api


def _call_head(method: str, **kw) -> dict:
    rt = core_api._runtime
    if rt.core is None:
        raise RuntimeError("ray_tpu_torch.init() has not been called")

    async def go():
        return await rt.core.head.call(method, **kw)

    return rt.run(go())


def list_worker_logs() -> list[dict]:
    """Every captured worker log across the cluster (reference:
    `ray logs` listing the session log dir via the per-node agents)."""
    rt = core_api._runtime

    async def fetch():
        from ray_tpu_torch._private import rpc as _rpc

        table = await rt.core.head.call("node_table")
        out = []
        for nid, n in table.items():
            # Per-node failures (dead host mid-listing, dial timeout)
            # skip that node — one unreachable node must not break the
            # cluster-wide listing.
            try:
                conn = await _rpc.connect(n["addr"])
                try:
                    reply = await conn.call("list_logs")
                finally:
                    await conn.close()
            except (_rpc.RpcError, OSError):
                continue
            for rec in reply.get("logs", []):
                out.append({**rec, "node_id": nid})
        return out

    return rt.run(fetch())


def read_worker_log(worker_prefix: str, tail_bytes: int = 0) -> str | None:
    """Log content of the first worker matching the prefix — dead
    workers included. None when no node has a matching log."""
    rt = core_api._runtime

    async def fetch():
        from ray_tpu_torch._private import rpc as _rpc

        table = await rt.core.head.call("node_table")
        for n in table.values():
            try:
                conn = await _rpc.connect(n["addr"])
                try:
                    reply = await conn.call(
                        "read_log",
                        worker_id=worker_prefix,
                        offset=-tail_bytes if tail_bytes else 0,
                    )
                finally:
                    await conn.close()
            except (_rpc.RpcError, OSError):
                continue
            if reply.get("ok"):
                data = reply["data"]
                return (
                    data.decode("utf-8", "replace")
                    if isinstance(data, bytes)
                    else data
                )
        return None

    return rt.run(fetch())


def list_nodes() -> list[dict]:
    table = _call_head("node_table")
    return [
        {
            "node_id": nid,
            "addr": n["addr"],
            "resources": n["resources"],
            "available": n["available"],
            "labels": n.get("labels", {}),
            "agent_addr": n.get("agent_addr"),
        }
        for nid, n in table.items()
    ]


def list_actors(state: str | None = None) -> list[dict]:
    actors = _call_head("list_actors")["actors"]
    out = [
        {"actor_id": aid, **info}
        for aid, info in actors.items()
        if state is None or info["state"] == state
    ]
    return out


def list_tasks(limit: int = 1000, state: str | None = None) -> list[dict]:
    # The state filter runs on the head BEFORE limit, so filtered kinds
    # aren't evicted from the newest-N window by other traffic.
    events = _call_head("list_task_events", limit=limit, state=state)[
        "events"
    ]
    if state is not None:
        events = [e for e in events if e.get("state") == state]
    return events


def list_placement_groups() -> list[dict]:
    pgs = _call_head("list_placement_groups")["placement_groups"]
    return [{"pg_id": pid, **pg} for pid, pg in pgs.items()]


def list_objects() -> list[dict]:
    """Objects in this node's shared-memory store."""
    rt = core_api._runtime
    store = rt.core.store
    out = []
    for oid_hex, size in store.list_objects():
        out.append({"object_id": oid_hex, "size_bytes": size})
    return out


def summarize_tasks() -> dict:
    counts: dict[str, int] = {}
    for ev in list_tasks(limit=20000):
        counts[ev.get("state", "?")] = counts.get(ev.get("state", "?"), 0) + 1
    return counts


def cluster_metrics() -> dict:
    """Merged user metrics across all workers."""
    from ray_tpu_torch.util import metrics as m

    workers = _call_head("cluster_metrics")["workers"]
    # Refresh this process's entry from the live registry (its periodic
    # flusher may lag); same key as the flusher uses so the local
    # snapshot replaces — never double-counts — the reported one.
    local = m.snapshot()
    if local:
        workers = {**workers, core_api._runtime.core.addr: local}
    return m.merge_snapshots(workers)


def prometheus_metrics() -> str:
    from ray_tpu_torch.util import metrics as m

    return m.prometheus_text(cluster_metrics())


def train_stats() -> dict:
    """Per-train-job goodput accounting from the head: productive step
    time vs. stalls (inter-step gaps, data wait, checkpointing) and
    elastic restart loss, plus MFU and phase breakdowns. Backs the
    dashboard's /api/train and the `ray_tpu_torch goodput` CLI."""
    return _call_head("train_stats")


def sweep_stats(sweep_id: str | None = None) -> dict:
    """Sweep-engine ledger from the head's journaled ``sweeps`` table:
    per-sweep trial states (gang admission → running → rung-stopped /
    forked / migrated), fork and preemption counters, and each trial's
    live train-job ledger row joined in. Backs the dashboard's
    /api/tune and the `ray_tpu_torch tune` CLI; survives head restart via
    journal replay."""
    return _call_head("sweep_stats", sweep_id=sweep_id)


def serve_stats() -> dict:
    """Per-deployment serve SLO ledger from the head: request/error
    counts, sliding-window TTFT/latency p50/p99, SLO attainment, and
    the burn-rate alert state. Backs the dashboard's /api/serve and the
    `ray_tpu_torch slo` CLI."""
    return _call_head("serve_stats")


def mem_stats() -> dict:
    """Device-memory ledger from the head: per-node current/peak used
    bytes, capacity, headroom alert state, and per-subsystem byte
    attribution, plus per-job peaks. Backs the dashboard's /api/memory
    and the `ray_tpu_torch mem` CLI."""
    return _call_head("mem_stats")


def profile_stats() -> dict:
    """Per-job compiled-program profile from the head: the latest MFU
    decomposition (category shares + dominant gap) and the journaled
    per-signature fingerprints the regression sentinel compares new
    captures against. Backs the dashboard's /api/profile and the
    `ray_tpu_torch profile` CLI."""
    return _call_head("profile_stats")


def profile_capture(steps: int | None = None) -> dict:
    """Ask the head to fan a compiled-program capture request out to
    every rank (collective-channel riders arm their per-step profiler
    hook; reports land in profile_stats after the next
    PROFILE_CAPTURE_STEPS steps)."""
    return _call_head("profile_capture", steps=steps)


def head_stats() -> dict:
    """Head control-plane load stats: telemetry fold-queue depth, shed
    counter, overload alert state, pubsub coalescing counters, and
    journal size/compaction. Backs the dashboard's /api/head and the
    `ray_tpu_torch head` CLI."""
    return _call_head("head_stats")


def list_checkpoints(run: str | None = None) -> dict:
    """In-cluster shard-store checkpoints per run (step, world,
    completeness, bytes, chunk count, min replica count). Backs the
    dashboard's /api/checkpoints and `ray_tpu_torch ckpt ls`."""
    return _call_head("ckpt_list", run=run)


def verify_checkpoints(run: str | None = None) -> dict:
    """Probe every retained checkpoint chunk on its recorded holders;
    reports under-replicated and lost chunks (`ray_tpu_torch ckpt verify`)."""
    return _call_head("ckpt_verify", run=run)


_SPAN_ARG_KEYS = (
    "trace_id", "span_id", "parent_id", "group", "verb", "backend",
    "bytes", "dtype", "bus_bytes_per_s", "train_job", "train_attempt",
    "train_rank", "train_step", "phases", "mfu",
    "comm_exposed_s", "comm_overlapped_s", "degraded_frac",
    # serve request-path spans: the ids/attrs that make one request's
    # span tree reconstructable from the chrome trace
    "app", "deployment", "route", "status", "ttft_s", "request_id",
    "streamed", "items", "tokens", "batch_size", "occupancy",
    "queue_s", "sample_rate",
    # compiled-program profiler spans (profile:step / profile:capture)
    "profile_sig", "profile_shares", "profile_step_s", "profile_steps",
    "profile_dominant", "path",
)


def timeline(path: str | None = None) -> list[dict] | str:
    """Chrome-trace export of task execution spans plus SPAN events —
    collective ops and train step phases render as slices alongside the
    tasks that issued them (reference: `ray timeline`, powered by
    GcsTaskManager events)."""
    events = _call_head("list_task_events", limit=20000, raw=True)["events"]
    trace = []
    for ev in events:
        if ev.get("state") == "SPAN" and "dur" in ev:
            trace.append(
                {
                    "ph": "X",
                    "name": ev.get("name") or "span",
                    "ts": ev["ts"] * 1e6,
                    "dur": ev["dur"] * 1e6,
                    "pid": ev.get("worker", "?"),
                    # Separate track per worker so span slices don't
                    # overlap the task slices they ran inside.
                    "tid": "spans",
                    "args": {
                        k: ev[k] for k in _SPAN_ARG_KEYS if k in ev
                    },
                }
            )
            continue
        if ev.get("state") != "RUNNING" or "dur" not in ev:
            continue
        trace.append(
            {
                "ph": "X",
                "name": ev.get("name") or ev.get("task_id", "")[:8],
                "ts": ev["ts"] * 1e6,
                "dur": ev["dur"] * 1e6,
                "pid": ev.get("worker", "?"),
                "tid": 0,
                "args": {"task_id": ev.get("task_id")},
            }
        )
    if path is None:
        return trace
    with open(path, "w") as f:
        json.dump(trace, f)
    return path
