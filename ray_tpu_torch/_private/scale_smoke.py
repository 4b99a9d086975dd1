"""Control-plane scale smoke: many nodes x many actors x many PGs on
one host (reference: release/benchmarks/distributed/test_many_actors.py
and test_many_pgs.py — the reference's scalability envelope is released
against 2,000 nodes / 40k actors; this smoke proves the head,
scheduler, resource sync, and journal at the largest scale one machine
supports).

Node daemons are REAL NodeManagers registering over real sockets;
workers use the documented ``WORKER_MODE=inproc`` simulation (see the
config knob) so a thousand actors cost kilobytes each instead of a
Python interpreter each — the control plane cannot tell the difference.

Run:  python -m ray_tpu_torch._private.scale_smoke --nodes 50 --actors 1000 --pgs 50
Emits one JSON row per measurement (name/value/unit).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import tempfile
import time


class ScaleActor:
    """Minimal control-plane load: schedulable, pingable, killable."""

    def __init__(self):
        self.n = 0

    def ping(self):
        self.n += 1
        return self.n


def run_scale_smoke(
    n_nodes: int = 50,
    n_actors: int = 1000,
    n_pgs: int = 50,
    journal_dir: str | None = None,
) -> list[dict]:
    os.environ["RAY_TPU_WORKER_MODE"] = "inproc"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")

    import ray_tpu_torch
    from ray_tpu_torch import api as core_api
    from ray_tpu_torch.placement import placement_group, remove_placement_group
    from ray_tpu_torch.runtime.node import NodeManager
    from ray_tpu_torch.util import state

    rows: list[dict] = []

    def row(name, value, unit):
        rows.append({"name": name, "value": round(value, 3), "unit": unit})

    sysconf = {}
    journal_path = None
    if journal_dir:
        journal_path = os.path.join(journal_dir, "scale_head.journal")
        sysconf["HEAD_JOURNAL"] = journal_path

    per_node_cpu = max(4.0, (n_actors / n_nodes) * 2)
    ray_tpu_torch.init(num_cpus=int(per_node_cpu), _system_config=sysconf)
    rt = core_api._runtime

    # ---- 1. node registration fan-in -------------------------------
    extra: list[NodeManager] = []
    t0 = time.monotonic()

    async def launch_nodes():
        for i in range(n_nodes - 1):
            node = NodeManager(
                rt.core.head_addr,
                rt.node.store_dir,
                resources={"CPU": per_node_cpu},
                labels={"scale-smoke": str(i)},
            )
            await node.start()
            extra.append(node)

    rt.run(launch_nodes(), timeout=600)
    while len(state.list_nodes()) < n_nodes:
        time.sleep(0.1)
    row(f"scale: register {n_nodes} nodes", time.monotonic() - t0, "s")

    # ---- 2. actor creation throughput + ready latency --------------
    # Creations fire CONCURRENTLY on the runtime loop (the reference's
    # many_actors benchmark is async the same way); create_actor
    # resolves once the actor instance is constructed on its worker,
    # so completion time IS ready latency.
    from ray_tpu_torch.api import ActorHandle

    t0 = time.monotonic()
    ready_at: list[float] = []

    async def create_one():
        actor_id, addr = await rt.core.create_actor(
            ScaleActor, (), {}, resources={"CPU": 0.5}
        )
        ready_at.append(time.monotonic() - t0)
        return ActorHandle(actor_id, addr, "ScaleActor")

    async def create_all():
        import asyncio

        return await asyncio.gather(
            *[create_one() for _ in range(n_actors)]
        )

    actors = rt.run(create_all(), timeout=900)
    total_ready = time.monotonic() - t0
    row(f"scale: {n_actors} actors ready", total_ready, "s")
    row("scale: actor ready throughput", n_actors / total_ready, "actors/s")
    row("scale: actor ready p50", statistics.median(ready_at), "s")
    row(
        "scale: actor ready p99",
        sorted(ready_at)[int(len(ready_at) * 0.99) - 1],
        "s",
    )

    # Scheduling spread: the hybrid policy must not pile every actor
    # on one node. Count against the CURRENT node table — an actor
    # attributed to a node the head transiently dropped during the
    # storm (keepalive starvation) must not inflate the metric.
    table = {n["node_id"] for n in state.list_nodes()}
    hosting = {
        a["node_id"]
        for a in state.list_actors()
        if a["state"] == "ALIVE" and a.get("node_id") in table
    }
    row("scale: nodes hosting actors", len(hosting), "nodes")

    # ---- 3. one call fan-out over every actor ----------------------
    t0 = time.monotonic()
    out = ray_tpu_torch.get([a.ping.remote() for a in actors], timeout=300)
    dt = time.monotonic() - t0
    assert all(v == 1 for v in out)
    row("scale: call fan-out all actors", n_actors / dt, "calls/s")

    # ---- 4. placement groups (2PC prepare/commit) ------------------
    t0 = time.monotonic()
    pgs = [
        placement_group([{"CPU": 0.5}, {"CPU": 0.5}], strategy="PACK")
        for _ in range(n_pgs)
    ]
    assert all(pg.ready() for pg in pgs)
    dt = time.monotonic() - t0
    row(f"scale: {n_pgs} PGs created+ready", dt, "s")
    row("scale: pg throughput", n_pgs / dt, "pgs/s")

    # ---- 5. churn: kill half the actors, create replacements -------
    t0 = time.monotonic()
    for a in actors[: n_actors // 2]:
        ray_tpu_torch.kill(a)

    async def recreate_all():
        import asyncio

        return await asyncio.gather(
            *[create_one() for _ in range(n_actors // 2)]
        )

    replacements = rt.run(recreate_all(), timeout=900)
    ray_tpu_torch.get([a.ping.remote() for a in replacements], timeout=300)
    row(
        "scale: churn half the actors",
        time.monotonic() - t0,
        "s",
    )

    # ---- 6. resource-view convergence after the storm --------------
    expected_used = (n_actors // 2 + len(replacements)) * 0.5 + n_pgs * 1.0
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60:
        nodes = state.list_nodes()
        used = sum(
            n["resources"].get("CPU", 0) - n["available"].get("CPU", 0)
            for n in nodes
        )
        if abs(used - expected_used) < 1.0:
            break
        time.sleep(0.2)
    row("scale: resource view convergence", time.monotonic() - t0, "s")

    # ---- 7. journal growth under churn -----------------------------
    if journal_path and os.path.exists(journal_path):
        row(
            "scale: head journal after churn",
            os.path.getsize(journal_path) / 1e6,
            "MB",
        )

    for pg in pgs:
        remove_placement_group(pg)

    async def stop_nodes():
        for node in extra:
            await node.stop()

    try:
        # Teardown is NOT a measurement: on a loaded host stopping
        # hundreds of simulated nodes can exceed any fixed budget —
        # never let it invalidate the rows already collected
        # (shutdown() below reaps whatever remains).
        rt.run(stop_nodes(), timeout=240)
    # tpulint: allow(broad-except reason=teardown of hundreds of simulated nodes is not a measurement; the incompleteness is printed and shutdown() reaps the rest)
    except Exception as e:  # noqa: BLE001 - best-effort teardown
        print(f"# teardown incomplete (ignored): {e!r}", flush=True)
    finally:
        ray_tpu_torch.shutdown()
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--nodes", type=int, default=50)
    ap.add_argument("--actors", type=int, default=1000)
    ap.add_argument("--pgs", type=int, default=50)
    # A directory of the run's own by default (under TMPDIR), so that two
    # heads on one machine never share and replay one journal.
    ap.add_argument("--journal-dir", default=None)
    args = ap.parse_args()
    if args.journal_dir is None:
        args.journal_dir = tempfile.mkdtemp(prefix="ray_tpu_scale_")
    os.makedirs(args.journal_dir, exist_ok=True)
    rows = run_scale_smoke(
        args.nodes, args.actors, args.pgs, journal_dir=args.journal_dir
    )
    for r in rows:
        print(json.dumps(r))


if __name__ == "__main__":
    main()
