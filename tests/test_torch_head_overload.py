"""Head overload protection & batched fan-out of the port's head (the
JAX package's tests/test_head_overload.py against ray_tpu_torch's
HeadService, CoreWorker, tqdm_ray and scale_sim.FakeNode): deterministic
tier-1 twins of the simulated-scale harness's legs.

Every leg of the simulated-1000-node bench has a small, deterministic
twin here: control-RPC admission under stalled telemetry
(RAY_TPU_HEAD_STALL), fold-queue shed with the OFF→ON→OFF overload
alert, coalesced pubsub fan-out, worker-side batch unpack, and the
incrementally-maintained pick_node eligibility index staying
consistent under drain/undrain/death churn.
"""

import asyncio
import os
import time

import pytest

from ray_tpu_torch._private import config as _config
from ray_tpu_torch._private import rpc


def _clear(*names):
    for n in names:
        _config._overrides.pop(n, None)
        os.environ.pop(f"RAY_TPU_{n}", None)


def _events(n, prefix="t"):
    return [
        {
            "task_id": f"{prefix}{i}",
            "name": "sim",
            "state": "FINISHED",
            "ts": time.time(),
            "dur": 0.01,
        }
        for i in range(n)
    ]


def test_control_rpc_not_starved_by_stalled_telemetry():
    """Admission classes: with every add_task_events RPC chaos-stalled
    500ms, a control RPC issued while eight of them are in flight (on
    the SAME connection) still answers immediately — telemetry never
    holds the dispatch path."""
    _config.set_system_config({"HEAD_STALL": "add_task_events:0.5"})
    try:

        async def go():
            from ray_tpu_torch.runtime.head import HeadService

            head = HeadService()
            addr = await head.start()
            conn = await rpc.connect(addr)
            try:
                floods = [
                    asyncio.ensure_future(
                        conn.call("add_task_events", events=_events(5))
                    )
                    for _ in range(8)
                ]
                # Let the stalled telemetry RPCs reach the head.
                await asyncio.sleep(0.1)
                t0 = time.monotonic()
                await conn.call("kv_put", key="ctl", value=b"1")
                control_rtt = time.monotonic() - t0
                flood_t0 = time.monotonic()
                await asyncio.gather(*floods)
                flood_rtt = time.monotonic() - flood_t0
                return control_rtt, flood_rtt
            finally:
                await conn.close()
                await head.stop()

        control_rtt, flood_rtt = asyncio.run(go())
        # The telemetry RPCs really were stalled...
        assert flood_rtt > 0.3, flood_rtt
        # ...and the control RPC did not wait behind them.
        assert control_rtt < 0.25, (
            f"control RPC took {control_rtt:.3f}s behind stalled "
            f"telemetry — admission classes broken"
        )
    finally:
        _clear("HEAD_STALL")


def test_fold_queue_sheds_with_alert_cycle():
    """Bounded fold queue: overload sheds the OLDEST telemetry with a
    counted shed + overload alert ON; once the backlog drains the
    alert transitions back OFF and reads see the folded tail."""
    _config.set_system_config(
        {"HEAD_FOLD_QUEUE_MAX": 50, "HEAD_STALL": "fold:0.5"}
    )
    try:

        async def go():
            from ray_tpu_torch.runtime.head import HeadService

            head = HeadService()
            addr = await head.start()
            conn = await rpc.connect(addr)
            try:
                assert head._overload_alert is False
                reply = await conn.call(
                    "add_task_events", events=_events(200)
                )
                # 200 enqueued into a 50-slot queue: 150 oldest shed.
                assert reply["shed"] == 150, reply
                stats = await conn.call("head_stats")
                assert stats["shed_total"] == 150
                assert stats["overload_alert"] is True
                assert stats["fold_queue_depth"] <= 50
                # Clear the fold stall; the worker drains the backlog
                # and the alert must clear (ON → OFF).
                _config.set_system_config({"HEAD_STALL": ""})
                deadline = time.monotonic() + 10
                while time.monotonic() < deadline:
                    stats = await conn.call("head_stats")
                    if (
                        not stats["overload_alert"]
                        and stats["fold_queue_depth"] == 0
                    ):
                        break
                    await asyncio.sleep(0.05)
                assert stats["overload_alert"] is False
                assert stats["fold_queue_depth"] == 0
                assert stats["folded_total"] == 50
                # Read-your-writes: the survivors are visible on the
                # list surface (newest events survived the shed).
                events = (
                    await conn.call("list_task_events", limit=500)
                )["events"]
                assert len(events) >= 1
                return True
            finally:
                await conn.close()
                await head.stop()

        assert asyncio.run(go())
    finally:
        _clear("HEAD_FOLD_QUEUE_MAX", "HEAD_STALL")


def test_mass_publish_coalesces_into_batch_frames():
    """A batch section (the mass-death/drain path) delivers N logical
    messages in O(1) PUSH frames per subscriber; a lone publish keeps
    the legacy single-message frame shape."""

    async def go():
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService()
        addr = await head.start()
        frames = []
        conn = await rpc.connect(addr, on_push=frames.append)
        try:
            await conn.call("subscribe", channel="node")
            with head._pub_batch():
                for i in range(50):
                    head.publish(
                        "node", {"event": "removed", "node_id": f"n{i}"}
                    )

            def logical():
                return sum(
                    len(f["batch"]) if "batch" in f else 1
                    for f in frames
                )

            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and logical() < 50:
                await asyncio.sleep(0.02)
            assert logical() == 50
            # Coalesced: one tick's worth of frames, not one per msg.
            assert len(frames) <= 2, [list(f) for f in frames]
            batch = frames[0]["batch"]
            # Publish order is preserved inside the batch.
            assert batch[0]["node_id"] == "n0"
            assert batch[-1]["node_id"] == "n49"

            # A single publish outside any batch stays legacy-shaped.
            head.publish("node", {"event": "added", "node_id": "solo"})
            deadline = time.monotonic() + 5
            while time.monotonic() < deadline and logical() < 51:
                await asyncio.sleep(0.02)
            assert "msg" in frames[-1] and "batch" not in frames[-1]

            # Counter pair: logical messages vs pushed frames.
            assert head._pub_msgs_total == 51
            assert head._pub_pushes_total == len(frames)
            return True
        finally:
            await conn.close()
            await head.stop()

    assert asyncio.run(go())


def test_worker_unpacks_batch_frames():
    """Worker-side pubsub delivery: a coalesced batch frame reaches the
    channel handler one message at a time, in order, alongside legacy
    single-message frames."""
    from ray_tpu_torch.runtime.core_worker import CoreWorker

    w = object.__new__(CoreWorker)
    got = []
    w._push_handlers = {"node": got.append}
    w._on_head_push(
        {"channel": "node", "batch": [{"i": 1}, {"i": 2}]}
    )
    w._on_head_push({"channel": "node", "msg": {"i": 3}})
    w._on_head_push({"channel": "ignored", "batch": [{"i": 9}]})
    assert got == [{"i": 1}, {"i": 2}, {"i": 3}]


def test_tqdm_renders_batch_frames():
    """tqdm_ray's pubsub hook renders every bar update in a coalesced
    frame, not just the frame's first message."""
    import io

    from ray_tpu_torch.experimental import tqdm_ray

    out = io.StringIO()
    old = tqdm_ray._display.get("out")
    tqdm_ray._display["out"] = out
    try:
        msgs = [
            {"desc": "work", "total": 10, "n": i} for i in (1, 2, 3)
        ]
        tqdm_ray._render_payload({"channel": "tqdm", "batch": msgs})
        tqdm_ray._render_payload(
            {"channel": "tqdm", "msg": {"desc": "solo", "total": 4,
                                        "n": 4, "done": True}}
        )
        tqdm_ray._render_payload({"channel": "other", "msg": {"n": 9}})
        lines = out.getvalue().splitlines()
        assert lines == [
            "[work] 1/10 …",
            "[work] 2/10 …",
            "[work] 3/10 …",
            "[solo] 4/4 done",
        ]
    finally:
        if old is None:
            tqdm_ray._display.pop("out", None)
        else:
            tqdm_ray._display["out"] = old


def test_pick_node_eligible_index_consistent_under_churn():
    """The incrementally-maintained eligibility mask (O(1) flips on
    drain/undrain/death) must always agree with a from-scratch rebuild
    — and pick_node must never return a draining or dead node."""
    from ray_tpu_torch._private.scale_sim import FakeNode

    async def go():
        from ray_tpu_torch.runtime.head import HeadService

        head = HeadService()
        addr = await head.start()
        nodes = [FakeNode(i, addr) for i in range(8)]
        for n in nodes:
            await n.start()
        conn = await rpc.connect(addr)
        try:
            import random

            rng = random.Random(7)

            def expected_eligible():
                return set(head.nodes) - set(head.draining)

            def incremental_eligible():
                cols = head._sched_cols
                if cols is None:
                    return None
                return {
                    nid
                    for nid, i in cols["idx"].items()
                    if cols["eligible"][i] and nid in head.nodes
                }

            # Build the columns once, then churn WITHOUT rebuilds.
            assert (
                await conn.call("pick_node", resources={"CPU": 1.0})
            )["ok"]
            assert head._sched_cols is not None
            for step in range(60):
                op = rng.choice(["drain", "undrain", "kill", "pick"])
                nid = rng.choice([n.node_id for n in nodes])
                if op == "drain" and nid in head.nodes:
                    await conn.call(
                        "drain_node", node_id=nid, reason="churn"
                    )
                elif op == "undrain" and nid in head.draining:
                    await conn.call("undrain_node", node_id=nid)
                elif op == "kill" and nid in head.nodes:
                    if len(head.nodes) <= 2:
                        continue  # keep the cluster pickable
                    await head._remove_node(nid)
                else:
                    reply = await conn.call(
                        "pick_node", resources={"CPU": 1.0}
                    )
                    if expected_eligible():
                        assert reply["ok"], (step, reply)
                        assert reply["node_id"] in expected_eligible()
                # The incremental mask never disagrees with the
                # from-scratch definition (None = invalidated, which
                # is always safe — next pick rebuilds).
                inc = incremental_eligible()
                if inc is not None:
                    assert inc == expected_eligible(), (
                        f"step {step} op {op}: index drifted"
                    )
            # Force a fresh rebuild and cross-check one final time.
            head._sched_cols = None
            if expected_eligible():
                reply = await conn.call(
                    "pick_node", resources={"CPU": 1.0}
                )
                assert reply["ok"]
                assert incremental_eligible() == expected_eligible()
            return True
        finally:
            await conn.close()
            for n in nodes:
                if not n.dead:
                    await n.kill()
            await head.stop()

    assert asyncio.run(go())
