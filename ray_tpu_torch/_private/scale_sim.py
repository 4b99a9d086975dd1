"""Simulated-scale control-plane harness: thousands of fake nodes
against a REAL head (port of ray_tpu/_private/scale_sim.py: the fake
nodes advertise GPUs where the source's advertise TPUs, and the head is
the port's, started through ``python -m ray_tpu_torch.scripts``).

The head under test is the production `HeadService`, CLI-daemonized in
its own process and spoken to over real RPC connections — nothing is
mocked on the head side. What is fake is the *nodes*: each `FakeNode`
is a few-hundred-byte asyncio object with a real listening socket (the
head dials back on registration), a keepalive loop, and a telemetry
flood generator. One harness process comfortably simulates a
1000-node cluster.

Legs (each emits `{"name", "value", "unit"}` JSON rows on stdout, the
same row protocol as scale_smoke.py, and contributes to the result
doc):

- register storm      N nodes register concurrently; registrations/s
                      and pick_node decisions/s over the full cluster.
- idle control p99    keepalive RTT percentiles with no competing load,
                      plus a contended baseline (harness burns the same
                      CPU with NO telemetry) to isolate head queueing
                      from shared-core contention.
- overdrive           unthrottled telemetry flood — calibrates fold
                      throughput and proves the bounded queue sheds
                      (counter + overload alert).
- 2x overload         telemetry flood throttled to 2x the calibrated
                      fold throughput — the pinned criterion: control
                      RPC p99 must hold within bound while shedding.
- slice mass death    a labelled 32-node slice dies at once; death +
                      drain fan-out must coalesce (pushed frames <<
                      logical msgs x subscribers).
- SIGKILL recovery    head killed mid-load, restarted via the CLI;
                      journal replay + full re-registration timed, with
                      the jittered reconnect backoff observed.

Run reduced (tier-1 smoke): python -m ray_tpu_torch._private.scale_sim \
    --nodes 12 --slice-nodes 4 --subscribers 3 --overload-s 2
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import secrets
import signal
import socket
import statistics
import subprocess
import sys
import time

KEEPALIVE_INTERVAL_S = 1.0
HEALTH_TIMEOUT_S = 4.0
FLOOD_BATCH = 500


def emit(name: str, value, unit: str) -> dict:
    row = {"name": name, "value": value, "unit": unit}
    print(json.dumps(row), flush=True)
    return row


def _pct(xs: "list[float]", q: float) -> float:
    if not xs:
        return 0.0
    xs = sorted(xs)
    i = min(len(xs) - 1, int(round(q * (len(xs) - 1))))
    return xs[i]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _raise_fd_limit() -> None:
    """3 sockets per fake node (listener + conn each way) — lift the
    soft RLIMIT_NOFILE to the hard cap so 1000 nodes fit. The head
    subprocess inherits the raised limit."""
    import resource

    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))


class HeadProc:
    """The real head, CLI-daemonized (`ray_tpu_torch start --head
    --head-only`) so a SIGKILL is a genuine process death — no shared
    event loop with the harness to soften the crash."""

    def __init__(self, session_dir: str, port: int, token: str,
                 extra_env: "dict[str, str] | None" = None):
        self.session_dir = session_dir
        self.port = port
        self.token = token
        self.addr = f"127.0.0.1:{port}"
        self.extra_env = dict(extra_env or {})

    def _cli(self, args: "list[str]") -> subprocess.CompletedProcess:
        env = dict(os.environ)
        env.update(self.extra_env)
        return subprocess.run(
            [sys.executable, "-m", "ray_tpu_torch.scripts", *args],
            capture_output=True, text=True, timeout=120, env=env,
        )

    def start(self) -> None:
        out = self._cli(
            ["start", "--head", "--head-only",
             "--port", str(self.port),
             "--session-dir", self.session_dir,
             "--auth-token", self.token]
        )
        if out.returncode != 0:
            raise RuntimeError(
                f"head start failed: {out.stdout}\n{out.stderr}"
            )

    def pid(self) -> int:
        pids = [
            int(open(os.path.join(self.session_dir, f)).read())
            for f in os.listdir(self.session_dir)
            if f.startswith("head-") and f.endswith(".pid")
        ]
        if not pids:
            raise RuntimeError("no head pid file in session dir")
        return pids[0]

    def sigkill(self) -> None:
        os.kill(self.pid(), signal.SIGKILL)
        for f in list(os.listdir(self.session_dir)):
            if f.endswith(".pid"):
                os.unlink(os.path.join(self.session_dir, f))

    def stop(self) -> None:
        try:
            self._cli(["stop", "--session-dir", self.session_dir])
        # tpulint: allow(broad-except reason=bench teardown is best-effort; the head may already be SIGKILLed by the recovery leg and `stop` failing then is the expected outcome)
        except Exception:
            pass


class FakeNode:
    """A lightweight node impostor: registers with real labels and a
    real listening socket, keeps its heartbeat alive, floods telemetry
    on demand, and — after a head death — re-registers through the
    same jittered exponential backoff the production
    ReconnectingClient uses, recording the delays it drew."""

    def __init__(self, idx: int, head_addr: str,
                 labels: "dict | None" = None):
        self.idx = idx
        self.node_id = f"sim{idx:05d}" + secrets.token_hex(4)
        self.head_addr = head_addr
        self.labels = labels or {}
        self.server = None
        self.addr = None
        self.conn = None
        self._keepalive_task = None
        self.dead = False
        self.keepalive_rtts: "list[float]" = []
        self.backoff_delays: "list[float]" = []
        self.reregistered_ts: "float | None" = None
        self._span_seq = 0

    async def _serve(self, method: str, kw: dict, conn) -> dict:
        # set_draining, probes — a fake node agrees with everything.
        return {"ok": True}

    async def start(self) -> None:
        from ray_tpu_torch._private import rpc

        self.server = rpc.Server(self._serve)
        port = await self.server.start("127.0.0.1", 0)
        self.addr = f"127.0.0.1:{port}"
        await self._register()

    async def _register(self) -> None:
        from ray_tpu_torch._private import rpc

        self.conn = await rpc.connect(self.head_addr)
        await self.conn.call(
            "register_node",
            node_id=self.node_id,
            addr=self.addr,
            resources={"CPU": 4.0, "GPU": 4.0},
            labels=self.labels,
        )

    async def _reconnect(self) -> None:
        """Post-head-death reconnect: full-jitter exponential backoff,
        exactly the production schedule (rpc.backoff_delay), with each
        drawn delay recorded so the harness can assert the herd
        actually spread out."""
        from ray_tpu_torch._private import rpc

        attempt = 0
        while not self.dead:
            delay = rpc.backoff_delay(attempt)
            self.backoff_delays.append(delay)
            await asyncio.sleep(delay)
            try:
                await self._register()
                self.reregistered_ts = time.monotonic()
                return
            except (rpc.RpcError, OSError):
                attempt += 1

    async def keepalive_loop(self) -> None:
        from ray_tpu_torch._private import rpc

        while not self.dead:
            await asyncio.sleep(
                KEEPALIVE_INTERVAL_S * (0.5 + self.idx % 100 / 100.0)
            )
            if self.dead:
                return
            t0 = time.monotonic()
            try:
                reply = await self.conn.call("keepalive",
                                             node_id=self.node_id)
                self.keepalive_rtts.append(time.monotonic() - t0)
                if reply.get("reregister"):
                    await self._register()
            except (rpc.RpcError, OSError):
                if not self.dead:
                    await self._reconnect()

    def start_keepalive(self) -> None:
        self._keepalive_task = asyncio.ensure_future(
            self.keepalive_loop()
        )

    def make_events(self, n: int) -> "list[dict]":
        out = []
        for _ in range(n):
            self._span_seq += 1
            out.append({
                "task_id": f"{self.node_id}-t{self._span_seq}",
                "name": "sim_task",
                "state": "FINISHED",
                "worker": self.addr,
                "ts": time.time(),
                "dur": 0.01,
            })
        return out

    async def flood(self, until: float,
                    interval_s: "float | None",
                    phase: float = 0.0) -> int:
        """Send FLOOD_BATCH-event telemetry batches until the deadline;
        `interval_s` rate-limits (None = as fast as possible).
        Returns events sent. Payloads are prebuilt and cycled so the
        harness spends its cycles on the wire, not on dict literals —
        otherwise a single-core box caps the send rate at roughly the
        head's fold rate and the overload legs can't outrun it."""
        from ray_tpu_torch._private import rpc

        payloads = [self.make_events(FLOOD_BATCH) for _ in range(4)]
        sent = 0
        i = 0
        # Absolute schedule: next_t advances by the interval regardless
        # of call RTT, so a slow reply is caught up with back-to-back
        # sends instead of silently lowering the achieved rate. The
        # phase offset (fraction of one interval) de-synchronizes the
        # flooder fleet: phase-locked senders all firing on the same
        # tick deliver their frames as one burst, and the head decodes
        # them back-to-back — a tens-of-ms tail-latency artifact real
        # (unsynchronized) nodes don't produce.
        next_t = time.monotonic()
        if interval_s and phase:
            offset = phase * interval_s
            next_t += offset
            await asyncio.sleep(offset)
        while time.monotonic() < until and not self.dead:
            try:
                await self.conn.call(
                    "add_task_events",
                    events=payloads[i % len(payloads)],
                )
                i += 1
                sent += FLOOD_BATCH
            except (rpc.RpcError, OSError):
                return sent
            if interval_s:
                next_t += interval_s
                await asyncio.sleep(max(0.0, next_t - time.monotonic()))
            else:
                await asyncio.sleep(0)
        return sent

    async def kill(self) -> None:
        """Die abruptly: stop answering, close every socket. The head
        finds out the way it would in production — heartbeat timeout."""
        self.dead = True
        if self._keepalive_task is not None:
            self._keepalive_task.cancel()
        if self.conn is not None:
            await self.conn.close()
        if self.server is not None:
            await self.server.stop()


class Subscriber:
    """A pubsub client counting frames vs logical messages — the
    receiving end of the death fan-out coalescing assertion."""

    def __init__(self, head_addr: str):
        self.head_addr = head_addr
        self.conn = None
        self.frames = 0
        self.msgs = 0

    def _on_push(self, payload) -> None:
        self.frames += 1
        batch = payload.get("batch")
        self.msgs += len(batch) if batch is not None else 1

    async def start(self, channels=("node", "drain", "slice")) -> None:
        from ray_tpu_torch._private import rpc

        self.conn = await rpc.connect(self.head_addr,
                                      on_push=self._on_push)
        for ch in channels:
            await self.conn.call("subscribe", channel=ch)

    async def close(self) -> None:
        if self.conn is not None:
            await self.conn.close()


async def _head_stats(head_addr: str) -> dict:
    from ray_tpu_torch._private import rpc

    conn = await rpc.connect(head_addr)
    try:
        return await conn.call("head_stats")
    finally:
        await conn.close()


class RttSampler:
    """Control-RPC latency probe in its OWN process: the harness
    process is GIL-saturated by the flooders during the overload leg,
    and a sampler sharing it (task or thread) measures harness GIL
    starvation, not head responsiveness. The subprocess connects,
    prints READY, samples for the window, and prints the RTT list."""

    def __init__(self, head_addr: str, node_id: str, seconds: float):
        self._args = [
            sys.executable, "-m", "ray_tpu_torch._private.scale_sim",
            "--sample-rtt", head_addr, "--node-id", node_id,
            "--seconds", str(seconds),
        ]
        self._proc = None

    async def start(self) -> None:
        env = dict(os.environ)

        def _nice():
            # Latency measurement discipline: the sampler is nearly
            # idle, but on a loaded single-core box its RTTs would
            # otherwise include its OWN run-queue wakeup latency (tens
            # of ms under CFS) — priority removes the artifact without
            # distorting head-vs-flooder competition. Best effort.
            try:
                os.nice(-10)
            except OSError:
                pass

        self._proc = await asyncio.create_subprocess_exec(
            *self._args,
            stdout=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.PIPE,
            env=env,
            preexec_fn=_nice,
        )
        ready = await asyncio.wait_for(
            self._proc.stdout.readline(), timeout=60
        )
        if ready.strip() != b"READY":
            raise RuntimeError(f"rtt sampler did not start: {ready!r}")

    async def result(self) -> "list[float]":
        out, err = await self._proc.communicate()
        if self._proc.returncode != 0:
            raise RuntimeError(f"rtt sampler failed: {err.decode()}")
        return json.loads(out)


async def _sample_control_rtt(head_addr: str, node_id: str,
                              seconds: float) -> "list[float]":
    s = RttSampler(head_addr, node_id, seconds)
    await s.start()
    return await s.result()


def _sample_rtt_main(addr: str, node_id: str, seconds: float) -> int:
    async def sample() -> "list[float]":
        from ray_tpu_torch._private import rpc

        conn = await rpc.connect(addr)
        print("READY", flush=True)
        rtts = []
        until = time.monotonic() + seconds
        try:
            while time.monotonic() < until:
                t0 = time.monotonic()
                await conn.call("keepalive", node_id=node_id)
                rtts.append(time.monotonic() - t0)
                await asyncio.sleep(0.005)
        finally:
            await conn.close()
        return rtts

    print(json.dumps(asyncio.run(sample())), flush=True)
    return 0


async def _pick_rate(head_addr: str, seconds: float) -> float:
    """Scheduler decisions/s over the registered cluster."""
    from ray_tpu_torch._private import rpc

    conn = await rpc.connect(head_addr)
    n = 0
    until = time.monotonic() + seconds
    t0 = time.monotonic()
    try:
        while time.monotonic() < until:
            await conn.call("pick_node", resources={"CPU": 1.0})
            n += 1
    finally:
        took = time.monotonic() - t0
        await conn.close()
    return n / max(took, 1e-9)


async def run_sim(opts) -> dict:
    from ray_tpu_torch._private import rpc

    doc: dict = {
        "bench": "head_scale",
        "nodes": opts.nodes,
        "slice_nodes": opts.slice_nodes,
        "subscribers": opts.subscribers,
    }
    token = secrets.token_hex(16)
    os.environ["RAY_TPU_AUTH_TOKEN"] = token
    journal = os.path.join(opts.session_dir, "head.journal")
    head = HeadProc(
        opts.session_dir, opts.port or _free_port(), token,
        extra_env={
            "RAY_TPU_HEAD_JOURNAL": journal,
            "RAY_TPU_HEALTH_TIMEOUT_S": str(HEALTH_TIMEOUT_S),
            "RAY_TPU_HEAD_FOLD_QUEUE_MAX": str(opts.fold_queue_max),
            # Control plane wins CPU contention against the co-located
            # load generator (the documented shared-host deployment
            # posture; best-effort without privileges).
            "RAY_TPU_HEAD_NICE": "-5",
        },
    )
    head.start()
    nodes: "list[FakeNode]" = []
    try:
        # --- leg 1: registration storm -------------------------------
        t0 = time.monotonic()
        plain = opts.nodes - opts.slice_nodes
        for i in range(opts.nodes):
            labels = (
                {"slice": "simslice", "slice_host_count": opts.slice_nodes}
                if i >= plain else {}
            )
            nodes.append(FakeNode(i, head.addr, labels=labels))
        sem = asyncio.Semaphore(64)

        async def boot(n: FakeNode):
            async with sem:
                await n.start()

        await asyncio.gather(*(boot(n) for n in nodes))
        reg_s = time.monotonic() - t0
        doc["register_storm"] = {
            "nodes": opts.nodes,
            "wall_s": round(reg_s, 3),
            "registrations_per_s": round(opts.nodes / reg_s, 1),
        }
        emit("head_register_per_s", doc["register_storm"]
             ["registrations_per_s"], "regs/s")
        for n in nodes:
            n.start_keepalive()

        # Scheduler decision rate over the full maintained columns.
        pick_rate = await _pick_rate(head.addr, opts.probe_s)
        doc["pick_node_per_s"] = round(pick_rate, 1)
        emit("head_pick_node_per_s", doc["pick_node_per_s"], "picks/s")

        # --- leg 2: idle control p99 ---------------------------------
        idle = await _sample_control_rtt(
            head.addr, nodes[0].node_id, opts.probe_s
        )
        doc["idle_control_p50_ms"] = round(_pct(idle, 0.5) * 1e3, 3)
        doc["idle_control_p99_ms"] = round(_pct(idle, 0.99) * 1e3, 3)
        emit("head_idle_control_p99_ms", doc["idle_control_p99_ms"],
             "ms")

        # --- leg 2b: contended baseline ------------------------------
        # On a shared-core box the overload leg's keepalive RTT folds
        # in two costs the head's admission classes cannot touch: the
        # load generator's own CPU burn, and the OS run-queue delay a
        # SATURATED process pays under CFS (a busy head burns its
        # timeslice and then waits behind its neighbours — multi-ms at
        # the tail, and absent on any multi-core production box).
        # Baseline both out: the harness spins AND a burner subprocess
        # stands in for the busy head process, so overload_p99 /
        # contended_p99 isolates the queueing the head itself adds
        # under a span flood — the quantity the admission classes are
        # meant to bound.
        burner = subprocess.Popen(
            [sys.executable, "-c", "while True:\n    pass"],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
        )
        try:
            baseline_s = max(opts.probe_s, 4.0)
            sampler = RttSampler(
                head.addr, nodes[0].node_id, baseline_s
            )
            await sampler.start()
            until = time.monotonic() + baseline_s
            while time.monotonic() < until:
                for _ in range(20000):
                    pass
                await asyncio.sleep(0)
            contended = await sampler.result()
        finally:
            burner.kill()
            burner.wait()
        doc["contended_control_p50_ms"] = round(
            _pct(contended, 0.5) * 1e3, 3
        )
        doc["contended_control_p99_ms"] = round(
            _pct(contended, 0.99) * 1e3, 3
        )
        emit("head_contended_control_p99_ms",
             doc["contended_control_p99_ms"], "ms")

        # --- leg 3: telemetry overload -------------------------------
        # Unthrottled flood: the prebuilt-payload senders enqueue far
        # faster than the head can fold, so the bounded queue fills and
        # MUST shed — while the control sampler (own process) measures
        # keepalive RTT through the storm. The overload factor
        # (enqueue rate / fold rate) is reported and pinned >= 2x.
        flooders = nodes[: min(32, len(nodes))]
        s1 = await _head_stats(head.addr)
        sampler = RttSampler(
            head.addr, nodes[0].node_id, opts.overload_s
        )
        await sampler.start()
        until = time.monotonic() + opts.overload_s
        sent = await asyncio.gather(
            *(n.flood(until, interval_s=None) for n in flooders)
        )
        rtts = await sampler.result()
        s2 = await _head_stats(head.addr)
        send_rate = sum(sent) / opts.overload_s
        fold_rate = (
            (s2["folded_total"] - s1["folded_total"]) / opts.overload_s
        )
        doc["fold_events_per_s"] = round(fold_rate, 1)
        emit("head_fold_events_per_s", doc["fold_events_per_s"],
             "events/s")
        doc["overload"] = {
            "events_sent": sum(sent),
            "send_events_per_s": round(send_rate, 1),
            "overload_factor": round(
                send_rate / max(fold_rate, 1.0), 2
            ),
            "shed_total": s2["shed_total"] - s1["shed_total"],
            "alert_seen": bool(
                s2["overload_alert"]
                or s2["shed_total"] > s1["shed_total"]
            ),
            "control_p50_ms": round(_pct(rtts, 0.5) * 1e3, 3),
            "control_p99_ms": round(_pct(rtts, 0.99) * 1e3, 3),
            "p99_vs_idle": round(
                _pct(rtts, 0.99) / max(_pct(idle, 0.99), 1e-9), 2
            ),
            "p99_vs_contended": round(
                _pct(rtts, 0.99) / max(_pct(contended, 0.99), 1e-9), 2
            ),
        }
        emit("head_overload_shed_total", doc["overload"]["shed_total"],
             "events")
        emit("head_overload_control_p99_ms",
             doc["overload"]["control_p99_ms"], "ms")
        # Let the fold backlog drain (alert OFF) before the next leg.
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            s2 = await _head_stats(head.addr)
            if s2["fold_queue_depth"] == 0:
                break
            await asyncio.sleep(0.25)

        # --- leg 3b: 2x overload (the pinned criterion) --------------
        # The overdrive leg above proves the queue sheds at maximum
        # pressure; THIS leg is the acceptance criterion: control-RPC
        # p99 must hold while the head is fed ~2x what it can fold.
        # Fold capacity is load-dependent (lighter decode pressure =
        # higher capacity), so a fixed 2x-of-calibration target can
        # land UNDER true capacity and never shed — and capacity drops
        # steeply once decode saturates, so doubling overshoots to 6x.
        # Bisect the send rate to the factor~2 knee instead.
        target = 2.0 * max(fold_rate, 1.0)
        lo = hi = None  # send rates bracketing the knee
        attempts = []
        for _attempt in range(8):
            per_flooder_interval = (
                FLOOD_BATCH * len(flooders) / target
            )
            s1 = await _head_stats(head.addr)
            sampler = RttSampler(
                head.addr, nodes[0].node_id, opts.overload_s
            )
            await sampler.start()
            until = time.monotonic() + opts.overload_s
            sent = await asyncio.gather(
                *(n.flood(until, interval_s=per_flooder_interval,
                          phase=i / len(flooders))
                  for i, n in enumerate(flooders))
            )
            rtts2 = await sampler.result()
            s2 = await _head_stats(head.addr)
            send_rate2 = sum(sent) / opts.overload_s
            fold_rate2 = (
                (s2["folded_total"] - s1["folded_total"])
                / opts.overload_s
            )
            leg = {
                "target_events_per_s": round(target, 1),
                "send_events_per_s": round(send_rate2, 1),
                "overload_factor": round(
                    send_rate2 / max(fold_rate2, 1.0), 2
                ),
                "shed_total": s2["shed_total"] - s1["shed_total"],
                "control_p50_ms": round(_pct(rtts2, 0.5) * 1e3, 3),
                "control_p99_ms": round(_pct(rtts2, 0.99) * 1e3, 3),
                "p99_vs_idle": round(
                    _pct(rtts2, 0.99) / max(_pct(idle, 0.99), 1e-9), 2
                ),
                "p99_vs_contended": round(
                    _pct(rtts2, 0.99)
                    / max(_pct(contended, 0.99), 1e-9),
                    2,
                ),
            }
            attempts.append(leg)
            # Drain the backlog before judging / retrying.
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                sd = await _head_stats(head.addr)
                if sd["fold_queue_depth"] == 0:
                    break
                await asyncio.sleep(0.25)
            factor = leg["overload_factor"]
            if 1.8 <= factor <= 3.2 and leg["shed_total"] > 0:
                break
            if factor < 1.8:  # head kept up — push harder
                lo = send_rate2
                target = (
                    (lo * hi) ** 0.5 if hi else 2.0 * send_rate2
                )
            else:  # overshot the knee — back off
                hi = send_rate2
                target = (lo * hi) ** 0.5 if lo else hi / 2.0
        # Keep the attempt that best realized "2x overload" (closest
        # factor to 2 among those that shed AND genuinely overloaded
        # the head) — the bisection's last probe is not necessarily
        # its best.
        import math

        def _score(a):
            f = max(a["overload_factor"], 1e-6)
            # Sub-1.5x attempts didn't meaningfully overload the head;
            # only prefer one if nothing better exists.
            return (0 if f >= 1.5 else 100) + abs(math.log(f / 2.0))

        best = min(
            (a for a in attempts if a["shed_total"] > 0),
            key=_score,
            default=attempts[-1],
        )
        doc["overload_2x"] = dict(best, attempts=len(attempts))
        emit("head_overload2x_control_p99_ms",
             doc["overload_2x"]["control_p99_ms"], "ms")

        # --- leg 4: slice mass death ---------------------------------
        subs = [Subscriber(head.addr) for _ in range(opts.subscribers)]
        for s in subs:
            await s.start()
        sd0 = await _head_stats(head.addr)
        victims = [n for n in nodes if n.labels.get("slice")]
        t_kill = time.monotonic()
        await asyncio.gather(*(n.kill() for n in victims))
        # Death is discovered by heartbeat timeout; wait for the table
        # to shrink to the survivors.
        survivors = opts.nodes - len(victims)
        deadline = time.monotonic() + HEALTH_TIMEOUT_S * 4 + 30
        while time.monotonic() < deadline:
            sd1 = await _head_stats(head.addr)
            if sd1["nodes"] <= survivors:
                break
            await asyncio.sleep(0.25)
        detect_s = time.monotonic() - t_kill
        await asyncio.sleep(0.5)
        sd1 = await _head_stats(head.addr)
        msgs = sd1["pub_msgs_total"] - sd0["pub_msgs_total"]
        pushes = sd1["pub_pushes_total"] - sd0["pub_pushes_total"]
        naive = msgs * max(1, len(subs))
        doc["mass_death"] = {
            "victims": len(victims),
            "subscribers": len(subs),
            "detect_s": round(detect_s, 2),
            "logical_msgs": msgs,
            "pushed_frames": pushes,
            "naive_frames": naive,
            "coalesce_ratio": round(pushes / max(naive, 1), 4),
            "sub_frames": [s.frames for s in subs],
            "sub_msgs": [s.msgs for s in subs],
        }
        emit("head_death_fanout_frames", pushes, "frames")
        emit("head_death_fanout_coalesce_ratio",
             doc["mass_death"]["coalesce_ratio"], "ratio")
        for s in subs:
            await s.close()

        # --- leg 5: mid-load head SIGKILL + recovery -----------------
        # Give the journal realistic replay depth first.
        conn = await rpc.connect(head.addr)
        for i in range(opts.journal_keys):
            await conn.call(
                "kv_put", key=f"scale:k{i}", value=b"x" * 128
            )
        await conn.close()
        live = [n for n in nodes if not n.dead]
        flood_until = time.monotonic() + 30
        flood_tasks = [
            asyncio.ensure_future(n.flood(flood_until, interval_s=0.1))
            for n in live[:8]
        ]
        await asyncio.sleep(0.5)
        t_kill = time.monotonic()
        head.sigkill()
        head.start()
        # First successful control RPC = journal replayed + serving.
        t_first = None
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline:
            try:
                s3 = await _head_stats(head.addr)
                t_first = time.monotonic() - t_kill
                break
            except (rpc.RpcError, OSError):
                await asyncio.sleep(0.1)
        if t_first is None:
            raise RuntimeError("head never came back after SIGKILL")
        # Full recovery: every live fake node re-registered through its
        # jittered backoff loop.
        deadline = time.monotonic() + 120
        while time.monotonic() < deadline:
            s4 = await _head_stats(head.addr)
            if s4["nodes"] >= len(live):
                break
            await asyncio.sleep(0.25)
        t_full = time.monotonic() - t_kill
        for t in flood_tasks:
            t.cancel()
        delays = [d for n in live for d in n.backoff_delays]
        doc["sigkill_recovery"] = {
            "first_rpc_s": round(t_first, 2),
            "full_reconnect_s": round(t_full, 2),
            "reconnected": s4["nodes"],
            "expected": len(live),
            "replayed_records": (s3.get("journal") or {}).get(
                "replayed_records", 0
            ),
            "replay_s": (s3.get("journal") or {}).get("replay_s", 0.0),
            "backoff_draws": len(delays),
            "backoff_spread_s": round(
                (max(delays) - min(delays)) if len(delays) > 1 else 0.0,
                4,
            ),
            "backoff_stdev_s": round(
                statistics.pstdev(delays) if len(delays) > 1 else 0.0,
                4,
            ),
        }
        emit("head_recover_first_rpc_s", doc["sigkill_recovery"]
             ["first_rpc_s"], "s")
        emit("head_recover_full_s", doc["sigkill_recovery"]
             ["full_reconnect_s"], "s")
        emit("head_backoff_spread_s", doc["sigkill_recovery"]
             ["backoff_spread_s"], "s")
        doc["ok"] = True
        return doc
    finally:
        for n in nodes:
            if not n.dead:
                try:
                    await n.kill()
                # tpulint: allow(broad-except reason=bench teardown sweep; a node whose connection died mid-leg still must not block the remaining kills or the doc return)
                except Exception:
                    pass
        head.stop()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="simulated-scale head survival harness"
    )
    ap.add_argument("--nodes", type=int, default=1000)
    ap.add_argument("--slice-nodes", type=int, default=32,
                    help="slice-labelled victims for the mass-death leg")
    ap.add_argument("--subscribers", type=int, default=8)
    ap.add_argument("--overload-s", type=float, default=5.0)
    ap.add_argument("--probe-s", type=float, default=2.0)
    ap.add_argument("--journal-keys", type=int, default=2000)
    ap.add_argument("--fold-queue-max", type=int, default=20000)
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--session-dir", default=None)
    ap.add_argument("--out", default=None,
                    help="write the full result doc to this JSON file")
    ap.add_argument("--sample-rtt", default=None, metavar="ADDR",
                    help=argparse.SUPPRESS)  # internal: sampler child
    ap.add_argument("--node-id", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--seconds", type=float, default=2.0,
                    help=argparse.SUPPRESS)
    opts = ap.parse_args(argv)
    if opts.sample_rtt:
        return _sample_rtt_main(
            opts.sample_rtt, opts.node_id, opts.seconds
        )
    if opts.slice_nodes >= opts.nodes:
        ap.error("--slice-nodes must be < --nodes")
    _raise_fd_limit()
    import tempfile

    if opts.session_dir is None:
        opts.session_dir = tempfile.mkdtemp(prefix="ray_tpu_scale_sim_")
    os.makedirs(opts.session_dir, exist_ok=True)
    doc = asyncio.run(run_sim(opts))
    if opts.out:
        with open(opts.out, "w") as f:
            json.dump(doc, f, indent=1)
            f.write("\n")
    print(json.dumps({"name": "head_scale_ok",
                      "value": 1 if doc.get("ok") else 0,
                      "unit": "bool"}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
