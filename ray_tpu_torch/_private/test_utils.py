"""Chaos-testing utilities (reference: python/ray/_private/test_utils.py
— ResourceKillerActor :1412, RayletKiller :1534, WorkerKillerActor :1646
kill cluster components on an interval to exercise fault tolerance; the
nightly chaos suites build on them, release/nightly_tests/chaos_test/).
"""

from __future__ import annotations

import asyncio
import random
import time


def parse_straggler_spec(spec: str) -> "dict[int, float]":
    """Parse the RAY_TPU_STRAGGLER_DELAY chaos spec (same comma-
    separated env-spec family as RAY_TPU_RPC_FAILURE):
    ``"rank:seconds[,rank:seconds,…]"`` — the named collective ranks
    sleep that long before contributing to every op. Example:
    ``"2:0.5"`` makes rank 2 half a second late to each collective;
    the partial-allreduce tests use it to skip a deterministic rank.
    Malformed entries are ignored (chaos must never crash the op)."""
    out: dict[int, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        rank, _, delay = entry.partition(":")
        try:
            out[int(rank)] = float(delay)
        except ValueError:
            continue
    return out


def straggler_delay_for_rank(rank: int) -> float:
    """This rank's injected pre-contribution delay (0.0 = none). Read
    per call so tests can flip RAY_TPU_STRAGGLER_DELAY at runtime."""
    from ray_tpu_torch._private import config

    spec = config.get("STRAGGLER_DELAY")
    if not spec:
        return 0.0
    return parse_straggler_spec(spec).get(rank, 0.0)


def parse_head_stall_spec(spec: str) -> "dict[str, float]":
    """Parse the RAY_TPU_HEAD_STALL chaos spec (same comma-separated
    env-spec family as RAY_TPU_STRAGGLER_DELAY):
    ``"method:seconds[,method:seconds,…]"`` — the head sleeps that long
    inside each matching RPC handler before dispatch. ``"*"`` matches
    any method; the pseudo-method ``"fold"`` stalls the background
    telemetry fold worker instead (the deterministic way to back up the
    bounded fold queue). Malformed entries are ignored (chaos must
    never crash the head)."""
    out: dict[str, float] = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        method, _, secs = entry.partition(":")
        try:
            out[method] = float(secs)
        except ValueError:
            continue
    return out


def head_stall_for(method: str) -> float:
    """Injected latency for one head RPC (0.0 = none). Read per call so
    tests can flip RAY_TPU_HEAD_STALL at runtime."""
    from ray_tpu_torch._private import config

    spec = config.get("HEAD_STALL")
    if not spec:
        return 0.0
    stalls = parse_head_stall_spec(spec)
    return stalls.get(method, stalls.get("*", 0.0))


def parse_slice_fail_spec(spec: str) -> "dict[int, tuple[str, float]]":
    """Parse the RAY_TPU_SLICE_FAIL chaos spec (same comma-separated
    env-spec family as RAY_TPU_STRAGGLER_DELAY): ``"slice:when[,…]"``
    where ``when`` is either

    - a float — every rank of that slice is delayed that many seconds
      per op (the whole slice becomes a straggler): ``("delay", s)``;
    - ``kill`` or ``kill@<after_s>`` — every rank of that slice is
      SIGKILLed (after ``after_s`` seconds from the first chaos check):
      ``("kill", after_s)``.

    ``"1:0.5"`` makes slice 1 half a second late to every collective;
    ``"1:kill@2"`` takes slice 1 down two seconds in. Malformed entries
    are ignored (chaos must never crash the op)."""
    out: "dict[int, tuple[str, float]]" = {}
    for entry in spec.split(","):
        entry = entry.strip()
        if not entry:
            continue
        sl, _, when = entry.partition(":")
        try:
            idx = int(sl)
        except ValueError:
            continue
        when = when.strip()
        if when.startswith("kill"):
            _, _, after = when.partition("@")
            try:
                out[idx] = ("kill", float(after) if after else 0.0)
            except ValueError:
                continue
        else:
            try:
                out[idx] = ("delay", float(when))
            except ValueError:
                continue
    return out


def slice_fail_action(slice_index: int) -> "tuple[str, float] | None":
    """This slice's injected failure (None = healthy). Read per call so
    tests can flip RAY_TPU_SLICE_FAIL at runtime."""
    from ray_tpu_torch._private import config

    spec = config.get("SLICE_FAIL")
    if not spec:
        return None
    return parse_slice_fail_spec(spec).get(int(slice_index))


# First time THIS process consulted the slice-fail clock: 'kill@2' means
# two seconds after the process first checks, so every rank of the slice
# dies deterministically relative to its own participation, not boot.
_slice_fail_t0: "float | None" = None


def maybe_fail_slice(slice_index: "int | None" = None) -> None:
    """Apply the RAY_TPU_SLICE_FAIL action for this process's slice:
    sleep for a "delay" spec, SIGKILL ourselves for a "kill" spec whose
    ``after_s`` has elapsed. ``slice_index`` defaults to this process's
    own slice (train context slice label, else the node's "slice"
    label); a process that cannot resolve its slice is never failed.
    Train loops under slice-chaos tests call this once per step — the
    in-process analogue of GCE reaping every host of the slice at
    once."""
    global _slice_fail_t0
    if slice_index is None:
        slice_index = own_slice_index()
    if slice_index is None:
        return
    action = slice_fail_action(slice_index)
    if action is None:
        return
    kind, val = action
    if kind == "delay":
        time.sleep(val)
        return
    if _slice_fail_t0 is None:
        _slice_fail_t0 = time.monotonic()
    if time.monotonic() - _slice_fail_t0 >= val:
        import os

        sigkill_pid(os.getpid())


def own_slice_index() -> "int | None":
    """This process's slice index: the train context's slice label when
    inside a train loop, else this node's "slice" label via the head
    node table. None when unresolvable (no chaos applies)."""
    label = None
    try:
        from ray_tpu_torch.train import session

        ctx = session._context
        if ctx is not None and ctx.slice_label:
            label = ctx.slice_label
    # tpulint: allow(broad-except reason=chaos helper - a process without a train session simply falls through to the node-label lookup)
    except Exception:
        label = None
    if label is None:
        try:
            import ray_tpu_torch.api as api

            rt = api._runtime
            node_addr = getattr(rt.core, "node_addr", None)
            if not node_addr:
                return None
            table = rt.run(rt.core.head.call("node_table"), 5)
            for n in table.values():
                if n.get("addr") == node_addr:
                    label = (n.get("labels") or {}).get("slice")
                    break
        # tpulint: allow(broad-except reason=chaos helper - an unresolvable slice means no chaos applies, never an op failure)
        except Exception:
            return None
    if label is None:
        return None
    try:
        return int(str(label).lstrip("s"))
    except ValueError:
        return None


def fake_hbm_cap_bytes() -> "int | None":
    """The RAY_TPU_FAKE_HBM_GB chaos cap in bytes (None = off). Read
    per call so tests can flip the knob at runtime: the memory sampler
    (runtime/memory.py) reports this as device capacity, driving
    headroom alerts and — when sampled usage exceeds it — the injected
    ResourceExhausted that exercises OOM forensics without real HBM
    pressure."""
    from ray_tpu_torch._private import config

    gb = config.get("FAKE_HBM_GB")
    if not gb or gb <= 0:
        return None
    return int(float(gb) * (1 << 30))


def parse_preempt_spec(spec: str) -> "tuple[float, str]":
    """Parse the RAY_TPU_PREEMPT_AFTER_S chaos spec (same env-spec
    family as RAY_TPU_RPC_FAILURE): ``"<delay_s>[@<substr>]"`` — a
    synthetic preemption notice fires <delay_s> seconds after the node
    starts, on nodes whose node_id or addr contains <substr> (every
    node when omitted). Example: ``"2.5@a1b2c3"`` preempts the node
    whose id starts with a1b2c3 after 2.5s."""
    delay, _, substr = spec.partition("@")
    return float(delay), substr


class FakePreemptionSource:
    """Synthetic preemption-notice source (the test stand-in for the
    GCE maintenance-event poller): fires once, deterministically, per
    the RAY_TPU_PREEMPT_AFTER_S spec. Registered chaos tests use this
    to exercise the full drain lifecycle — notice → DRAINING → emergency
    checkpoint → replacement — without a cloud in sight."""

    interval_s = 0.1

    def __init__(self, spec: str):
        self.delay_s, self.substr = parse_preempt_spec(spec)
        self._t0 = time.monotonic()

    def poll(self, node) -> "tuple[str, float] | None":
        if self.substr and (
            self.substr not in node.node_id
            and self.substr not in (node.addr or "")
        ):
            return None
        if time.monotonic() - self._t0 < self.delay_s:
            return None
        from ray_tpu_torch._private import config

        return ("synthetic-preemption", config.get("DRAIN_DEADLINE_S"))


def kill_one_replica(
    deployment_name: str, app_name: str = "default",
    index: int = 0,
) -> str:
    """SIGKILL the worker process hosting one serve replica — the
    deterministic replica-death chaos the serve control-plane tests and
    bench_serve's kill leg use (the serving twin of sigkill_pid's
    collective-rank kill). Picks the ``index``-th replica of the
    deployment's current routed list, reads the hosting worker's pid
    from its own get_stats, and SIGKILLs it. Returns the killed
    replica's actor id. Refuses to kill the calling process (inproc
    worker mode would take the test down with the replica)."""
    import os

    import ray_tpu_torch
    from ray_tpu_torch.runtime.core_worker import ActorSubmitTarget
    from ray_tpu_torch.serve.handle import CONTROLLER_NAME

    controller = ray_tpu_torch.get_actor(CONTROLLER_NAME)
    _version, replicas = ray_tpu_torch.get(
        controller.get_replicas.remote(deployment_name, app_name)
    )
    if not replicas:
        raise RuntimeError(
            f"no replicas of {app_name}/{deployment_name} to kill"
        )
    actor_id, addr, _max_ongoing = replicas[index % len(replicas)]

    import ray_tpu_torch.api as api

    rt = api._runtime
    refs = rt.run(
        rt.core.submit_task(
            "get_stats", (), {}, num_returns=1,
            actor=ActorSubmitTarget(actor_id, addr),
        )
    )
    stats = rt.run(rt.core.get(refs, timeout=10))[0]
    pid = stats.get("pid")
    if not pid:
        raise RuntimeError("replica reported no pid (old replica code?)")
    if pid == os.getpid():
        raise RuntimeError(
            "refusing to SIGKILL the calling process (inproc worker "
            "mode); run replica-kill chaos with subprocess workers"
        )
    sigkill_pid(int(pid))
    return actor_id


def sigkill_pid(pid: int) -> None:
    """SIGKILL one worker process — the targeted mid-op member killer
    the collective chaos tests use (WorkerKillerActor kills *random*
    leased workers; collective-abort assertions need to know which rank
    died). The node's reap loop notices within ~1s and the head fans the
    death out to the victim's collective groups."""
    import os
    import signal

    try:
        os.kill(pid, signal.SIGKILL)
    except ProcessLookupError:
        pass


class WorkerKillerActor:
    """Kills leased task workers on an interval. Deploy with
    ``ray_tpu_torch.remote(WorkerKillerActor).remote(...)`` and call
    ``run.remote()``; tasks with retries should keep completing.

    By default actors are spared (killing the killer — or the test's own
    actors — makes assertions murky); pass ``include_actors=True`` for
    full chaos."""

    def __init__(
        self,
        interval_s: float = 1.0,
        max_kills: int = 3,
        include_actors: bool = False,
        seed: int = 0,
    ):
        self.interval_s = interval_s
        self.max_kills = max_kills
        self.include_actors = include_actors
        self.kills: list[str] = []
        self._rng = random.Random(seed)

    async def _nodes(self):
        import ray_tpu_torch.api as api

        rt = api._runtime
        table = await rt.core.head.call("node_table")
        return [n["addr"] for n in table.values()]

    async def run(self) -> list[str]:
        """Kill until max_kills; returns killed worker ids."""
        import ray_tpu_torch.api as api

        rt = api._runtime
        while len(self.kills) < self.max_kills:
            await asyncio.sleep(self.interval_s)
            for addr in await self._nodes():
                try:
                    conn = await rt.core._connect(addr)
                    reply = await conn.call("list_workers")
                # tpulint: allow(broad-except reason=chaos actor probing nodes it may itself have killed; an unreachable node is skipped, which is the point)
                except Exception:  # noqa: BLE001 - node may be gone
                    continue
                victims = [
                    w for w in reply["workers"]
                    if w["leased"]
                    and (self.include_actors or not w["is_actor"])
                    and w["worker_id"] != rt.core.worker_id
                ]
                if not victims:
                    continue
                victim = self._rng.choice(victims)
                try:
                    await conn.call(
                        "kill_worker", worker_id=victim["worker_id"]
                    )
                    self.kills.append(victim["worker_id"])
                # tpulint: allow(broad-except reason=chaos kill racing the victim's own death; a lost race means the worker is already dead, try the next node)
                except Exception:  # noqa: BLE001
                    continue
                break
        return self.kills

    def kill_count(self) -> int:
        return len(self.kills)


class NodeKillerActor:
    """Tears down a whole (non-head) node daemon — the raylet-death
    chaos case (reference: RayletKiller test_utils.py:1534). Only nodes
    whose addresses are in ``targets`` are touched, so the test's own
    node survives."""

    def __init__(self, targets: list[str]):
        self.targets = list(targets)
        self.killed: list[str] = []

    async def kill_one(self) -> str | None:
        import ray_tpu_torch.api as api

        rt = api._runtime
        while self.targets:
            addr = self.targets.pop(0)
            try:
                conn = await rt.core._connect(addr)
                # The node daemon has no self-destruct rpc: kill its
                # workers, then sever by asking the head to drop it is
                # not possible remotely — instead kill every worker so
                # leases fail over, which is the recoverable half of
                # node death testable in-process.
                reply = await conn.call("list_workers")
                for w in reply["workers"]:
                    await conn.call("kill_worker", worker_id=w["worker_id"])
                self.killed.append(addr)
                return addr
            # tpulint: allow(broad-except reason=chaos actor tearing down a node that may already be half-dead; the next target is tried)
            except Exception:  # noqa: BLE001
                continue
        return None
