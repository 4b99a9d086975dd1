"""Core worker: in-process runtime for every driver and worker process.

Mirrors the reference core worker (reference:
src/ray/core_worker/core_worker.h:167): task submission with leased
workers (normal_task_submitter.h:86), ordered actor-task submission
(actor_task_submitter.h:68), an in-memory store for small results owned by
the submitting process (memory_store.h:47), shared-memory store access for
large objects, task retries on worker death (task_manager.h:175), and the
task-execution callback on the worker side (task_receiver.h:43 /
_raylet.pyx:1602 execute_task).

Ownership model: the process that submits a task (or calls put) owns the
returned objects — it holds their values (inline) or locations (store) and
serves `get_object` to any process holding the ref. This is the
reference's ownership design (SURVEY.md section 5, failure detection row).
"""

from __future__ import annotations

import asyncio
import collections
import functools
import hashlib
import inspect
import time
import traceback
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Sequence

from ray_tpu_torch._private import config, rpc
from ray_tpu_torch._private.ids import ActorID, FunctionID, ObjectID, TaskID
from ray_tpu_torch._private.serialization import Serialized, deserialize, serialize
from ray_tpu_torch.exceptions import (
    ActorDiedError,
    GetTimeoutError,
    ObjectLostError,
    RayTaskError,
    TaskCancelledError,
    WorkerDiedError,
)
from ray_tpu_torch.runtime.object_store import ObjectStore

import logging

logger = logging.getLogger("ray_tpu_torch.core_worker")

INLINE_MAX_BYTES = 100_000
DEFAULT_RETRIES = 3
GENERATOR_BACKPRESSURE_ITEMS = 8  # max undelivered items per stream


def _spec_nbytes(spec: dict) -> int:
    """Approximate retained size of a lineage entry: the serialized args
    dominate (by-value entries carry inband bytes + buffers)."""
    total = 256  # envelope
    for entry in spec.get("args", ()):
        if entry[1] == "val":
            total += len(entry[2]) + sum(len(b) for b in entry[3])
        else:
            total += 64
    return total


class _NeedsPull(Exception):
    """Internal: the record's bytes live in another node's store."""

    def __init__(self, holder_addr: str):
        super().__init__(holder_addr)
        self.holder_addr = holder_addr


class _NeedsTensor(Exception):
    """Internal: the record's payload lives in a worker's device-tensor
    store (tensor transport) — fetch it from the source actor."""

    def __init__(self, meta: dict):
        super().__init__(meta)
        self.meta = meta


def _cuda_driver_loaded(maps: str = "/proc/self/maps") -> bool:
    """Whether this process mapped the CUDA driver library (libcuda),
    which every CUDA initialization loads; True where the map cannot be
    read."""
    try:
        with open(maps) as f:
            return any("libcuda.so" in line for line in f)
    except OSError:
        return True


class CoreWorker:
    def __init__(
        self,
        mode: str,  # "driver" | "worker" | "client"
        head_addr: str,
        node_addr: str,
        store_dir: str,
        worker_id: str | None = None,
    ):
        # "client": a remote driver outside the cluster (reference: Ray
        # Client, python/ray/util/client/) — no local node daemon, so
        # leases always go through the head and large puts upload to an
        # anchor node whose store serves the cluster.
        self.mode = mode
        self.head_addr = head_addr
        self.node_addr = node_addr
        self.store = ObjectStore(store_dir)
        self.worker_id = worker_id
        self.addr: str | None = None  # own serve addr (ownership identity)
        self.server = rpc.Server(self._handle)
        self.head: rpc.Connection | None = None
        self.node: rpc.Connection | None = None
        self._conns: dict[str, rpc.Connection] = {}
        self._conn_locks: dict[str, asyncio.Lock] = {}

        # memory store: oid hex → ("value", inband, buffers) | ("error", e)
        # | ("in_store", holder_node_addr | None) — the holder addr names
        # the node whose store has the bytes (multi-node pulls)
        self.memory: dict[str, tuple] = {}
        self._waiters: dict[str, list[asyncio.Future]] = {}
        # Object directory for objects this worker owns: oid hex → node
        # addrs holding a store copy beyond the primary (pullers register
        # after caching; reference: ownership_object_directory.h location
        # updates). Lets later pulls stripe across many sources.
        self._locations: dict[str, set] = {}
        # Drain-time evacuation watch (armed on first in_store record).
        self._drain_evac_armed = False

        # function table
        self._exported: dict[int, str] = {}  # id(fn) → fn_id hex
        self._fn_cache: dict[str, Any] = {}  # fn_id hex → callable/class

        # Lease pools: sched key → {"free": [(lease, idle_since)],
        # "waiters": deque[Future], "inflight": int}. A finished task's
        # lease is handed straight to the next queued task of the same
        # scheduling class — no node round-trip on the steady-state path
        # (reference: normal_task_submitter.h lease caching + pipelined
        # lease requests, ClusterSizeBasedLeaseRequestRateLimiter :74);
        # free leases return to the node after an idle timeout so they
        # don't pin resources (ReturnWorkerLease).
        self._lease_pools: dict[tuple, dict] = {}
        self._lease_cap = 8              # max parked free leases per key
        self._max_inflight_leases = 16   # max pending lease requests per key
        self._lease_idle_s = 1.0
        self._lease_reaper: asyncio.Task | None = None

        # worker-side execution
        self._exec_pool = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="ray_tpu_exec"
        )
        self._exec_queue: asyncio.Queue | None = None
        self._exec_task: asyncio.Task | None = None
        self._actor_instance: Any = None
        self._actor_id: str | None = None
        # Async (coroutine) actor methods run concurrently, out of order,
        # bounded by max_concurrency (reference: asyncio actors via
        # OutOfOrderActorSchedulingQueue + ConcurrencyGroupManager fibers,
        # core_worker/task_execution/fiber.h).
        self._async_sema = asyncio.Semaphore(100)

        self._put_index = 0
        self._root_task = TaskID.random()
        self._anchor: tuple[str, rpc.Connection] | None = None  # client mode

        # actor_id → freshest known address (updated on head-driven
        # restarts; handles carry the birth address only).
        self._actor_addrs: dict[str, str] = {}

        # Streaming generator tasks this process owns: task_id → queue of
        # ("item", oid_hex) | ("error", exc) | ("done",); plus a count of
        # items delivered so far (gates retries: only an undelivered
        # stream may be resubmitted).
        self._generators: dict[str, asyncio.Queue] = {}
        self._gen_delivered: dict[str, int] = {}
        # task_id → current submission attempt: reports from a PREVIOUS
        # attempt (a worker that died after sending but before we saw the
        # item) are rejected, so a retried stream can never deliver
        # duplicates.
        self._gen_attempt: dict[str, int] = {}

        # Device-tensor store (reference: gpu_object_store.py in
        # python/ray/experimental/gpu_object_manager/): values returned
        # by tensor-transport actor methods stay HERE, in the producing
        # worker, on device; only metadata travels through the normal
        # result path. Other actors fetch the payload point-to-point
        # (collective send/recv when a shared group exists, direct rpc
        # otherwise) — never through the host object store.
        self.tensor_store: dict[str, Any] = {}
        # Received-tensor LRU (consumer side): repeat gets of the same
        # tensor ref hit this instead of re-transferring the payload
        # (reference: gpu_object_store caches received tensors).
        self._tensor_cache: collections.OrderedDict[str, Any] = (
            collections.OrderedDict()
        )
        self._tensor_cache_cap = 64
        # Producer-side export buffers for chunked tensor fetches:
        # token → (serialized blob segments, total, created_at).
        self._tensor_exports: dict[str, tuple] = {}

        # Lineage: task_id → resubmit info for normal-task returns, so a
        # lost store object can be reconstructed by re-executing its
        # creating task (reference: ObjectRecoveryManager
        # object_recovery_manager.h:41 + TaskManager lineage,
        # task_manager.h:175). Bounded FIFO: oldest lineage is dropped
        # first (its objects then fail as unreconstructable, like the
        # reference under lineage eviction).
        self._lineage: collections.OrderedDict[str, dict] = (
            collections.OrderedDict()
        )
        self._lineage_cap = 16384
        # Entry count alone is not enough: each entry retains the full
        # serialized args, so lineage is ALSO evicted on a byte budget
        # (reference: RAY_max_lineage_bytes-style eviction in
        # task_manager.h:175).
        self._lineage_bytes = 0
        self._oid_to_task: dict[str, str] = {}
        # task_id → in-flight reconstruction future (dedupe).
        self._reconstructing: dict[str, asyncio.Future] = {}

        # Cancellation state for normal tasks this process drives:
        # task_id → {"cancelled": bool, "lease": current lease | None}
        # (reference: CoreWorker::CancelTask — queued tasks fail fast,
        # running ones are force-killed at the worker).
        self._cancel_state: dict[str, dict] = {}

        # Task-event buffer, flushed to the head periodically (reference:
        # worker-side TaskEventBuffer core_worker/task_event_buffer.h →
        # GcsTaskManager). Bounded: observability must not OOM the worker.
        self._task_events: list[dict] = []
        self._event_flusher: asyncio.Task | None = None

        # Extension RPC handlers (collective groups, channels, ...):
        # name → async fn(conn=..., **kw). Checked before built-ins.
        self.ext_handlers: dict[str, Any] = {}
        # Head pubsub: channel → sync callback(msg). Populated via
        # subscribe(); re-issued on head reconnect.
        self._push_handlers: dict[str, Any] = {}

    # ----------------------------------------------------------- startup
    async def start(self, host: str = "127.0.0.1") -> str:
        port = await self.server.start(host, 0)
        self.addr = f"{host}:{port}"
        # Reconnecting head client: a head restart is transparent to
        # drivers/workers (idempotent queries retry across the outage;
        # reference: RetryableGrpcClient wrapping the gcs client).
        # Subscriptions re-issue on reconnect — the restarted head's
        # subscriber table starts empty (reference: resubscribe on
        # NotifyGCSRestart).
        self.head = await rpc.ReconnectingClient(
            self.head_addr,
            on_push=self._on_head_push,
            on_reconnect=self._resubscribe,
            reconnect_timeout=config.get("HEAD_RECONNECT_S"),
        ).connect()
        # Observer connections (read-only CLI/dashboard) have no local
        # node: head queries and object reads work, task submission does
        # not.
        if self.node_addr:
            self.node = await rpc.connect(self.node_addr)
        self._exec_queue = asyncio.Queue()
        self._exec_task = asyncio.ensure_future(self._exec_loop())
        self._lease_reaper = asyncio.ensure_future(self._lease_reap_loop())
        self._event_flusher = asyncio.ensure_future(self._flush_events_loop())
        return self.addr

    def _on_head_push(self, payload):
        """PUSH frame from the head (pubsub delivery). A "batch" frame
        carries a whole coalesced tick of messages in publish order
        (the head batches mass-death/drain fan-out); handlers still see
        one message at a time."""
        try:
            handler = self._push_handlers.get(payload.get("channel"))
            if handler is None:
                return
            if "batch" in payload:
                for msg in payload["batch"]:
                    handler(msg)
            else:
                handler(payload.get("msg"))
        except Exception:  # noqa: BLE001 - a bad handler must not kill recv
            logger.warning(
                "pubsub handler for channel %r raised",
                payload.get("channel"), exc_info=True,
            )

    async def subscribe(self, channel: str, handler) -> None:
        """Subscribe to a head pubsub channel; `handler(msg)` runs on the
        runtime loop for each delivery. Survives head restarts."""
        self._push_handlers[channel] = handler
        await self.head.call("subscribe", channel=channel)

    async def _resubscribe(self, conn) -> None:
        for channel in self._push_handlers:
            await conn.call("subscribe", channel=channel)

    async def stop(self):
        if self._exec_task:
            self._exec_task.cancel()
        if self._lease_reaper:
            self._lease_reaper.cancel()
        if self._event_flusher:
            self._event_flusher.cancel()
            await self._flush_events()  # final drain
        self._exec_pool.shutdown(wait=False, cancel_futures=True)
        for conn in list(self._conns.values()):
            await conn.close()
        if self.head:
            await self.head.close()
        if self.node:
            await self.node.close()
        await self.server.stop()

    async def _connect(self, addr: str, retries: int = 3) -> rpc.Connection:
        conn = self._conns.get(addr)
        if conn is not None and not conn._closed:
            return conn
        from ray_tpu_torch._private.sanitize import maybe_async_lock

        lock = self._conn_locks.setdefault(
            addr, maybe_async_lock(f"core_worker.conn.{addr}"))
        async with lock:
            conn = self._conns.get(addr)
            if conn is not None and not conn._closed:
                return conn
            conn = await rpc.connect(addr, retries=retries)
            self._conns[addr] = conn
            return conn

    # ---------------------------------------------------- function table
    async def export_function(self, fn: Any) -> str:
        key = id(fn)
        fn_id = self._exported.get(key)
        if fn_id is not None:
            return fn_id
        blob = serialize(fn).materialize_buffers()
        data = blob.inband + b"".join(blob.buffers)
        fn_id = hashlib.sha1(data).hexdigest()[: FunctionID.LENGTH * 2]
        await self.head.call(
            "kv_put", key=f"fn:{fn_id}", value=data, overwrite=True
        )
        self._exported[key] = fn_id
        self._fn_cache[fn_id] = fn
        return fn_id

    async def _fetch_function(self, fn_id: str) -> Any:
        # "xfn:<name>" = cross-language registry entry (_private/xlang
        # register_function): the id IS the KV key, named by the
        # registrar rather than content-hashed — and therefore MUTABLE
        # (re-register/unregister), so never cached: a pooled worker
        # must not keep executing a stale implementation.
        if fn_id.startswith("xfn:"):
            reply = await self.head.call("kv_get", key=fn_id)
            if not reply["ok"]:
                raise RayTaskError(
                    f"cross-language function {fn_id[4:]!r} is not "
                    "registered"
                )
            return deserialize(reply["value"])
        fn = self._fn_cache.get(fn_id)
        if fn is not None:
            return fn
        reply = await self.head.call("kv_get", key=f"fn:{fn_id}")
        if not reply["ok"]:
            raise RayTaskError(f"function {fn_id} not found in cluster KV")
        fn = deserialize(reply["value"])
        self._fn_cache[fn_id] = fn
        return fn

    # ------------------------------------------------------------- args
    def _encode_args(self, args: Sequence, kwargs: dict) -> list:
        """Top-level ObjectRef args go by-ref; everything else by value
        (reference: LocalDependencyResolver dependency_resolver.h:36)."""
        from ray_tpu_torch.api import ObjectRef

        encoded = []
        for slot, value in [(None, a) for a in args] + list(kwargs.items()):
            if isinstance(value, ObjectRef):
                encoded.append((slot, "ref", value.hex, value.owner_addr))
            else:
                s = serialize(value).materialize_buffers()
                encoded.append((slot, "val", s.inband, s.buffers))
        return encoded

    def _encode_args_mp(self, args: Sequence, kwargs: dict) -> list:
        """Cross-language args: plain msgpack only (numbers, strings,
        bytes, lists, maps) — a foreign worker cannot unpickle, and
        refs would need an owner protocol it does not speak."""
        if kwargs:
            raise TypeError(
                "cross-language calls take positional arguments only"
            )
        encoded = []
        for value in args:
            try:
                encoded.append((None, "mp", rpc.pack_frame(value)))
            except (TypeError, ValueError) as e:
                raise TypeError(
                    "cross-language arguments must be msgpack-encodable "
                    f"plain data: {e}"
                ) from None
        return encoded

    async def _decode_args(self, encoded: list) -> tuple[list, dict]:
        args, kwargs = [], {}
        for entry in encoded:
            slot = entry[0]
            if entry[1] == "ref":
                value = await self._get_one(entry[2], entry[3], timeout=None)
            elif entry[1] == "mp":
                # Cross-language caller: plain msgpack data, never
                # pickle (reference: cross-language serialization).
                value = rpc.unpack_frame(entry[2])
            else:
                value = deserialize(entry[2], entry[3])
            if slot is None:
                args.append(value)
            else:
                kwargs[slot] = value
        return args, kwargs

    # ------------------------------------------------------ memory store
    def _store_result(self, oid_hex: str, record: tuple):
        self.memory[oid_hex] = record
        if record and record[0] == "in_store":
            # Store-resident bytes can sit on a node that later drains:
            # start watching drain fan-out the first time we own one, so
            # we can push sole copies to a healthy peer before the node
            # retires (reference: the raylet's spill-before-exit path).
            self._arm_drain_evacuation()
        for fut in self._waiters.pop(oid_hex, []):
            if not fut.done():
                fut.set_result(None)

    async def _wait_local(self, oid_hex: str, timeout: float | None):
        if oid_hex in self.memory:
            return
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(oid_hex, []).append(fut)
        try:
            await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise GetTimeoutError(f"timed out waiting for {oid_hex[:12]}…")

    def _read_record(self, oid_hex: str):
        """memory-store record → python value (may raise stored error)."""
        kind, *rest = self.memory[oid_hex]
        if kind == "error":
            raise rest[0]
        if kind == "value":
            return deserialize(rest[0], rest[1])
        if kind == "in_store":
            view = self.store.get(ObjectID.from_hex(oid_hex))
            if view is not None:
                return deserialize(view.inband, view.buffers)
            # Not in THIS node's store: the record may carry the holding
            # node's address (multi-node result) — callers in async
            # context pull it chunked via _maybe_pull_record.
            holder = rest[0] if rest else None
            if holder:
                raise _NeedsPull(holder)
            raise ObjectLostError(f"object {oid_hex[:12]}… lost from store")
        if kind == "tensor":
            if oid_hex in self.tensor_store:  # reading our own tensor
                return self.tensor_store[oid_hex]
            if oid_hex in self._tensor_cache:  # previously fetched
                self._tensor_cache.move_to_end(oid_hex)
                return self._tensor_cache[oid_hex]
            raise _NeedsTensor(rest[0])
        raise AssertionError(kind)

    @staticmethod
    def _deadline_of(timeout: float | None, what: str):
        """One deadline for a whole multi-stage read: returns a
        ``remaining()`` closure that yields the leftover budget and
        raises GetTimeoutError once it is spent."""
        loop = asyncio.get_running_loop()
        deadline = None if timeout is None else loop.time() + timeout

        def remaining():
            if deadline is None:
                return None
            left = deadline - loop.time()
            if left <= 0:
                raise GetTimeoutError(f"timed out on {what}")
            return left

        return remaining

    async def _maybe_pull_record(self, oid_hex: str, timeout=None):
        """_read_record + transparent chunked pull for remote-store
        records (reference: raylet PullManager drives chunked Push from
        the holding node, pull_manager.h:50). A lost object (holder node
        dead, store copy evicted) triggers lineage reconstruction: the
        creating task is re-executed and the read retried (reference:
        ObjectRecoveryManager object_recovery_manager.h:41). ``timeout``
        bounds the WHOLE sequence (pulls + reconstructions)."""
        remaining = self._deadline_of(timeout, f"object {oid_hex[:12]}…")
        while True:
            try:
                return self._read_record(oid_hex)
            except _NeedsTensor as need:
                return await self._fetch_tensor(
                    oid_hex, need.meta, remaining()
                )
            except _NeedsPull as need:
                try:
                    from ray_tpu_torch.runtime import transfer

                    conns, addr_of = await transfer.connect_sources(
                        self._locations.get(oid_hex),
                        need.holder_addr,
                        self.node_addr,
                        lambda a: self._connect(a, retries=1),
                    )
                    return await self._pull_remote(
                        ObjectID.from_hex(oid_hex),
                        conns,
                        None,
                        remaining(),
                        addr_of,
                    )
                except GetTimeoutError:
                    raise
                except (rpc.ConnectionLost, rpc.RpcError, ObjectLostError) as e:
                    if not await self._reconstruct(oid_hex, remaining()):
                        hit = await self._remote_tier_fetch(oid_hex)
                        if hit is not None:
                            return hit[1]
                        raise ObjectLostError(
                            f"object {oid_hex[:12]}… lost (holder "
                            f"{need.holder_addr} unreachable) and not "
                            f"reconstructable: {e}"
                        ) from e
            except ObjectLostError:
                if not await self._reconstruct(oid_hex, remaining()):
                    hit = await self._remote_tier_fetch(oid_hex)
                    if hit is not None:
                        return hit[1]
                    raise

    # ------------------------------------------- drain-time evacuation
    def _arm_drain_evacuation(self) -> None:
        """Idempotently subscribe to drain fan-out (via the collective
        death watch — pubsub allows one handler per channel, so drain
        notices reach us through drain.add_listener, not a second
        subscription)."""
        if self._drain_evac_armed or not config.get(
            "OBJECT_DRAIN_EVACUATION"
        ):
            return
        if self.head is None or self.mode == "client":
            return  # client drivers can't pull from node stores anyway
        self._drain_evac_armed = True
        from ray_tpu_torch.runtime import drain

        drain.add_listener(self._on_drain_notice)
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        from ray_tpu_torch import collective as _coll

        t = loop.create_task(_coll._ensure_death_watch(self))
        t.add_done_callback(lambda t: t.exception())

    def _on_drain_notice(self, notice: dict) -> None:
        """drain.record() callback (sync, runs in the pubsub handler):
        schedule the actual evacuation on the loop."""
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        t = loop.create_task(self._evacuate_for_drain(notice))
        t.add_done_callback(lambda t: t.exception())

    async def _evacuate_for_drain(self, notice: dict) -> None:
        """Push owned objects whose ONLY copies live on the draining
        node to a healthy peer (or, with no peer, to the remote spill
        tier) while the node is still alive to serve pulls. Without
        this, every sole-copy object on the node becomes a lineage
        reconstruction — or a loss — the moment it retires."""
        drain_addr = notice.get("node_addr")
        if not drain_addr or self.head is None:
            return
        victims: list[str] = []
        for oid_hex, rec in list(self.memory.items()):
            if not rec or rec[0] != "in_store":
                continue
            primary = rec[1] if len(rec) > 1 else None
            locs = set(self._locations.get(oid_hex) or ())
            locs.add(primary or self.node_addr)
            locs.discard(None)
            if locs and locs <= {drain_addr}:
                victims.append(oid_hex)
        if not victims:
            return
        from ray_tpu_torch.runtime.drain import EVACUATED

        try:
            status = await self.head.call("cluster_status")
        except (rpc.ConnectionLost, rpc.RpcError):
            return
        draining = set(status.get("draining") or {})
        peers = [
            n["addr"]
            for nid, n in sorted((status.get("nodes") or {}).items())
            if n.get("addr")
            and n["addr"] != drain_addr
            and nid not in draining
        ]
        if peers:
            try:
                peer_addr = peers[0]
                peer = await self._connect(peer_addr, retries=1)
                reply = await peer.call(
                    "prefetch_objects", oids=victims, owner_addr=self.addr
                )
            except (rpc.ConnectionLost, rpc.RpcError) as e:
                EVACUATED.inc(len(victims), tags={"outcome": "failed"})
                logger.warning(
                    "drain evacuation to peer %s failed: %s", peers[0], e
                )
                return
            results = reply.get("results") or {}
            for oid_hex in victims:
                if results.get(oid_hex):
                    self._locations.setdefault(oid_hex, set()).add(
                        peer_addr
                    )
                    rec = self.memory.get(oid_hex)
                    if rec and rec[0] == "in_store":
                        # Re-point the primary off the doomed node so
                        # reads never even try it post-retirement. A
                        # holder-less record means OUR node's store —
                        # which is the one draining, or the object
                        # wouldn't be a victim.
                        self.memory[oid_hex] = ("in_store", peer_addr)
                    self._locations[oid_hex].discard(drain_addr)
                    EVACUATED.inc(1, tags={"outcome": "peer"})
                else:
                    EVACUATED.inc(1, tags={"outcome": "failed"})
            return
        # No healthy peer: spill to the remote tier (the node-side
        # sweep covers objects in ITS store; this covers records whose
        # holder is the draining node but we own the directory entry).
        from ray_tpu_torch.checkpoint import remote as _remote

        tier = _remote.get_tier()
        if tier is None:
            EVACUATED.inc(len(victims), tags={"outcome": "failed"})
            return
        from ray_tpu_torch.runtime import transfer

        for oid_hex in victims:
            try:
                conn = await self._connect(drain_addr, retries=1)
                inband, buffers = await transfer.pull_object(
                    oid_hex, [conn], 60.0,
                    chunk_bytes=self.PULL_CHUNK_BYTES,
                )
                seg_lens = [len(inband)] + [len(b) for b in buffers]
                payload = bytes(inband) + b"".join(
                    bytes(b) for b in buffers
                )
                blob = _remote.pack_object(seg_lens, payload)
                await asyncio.to_thread(tier.put_object, oid_hex, blob)
                EVACUATED.inc(1, tags={"outcome": "remote_tier"})
            except (
                rpc.ConnectionLost,
                rpc.RpcError,
                ObjectLostError,
                _remote.RemoteTierError,
            ) as e:
                EVACUATED.inc(1, tags={"outcome": "failed"})
                logger.warning(
                    "drain evacuation of %s to remote tier failed: %s",
                    oid_hex[:12], e,
                )

    async def _remote_tier_fetch(
        self, oid_hex: str
    ) -> tuple[str, Any] | None:
        """Last rung of the resolution ladder: a drain-evacuated copy in
        the remote spill tier. Returns ("hit", value) or None — the
        object's value may itself be None, so a sentinel tuple
        disambiguates."""
        from ray_tpu_torch.checkpoint import remote as _remote

        try:
            tier = _remote.get_tier()
            if tier is None:
                return None
            blob = await asyncio.to_thread(tier.get_object, oid_hex)
        except _remote.RemoteTierError as e:
            logger.debug("remote-tier fetch of %s failed: %s",
                         oid_hex[:12], e)
            return None
        if blob is None:
            return None
        seg_lens, payload = _remote.unpack_object(blob)
        mv, segs, pos = memoryview(payload), [], 0
        for n in seg_lens:
            segs.append(bytes(mv[pos:pos + n]))
            pos += n
        inband, buffers = segs[0], segs[1:]
        try:
            self.store.put(
                ObjectID.from_hex(oid_hex), Serialized(inband, buffers)
            )
            self.memory[oid_hex] = ("in_store",)
        # tpulint: allow(broad-except reason=local re-cache is best-effort; the tier copy stays authoritative and the value is returned regardless)
        except Exception:
            pass
        logger.info("restored object %s… from the remote tier",
                    oid_hex[:12])
        return ("hit", deserialize(inband, buffers))

    # -------------------------------------------------------------- put
    async def put(self, value: Any):
        from ray_tpu_torch.api import ObjectRef

        self._put_index += 1
        oid = ObjectID.for_put(self._root_task, self._put_index)
        data = serialize(value)
        if data.total_bytes() <= INLINE_MAX_BYTES and self.mode != "client":
            m = data.materialize_buffers()
            self._store_result(oid.hex(), ("value", m.inband, m.buffers))
        elif self.mode == "client":
            # Remote driver: our private store is unreachable from the
            # cluster — upload the bytes (EVERY put, inline-sized too:
            # the client may sit behind NAT) to an anchor node whose
            # store serves every worker's pull (reference: Ray Client
            # server-side put). The ANCHOR becomes the ref's owner
            # address so workers resolve it against the cluster node,
            # never dialing back into the client.
            anchor_addr, anchor = await self._anchor_node()
            m = data.materialize_buffers()
            if data.total_bytes() <= self.PULL_CHUNK_BYTES:
                await anchor.call(
                    "put_object",
                    oid_hex=oid.hex(),
                    inband=m.inband,
                    buffers=m.buffers,
                )
            else:
                await self._upload_chunked(anchor, oid.hex(), m)
            self._store_result(oid.hex(), ("in_store", anchor_addr))
            return ObjectRef(oid.hex(), anchor_addr)
        else:
            self.store.put(oid, data)
            self._store_result(oid.hex(), ("in_store",))
        return ObjectRef(oid.hex(), self.addr)

    async def _upload_chunked(self, anchor, oid_hex: str, m):
        """Stream a large client put to the anchor node in 5 MiB windows
        (mirrors the pull protocol's chunking; one oversized frame would
        hit the rpc frame cap)."""
        segs = [m.inband, *m.buffers]
        reply = await anchor.call(
            "put_object_begin",
            oid_hex=oid_hex,
            seg_lens=[len(s) for s in segs],
        )
        if not reply.get("ok"):
            raise rpc.RpcError(reply.get("error", "put_object_begin failed"))
        token = reply["token"]
        from ray_tpu_torch.runtime.object_store import segment_window

        class _Segs:  # duck-typed view for segment_window
            inband = segs[0]
            buffers = segs[1:]

        total = sum(len(s) for s in segs)
        offset = 0
        while offset < total:
            chunk = segment_window(_Segs, offset, self.PULL_CHUNK_BYTES)
            ack = await anchor.call(
                "put_object_chunk", token=token, offset=offset, data=chunk
            )
            if not ack.get("ok"):
                raise rpc.RpcError("put_object_chunk failed")
            offset += len(chunk)
        done = await anchor.call("put_object_commit", token=token)
        if not done.get("ok"):
            raise rpc.RpcError("put_object_commit failed")

    async def _anchor_node(self) -> tuple[str, rpc.Connection]:
        if self._anchor is not None:
            addr, conn = self._anchor
            if not conn._closed:
                return self._anchor
        pick = await self.head.call("pick_node", resources={})
        if not pick.get("ok"):
            raise rpc.RpcError("client mode: no cluster node to anchor on")
        conn = await self._connect(pick["addr"])
        self._anchor = (pick["addr"], conn)
        return self._anchor

    # -------------------------------------------------------------- get
    async def _get_one(
        self,
        oid_hex: str,
        owner_addr: str,
        timeout: float | None,
        _recon: int = 2,
    ) -> Any:
        """Resolve one ref. ``timeout`` is a SINGLE deadline across all
        stages (owner lookup, chunked pull, reconstruction). Values that
        are already local resolve even with timeout=0 (the deadline only
        gates stages that must do remote work)."""
        if oid_hex in self.memory:
            # _maybe_pull_record tries the synchronous read before its
            # own deadline is ever consulted.
            return await self._maybe_pull_record(oid_hex, timeout)
        oid = ObjectID.from_hex(oid_hex)
        view = self.store.get(oid)
        if view is not None:
            return deserialize(view.inband, view.buffers)
        remaining = self._deadline_of(timeout, f"object {oid_hex[:12]}…")
        if owner_addr == self.addr or oid_hex in self._waiters or (
            owner_addr is None
        ):
            await self._wait_local(oid_hex, remaining())
            return await self._maybe_pull_record(oid_hex, remaining())
        # Ask the owner (reference: OwnershipBasedObjectDirectory).
        conn = await self._connect(owner_addr)
        try:
            reply = await asyncio.wait_for(
                conn.call("get_object", oid_hex=oid_hex), remaining()
            )
        except asyncio.TimeoutError:
            raise GetTimeoutError(
                f"timed out asking the owner for {oid_hex[:12]}…"
            )
        if reply["kind"] == "value":
            return deserialize(reply["inband"], reply["buffers"])
        if reply["kind"] == "tensor":
            return await self._fetch_tensor(
                oid_hex, reply["meta"], remaining()
            )
        if reply["kind"] == "in_store":
            view = self.store.get(oid)
            if view is not None:
                return deserialize(view.inband, view.buffers)
            # The object lives in a node store elsewhere: pull it in
            # pipelined chunks, striped across EVERY node known to hold
            # a copy (reference: pull_manager.h:50 windowed chunk
            # requests; locations from the owner's directory like
            # ownership_object_directory.h), then cache it locally. The
            # owner connection rides along as last-resort source, so
            # stale/evicted holder sets can't lose a servable object.
            from ray_tpu_torch.runtime import transfer

            srcs, addr_of = await transfer.connect_sources(
                reply.get("holders"),
                reply.get("holder"),
                self.node_addr,
                lambda a: self._connect(a, retries=1),
                fallback=conn,
            )
            try:
                return await self._pull_remote(
                    oid, srcs, conn, remaining(), addr_of
                )
            except GetTimeoutError:
                raise
            except (rpc.ConnectionLost, rpc.RpcError, ObjectLostError) as e:
                # Holder gone or copy evicted: ask the OWNER to
                # reconstruct via lineage, then re-resolve.
                if _recon > 0:
                    try:
                        fixed = await asyncio.wait_for(
                            conn.call(
                                "reconstruct_object", oid_hex=oid_hex
                            ),
                            remaining(),
                        )
                    except asyncio.TimeoutError:
                        raise GetTimeoutError(
                            f"timed out reconstructing {oid_hex[:12]}…"
                        ) from e
                    if fixed.get("ok"):
                        return await self._get_one(
                            oid_hex, owner_addr, remaining(), _recon - 1
                        )
                hit = await self._remote_tier_fetch(oid_hex)
                if hit is not None:
                    return hit[1]
                raise ObjectLostError(
                    f"object {oid_hex[:12]}… lost and not "
                    f"reconstructable by its owner: {e}"
                ) from e
        if reply["kind"] == "error":
            raise deserialize(reply["inband"])
        raise AssertionError(reply["kind"])

    PULL_CHUNK_BYTES = 5 * 1024 * 1024  # object_manager_default_chunk_size

    async def _pull_remote(
        self, oid, srcs: list, owner_conn, timeout, addr_of: dict | None = None
    ):
        """Pipelined multi-source pull of a store-resident object
        (reference: pull_manager.h:50). ``timeout`` bounds the WHOLE
        pull, matching get()'s single-deadline semantics. On success the
        copy is cached in this node's store and the owner is told about
        the new location, so later pullers fan in from here too; holders
        that proved dead are reported for pruning."""
        from ray_tpu_torch.runtime import transfer

        oid_hex = oid.hex()
        failed: set = set()
        try:
            inband, buffers = await transfer.pull_object(
                oid_hex,
                srcs,
                timeout,
                chunk_bytes=self.PULL_CHUNK_BYTES,
                failed=failed,
            )
        finally:
            if failed and addr_of:
                bad = [addr_of[c] for c in failed if c in addr_of]
                if bad:
                    await self._prune_locations(oid_hex, bad, owner_conn)
        # Cache locally so later readers on this node hit the store.
        try:
            self.store.put(oid, Serialized(inband, list(buffers)))
        # tpulint: allow(broad-except reason=local cache put is best-effort; the value is already in hand and returned to the caller regardless)
        except Exception:
            pass
        else:
            if self.node_addr:
                if owner_conn is None:
                    # We ARE the owner (self-owned object whose bytes
                    # lived on another node): record the new copy
                    # directly.
                    self._locations.setdefault(oid_hex, set()).add(
                        self.node_addr
                    )
                else:
                    try:
                        await owner_conn.call(
                            "object_location_add",
                            oid_hex=oid_hex,
                            addr=self.node_addr,
                        )
                    except (rpc.ConnectionLost, rpc.RpcError):
                        pass  # owner gone; registry dies with it
        return deserialize(inband, buffers)


    async def broadcast_object(
        self, ref, timeout: float | None = None
    ) -> dict:
        """Relay-broadcast a store-resident object into every node's
        store in doubling waves (reference: push_manager.h:28 pipelined
        pushes — a put-then-fan-out there floods from the single owner;
        here each wave's finishers register as locations, so wave k
        pulls stripe across 2^k sources: a broadcast tree through node
        stores)."""
        oid_hex = ref.hex
        owner_addr = ref.owner_addr or self.addr
        table = await self.head.call("node_table")
        addrs = [n["addr"] for n in table.values() if n.get("addr")]
        conn = await self._connect(owner_addr)
        reply = await conn.call("get_object", oid_hex=oid_hex)
        if reply["kind"] == "value":
            # Inline object: nothing store-resident to relay.
            return {"nodes": 0, "bytes": 0, "inline": True}
        if reply["kind"] != "in_store":
            raise ValueError(
                f"broadcast needs a store-resident object, got "
                f"{reply['kind']!r}"
            )
        holders = set(reply.get("holders") or [])
        if reply.get("holder"):
            holders.add(reply["holder"])
        pending = [a for a in addrs if a not in holders]
        sources = max(1, len(holders))
        # Wave width doubles with the source set but is capped: more
        # concurrent pulls than links just thrash buffers (measured on
        # loopback; real clusters bound this by per-node NIC anyway).
        max_wave = 4
        transferred = cached = waves = 0
        failed: list = []
        while pending:
            width = min(sources, max_wave)
            wave, pending = pending[:width], pending[width:]
            waves += 1

            async def prefetch(addr):
                c = await self._connect(addr, retries=1)
                return await c.call(
                    "prefetch_object",
                    oid_hex=oid_hex,
                    owner_addr=owner_addr,
                    timeout=timeout or 120.0,
                )

            results = await asyncio.gather(
                *(prefetch(a) for a in wave), return_exceptions=True
            )
            for addr, r in zip(wave, results):
                # A dead node (e.g. not yet swept from the node table)
                # is skipped, not fatal: the live nodes still get their
                # copy and the caller learns who failed.
                if isinstance(r, BaseException) or not r.get("ok"):
                    failed.append((addr, repr(r)))
                elif r.get("cached"):
                    cached += 1
                    sources += 1
                else:
                    transferred += 1
                    sources += 1
        if transferred + cached == 0 and failed:
            raise ObjectLostError(
                f"broadcast of {oid_hex[:12]}… reached no node: {failed}"
            )
        return {
            "nodes": transferred,
            "cached": cached,
            "failed": failed,
            # Relay-tree depth: doubling waves mean ~log2(n) + cap
            # spill, NOT n sequential pushes — floored in perf CI.
            "waves": waves,
            "inline": False,
        }

    async def get(self, refs: Sequence, timeout: float | None = None) -> list:
        return list(
            await asyncio.gather(
                *(self._get_one(r.hex, r.owner_addr, timeout) for r in refs)
            )
        )

    async def wait(
        self,
        refs: Sequence,
        num_returns: int,
        timeout: float | None,
        fetch_local: bool = True,
    ):
        """Split refs into (ready, not_ready) — reference: wait_manager.h."""

        async def ready(r):
            await self._get_one(r.hex, r.owner_addr, None)
            return r

        pending = {
            asyncio.ensure_future(ready(r)): r for r in refs
        }
        done_refs = []
        try:
            while pending and len(done_refs) < num_returns:
                done, _ = await asyncio.wait(
                    pending,
                    timeout=timeout,
                    return_when=asyncio.FIRST_COMPLETED,
                )
                if not done:
                    break  # timeout
                for fut in done:
                    r = pending.pop(fut)
                    # Objects that errored still count as ready.
                    done_refs.append(r)
        finally:
            for fut in pending:
                fut.cancel()
        not_ready = [r for r in refs if r not in done_refs]
        return done_refs, not_ready

    # ----------------------------------------------------- task submit
    async def submit_task(
        self,
        fn: Any,
        args: Sequence,
        kwargs: dict,
        num_returns: int = 1,
        resources: dict | None = None,
        max_retries: int = DEFAULT_RETRIES,
        actor: "ActorSubmitTarget | None" = None,
        placement: tuple | None = None,  # (node_addr, pg_id, bundle_index)
        runtime_env: dict | None = None,
        tensor_transport: Any = None,
        scheduling: dict | None = None,
        trace_ctx: dict | None = None,
    ) -> list:
        """Submit; returns ObjectRefs immediately, result delivery is
        async (the reply fulfils the local futures)."""
        from ray_tpu_torch.api import ObjectRef

        task_id = TaskID.random()
        streaming = num_returns == "streaming"
        if streaming:
            num_returns = 0
            self._generators[task_id.hex()] = asyncio.Queue()
        oids = [
            ObjectID.for_return(task_id, i).hex() for i in range(num_returns)
        ]
        for oid_hex in oids:
            self._waiters.setdefault(oid_hex, [])

        # Actor calls carry the method *name*; normal tasks export the
        # function to the cluster KV and carry its id. "cfn:<name>"
        # targets a function DEFINED in a foreign worker (C++
        # RAYTPU_REMOTE registration): nothing to export — the name is
        # resolved inside the executing worker's own registry, args and
        # results cross as msgpack (reference: cross_language.py
        # cpp_function + ray_remote.h).
        xlang_target = isinstance(fn, str) and fn.startswith("cfn:")
        if xlang_target:
            if num_returns != 1:
                # The foreign worker replies with exactly one msgpack
                # result; extra return refs would never resolve.
                raise ValueError(
                    "cross-language tasks return exactly one value "
                    f"(got num_returns={num_returns!r})"
                )
            fn_id = fn
        else:
            fn_id = fn if actor is not None else await self.export_function(fn)
        spec = {
            "task_id": task_id.hex(),
            "fn_id": fn_id,
            "name": (
                fn if isinstance(fn, str) else getattr(fn, "__name__", "")
            ),
            "args": (
                self._encode_args_mp(args, kwargs)
                if xlang_target
                else self._encode_args(args, kwargs)
            ),
            "num_returns": num_returns,
            "owner_addr": self.addr,
        }
        if xlang_target:
            spec["xlang"] = True
        if streaming:
            spec["streaming"] = True
            self._gen_attempt[task_id.hex()] = 0
        if tensor_transport is not None:
            spec["tensor_transport"] = tensor_transport
        if trace_ctx is None:
            from ray_tpu_torch.util import tracing

            trace_ctx = tracing.make_trace_ctx(spec["name"] or spec["fn_id"])
        if trace_ctx is not None:
            spec["trace"] = trace_ctx
        self.record_task_event(
            spec, "SUBMITTED", kind="actor_task" if actor else "task"
        )
        if actor is None and not streaming and max_retries > 0:
            # Lineage for reconstruction: enough to resubmit this task if
            # a store-resident return is later lost (actor methods are
            # not idempotent; streams replay only from the start — both
            # excluded, matching this runtime's retry semantics).
            entry_bytes = _spec_nbytes(spec)
            budget = config.get("MAX_LINEAGE_BYTES")
            if entry_bytes <= budget:
                # An entry larger than the whole budget is skipped
                # outright — recording it would evict every OTHER
                # entry first (destroying their reconstructability)
                # and then itself; its returns are simply
                # unreconstructable, like reference tasks past
                # RAY_max_lineage_bytes.
                self._lineage[task_id.hex()] = {
                    "spec": spec,
                    "oids": oids,
                    "bytes": entry_bytes,
                    "resources": resources,
                    "placement": placement,
                    "runtime_env": runtime_env,
                    "scheduling": scheduling,
                    "attempts_left": max_retries,
                }
                for oid_hex in oids:
                    self._oid_to_task[oid_hex] = task_id.hex()
                self._lineage_bytes += entry_bytes
                while self._lineage and (
                    len(self._lineage) > self._lineage_cap
                    or self._lineage_bytes > budget
                ):
                    old_tid, old = self._lineage.popitem(last=False)
                    self._lineage_bytes -= old.get("bytes", 0)
                    for oid_hex in old["oids"]:
                        self._oid_to_task.pop(oid_hex, None)
        asyncio.ensure_future(
            self._drive_task(
                spec, oids, resources, max_retries, actor, placement,
                runtime_env, scheduling,
            )
        )
        if streaming:
            return task_id.hex()
        return [ObjectRef(o, self.addr) for o in oids]

    async def _drive_task(
        self, spec, oids, resources, retries, actor, placement,
        runtime_env=None, scheduling=None,
    ):
        try:
            if actor is not None:
                errored = await self._drive_actor_task(spec, oids, actor)
            else:
                errored = await self._drive_normal_task(
                    spec, oids, resources, retries, placement, runtime_env,
                    scheduling,
                )
            self.record_task_event(
                spec, "FAILED" if errored else "FINISHED"
            )
        # tpulint: allow(broad-except reason=not swallowed - the error is recorded as the task FAILED event and stored as the result the owner reads)
        except Exception as e:
            self.record_task_event(
                spec,
                "CANCELLED" if isinstance(e, TaskCancelledError) else "FAILED",
                error=repr(e),
            )
            for oid_hex in oids:
                self._store_result(oid_hex, ("error", e))
            if spec.get("streaming"):
                q = self._generators.get(spec["task_id"])
                if q is not None:
                    q.put_nowait(("error", e))

    # ------------------------------------------------- lineage recovery
    async def _reconstruct(
        self, oid_hex: str, timeout: float | None = None
    ) -> bool:
        """Re-execute the task that created a lost object (reference:
        lineage reconstruction, object_recovery_manager.h:41). Returns
        True when a fresh result record is in place. Concurrent callers
        for the same task share ONE resubmission, which runs as a
        background task — a caller timing out (or being cancelled)
        neither cancels the re-execution nor strands other waiters."""
        task_id = self._oid_to_task.get(oid_hex)
        entry = self._lineage.get(task_id) if task_id else None
        if entry is None:
            return False
        inflight = self._reconstructing.get(task_id)
        if inflight is None:
            if entry["attempts_left"] <= 0:
                return False
            entry["attempts_left"] -= 1
            inflight = asyncio.ensure_future(
                self._do_reconstruct(task_id, entry)
            )
            self._reconstructing[task_id] = inflight
            inflight.add_done_callback(
                lambda _t: self._reconstructing.pop(task_id, None)
            )
        try:
            return await asyncio.wait_for(asyncio.shield(inflight), timeout)
        except asyncio.TimeoutError:
            raise GetTimeoutError(
                f"timed out while reconstructing {oid_hex[:12]}…"
            )

    async def _do_reconstruct(self, task_id: str, entry: dict) -> bool:
        self.record_task_event(entry["spec"], "RECONSTRUCTING")
        # Drop stale store-location records so fresh results land and
        # blocked readers wake on the new value. Inline ("value")
        # records are still good — keep them.
        for o in entry["oids"]:
            rec = self.memory.get(o)
            if rec is not None and rec[0] == "in_store":
                self.memory.pop(o, None)
                self.store.release(ObjectID.from_hex(o))
        try:
            errored = await self._drive_normal_task(
                entry["spec"],
                entry["oids"],
                entry["resources"],
                1,
                entry["placement"],
                entry["runtime_env"],
                entry.get("scheduling"),
            )
        # tpulint: allow(broad-except reason=not swallowed - the failure is stored as an error record so blocked readers fail with the cause)
        except Exception as e:
            # Leave an error record so readers that blocked on the
            # cleared oids fail with the cause instead of waiting
            # forever.
            for o in entry["oids"]:
                if o not in self.memory:
                    self._store_result(
                        o,
                        (
                            "error",
                            ObjectLostError(
                                f"object {o[:12]}… reconstruction "
                                f"failed: {e}"
                            ),
                        ),
                    )
            return False
        return not errored

    async def _on_reconstruct_object(self, conn, oid_hex: str):
        """Borrower-requested reconstruction: a non-owner whose pull
        failed asks the owner to re-execute the creating task."""
        return {"ok": await self._reconstruct(oid_hex)}

    # ------------------------------------------------------ cancellation
    async def cancel_task(self, oid_hex: str) -> bool:
        """Cancel the normal task producing ``oid_hex`` (reference:
        CoreWorker::CancelTask; python cancel semantics worker.py).
        Queued tasks fail fast with TaskCancelledError; a running task's
        worker is force-killed (execution threads cannot be safely
        interrupted — same as the reference's force path). Returns False
        when the task already finished."""
        from ray_tpu_torch._private.ids import TaskID

        task_id = oid_hex[: TaskID.LENGTH * 2]  # return ids embed it
        state = self._cancel_state.get(task_id)
        if state is None:
            return False
        state["cancelled"] = True
        lease = state.get("lease")
        if lease is not None:
            node_conn = lease.get("node_conn") or self.node
            if node_conn is not None:
                try:
                    await node_conn.call(
                        "kill_worker", worker_id=lease["worker_id"]
                    )
                except (rpc.ConnectionLost, rpc.RpcError):
                    pass
        else:
            # Still queued (possibly blocked on a lease wait that only
            # resolves when capacity frees): deliver the cancellation to
            # readers NOW — the drive loop notices and unwinds whenever
            # its lease finally arrives.
            err = TaskCancelledError(f"task {task_id[:12]}… was cancelled")
            for o in state.get("oids") or []:
                if o not in self.memory:
                    self._store_result(o, ("error", err))
        return True

    async def _on_cancel_task(self, conn, oid_hex: str):
        """Borrower-side cancel routed to the owner."""
        return {"ok": await self.cancel_task(oid_hex)}

    # ------------------------------------------------- tensor transport
    async def _fetch_tensor(self, oid_hex: str, meta: dict, timeout=None):
        """Resolve a tensor-transport ref: payload moves point-to-point
        from the producing actor (reference: gpu_object_manager
        transports — collective_tensor_transport.py / nixl). When this
        process shares the producer's collective group, the transfer
        rides the group's send/recv data plane; otherwise a chunked rpc
        fetch from the producer (never via the owner or object store).
        ``timeout`` is one deadline across every stage; fetched values
        are cached so repeat gets do not re-transfer."""
        if oid_hex in self.tensor_store:
            return self.tensor_store[oid_hex]  # we are the producer
        if oid_hex in self._tensor_cache:
            self._tensor_cache.move_to_end(oid_hex)
            return self._tensor_cache[oid_hex]
        remaining = self._deadline_of(timeout, f"tensor {oid_hex[:12]}…")
        value = await self._fetch_tensor_payload(oid_hex, meta, remaining)
        self._tensor_cache[oid_hex] = value
        while len(self._tensor_cache) > self._tensor_cache_cap:
            self._tensor_cache.popitem(last=False)
        return value

    async def _fetch_tensor_payload(self, oid_hex, meta, remaining):
        group_name = meta.get("group")
        if group_name is not None and meta.get("src_rank") is not None:
            from ray_tpu_torch import collective as col

            if col.is_group_initialized(group_name):
                g = col.get_group(group_name)
                if getattr(g, "rank", None) is not None and (
                    g.rank != meta["src_rank"]
                ):
                    # Ask the producer to post a send tagged with this
                    # ref; the payload lands in our group mailbox even
                    # before recv is posted, so send-then-recv is safe.
                    seq = int(oid_hex[:12], 16)
                    try:
                        conn = await self._connect(meta["src_addr"])
                        ack = await asyncio.wait_for(
                            conn.call(
                                "tensor_send",
                                oid_hex=oid_hex,
                                dst_rank=g.rank,
                                group_name=group_name,
                                seq=seq,
                            ),
                            remaining(),
                        )
                        if ack.get("ok"):
                            return await asyncio.wait_for(
                                g.recv(meta["src_rank"], seq=seq),
                                remaining(),
                            )
                    except asyncio.TimeoutError:
                        raise GetTimeoutError(
                            f"timed out fetching tensor {oid_hex[:12]}… "
                            f"over group {group_name!r}"
                        )
                    except (rpc.ConnectionLost, rpc.RpcError):
                        pass  # backend lacks send/recv etc. — rpc fetch
        conn = await self._connect(meta["src_addr"])
        try:
            reply = await asyncio.wait_for(
                conn.call("fetch_tensor", oid_hex=oid_hex), remaining()
            )
            if not reply.get("ok"):
                raise ObjectLostError(
                    f"tensor {oid_hex[:12]}… is gone from its producer "
                    f"(actor died or tensor freed)"
                )
            if not reply.get("chunked"):
                return deserialize(reply["inband"], reply["buffers"])
            # Large tensor: pull the serialized stream in store-sized
            # chunks (mirrors _pull_remote's 5 MiB protocol).
            token, total = reply["token"], reply["total"]
            seg_lens = reply["seg_lens"]
            parts = []
            offset = 0
            while offset < total:
                chunk = await asyncio.wait_for(
                    conn.call(
                        "fetch_tensor_chunk",
                        token=token,
                        offset=offset,
                        size=self.PULL_CHUNK_BYTES,
                    ),
                    remaining(),
                )
                if not chunk.get("ok"):
                    raise ObjectLostError(
                        f"tensor {oid_hex[:12]}… fetch failed mid-stream"
                    )
                parts.append(chunk["data"])
                offset += len(chunk["data"])
        except asyncio.TimeoutError:
            raise GetTimeoutError(
                f"timed out fetching tensor {oid_hex[:12]}…"
            )
        blob = b"".join(parts)
        segs = []
        pos = 0
        for n in seg_lens:
            segs.append(blob[pos : pos + n])
            pos += n
        return deserialize(segs[0], segs[1:])

    _TENSOR_EXPORT_CAP = 8

    async def _on_fetch_tensor(self, conn, oid_hex: str):
        if oid_hex not in self.tensor_store:
            return {"ok": False}
        value = self.tensor_store[oid_hex]
        data = serialize(value).materialize_buffers()
        total = data.total_bytes()
        if total <= self.PULL_CHUNK_BYTES:
            return {
                "ok": True,
                "inband": data.inband,
                "buffers": data.buffers,
            }
        # Oversized for one rpc frame: stash the serialized segments in
        # an export buffer and let the consumer pull windows.
        token = f"{oid_hex}:{id(data)}"
        self._tensor_exports[token] = (
            [data.inband, *data.buffers],
            total,
            time.time(),
        )
        # Evict only STALE exports (no chunk pulled for 60s): an active
        # stream must never lose its buffer mid-pull, so the cap is a
        # soft target under concurrent fetch bursts.
        if len(self._tensor_exports) > self._TENSOR_EXPORT_CAP:
            now = time.time()
            for key in list(self._tensor_exports):
                if key != token and now - self._tensor_exports[key][2] > 60:
                    del self._tensor_exports[key]
        return {
            "ok": True,
            "chunked": True,
            "token": token,
            "total": total,
            "seg_lens": [len(data.inband)] + [len(b) for b in data.buffers],
        }

    async def _on_fetch_tensor_chunk(
        self, conn, token: str, offset: int, size: int
    ):
        entry = self._tensor_exports.get(token)
        if entry is None:
            return {"ok": False}
        segs, total, _ts = entry
        # Refresh the staleness clock: an active stream is never evicted.
        self._tensor_exports[token] = (segs, total, time.time())
        out = bytearray()
        pos = 0
        for seg in segs:
            seg_len = len(seg)
            if offset < pos + seg_len and len(out) < size:
                start = max(0, offset - pos)
                take = min(seg_len - start, size - len(out))
                out += memoryview(seg)[start : start + take]
            pos += seg_len
            if len(out) >= size:
                break
        if offset + len(out) >= total:  # stream complete: free buffer
            self._tensor_exports.pop(token, None)
        return {"ok": True, "data": bytes(out)}

    async def _on_tensor_send(
        self, conn, oid_hex: str, dst_rank: int, group_name: str, seq: int
    ):
        """Producer side of a collective-path transfer: post a send of
        the stored tensor toward the requesting rank."""
        if oid_hex not in self.tensor_store:
            return {"ok": False}
        value = self.tensor_store[oid_hex]
        if not (hasattr(value, "shape") and hasattr(value, "dtype")):
            # Group send carries single arrays; pytrees take the rpc
            # fetch path instead.
            return {"ok": False, "error": "value is not a single array"}
        from ray_tpu_torch import collective as col

        if not col.is_group_initialized(group_name):
            return {"ok": False, "error": f"no group {group_name!r} here"}
        group = col.get_group(group_name)
        send = getattr(group, "send", None)
        if send is None:
            return {"ok": False, "error": "group backend has no send"}
        await send(value, dst_rank, seq=seq)
        return {"ok": True}

    async def _on_drop_tensor(self, conn, oid_hex: str):
        self.tensor_store.pop(oid_hex, None)
        return {"ok": True}

    async def free_tensor(self, oid_hex: str) -> bool:
        """Owner-side tensor freeing (reference: GPU objects are freed
        eagerly once out of scope; here freeing is explicit via
        ray_tpu_torch.experimental.free_tensors): drop the producer's pinned
        payload and poison the record."""
        rec = self.memory.get(oid_hex)
        if rec is None or rec[0] != "tensor":
            return False
        meta = rec[1]
        try:
            src = await self._connect(meta["src_addr"])
            await src.call("drop_tensor", oid_hex=oid_hex)
        except (rpc.ConnectionLost, rpc.RpcError):
            # Producer unreachable: leave the record intact so the
            # caller can retry (poisoning now would leak the pinned
            # payload forever if the producer is only briefly away).
            return False
        self._store_result(
            oid_hex,
            ("error", ObjectLostError(f"tensor {oid_hex[:12]}… was freed")),
        )
        return True

    async def _on_free_tensor(self, conn, oid_hex: str):
        return {"ok": await self.free_tensor(oid_hex)}

    # -------------------------------------------------------- task events
    def record_task_event(self, spec: dict, state: str, **extra):
        ev = {
            "task_id": spec.get("task_id", ""),
            "name": spec.get("name", spec.get("fn_id", ""))[:80],
            "state": state,
            "ts": time.time(),
            "worker": self.addr,
        }
        ev.update(extra)
        self._task_events.append(ev)
        if len(self._task_events) > 10000:  # drop oldest under pressure
            del self._task_events[:5000]

    async def _flush_events(self):
        if not self._task_events or self.head is None:
            return
        batch, self._task_events = self._task_events, []
        try:
            await self.head.call("add_task_events", events=batch)
        # tpulint: allow(broad-except reason=1 Hz flush loop against a possibly-degraded head; logging every miss would spam - events re-flush next tick)
        except Exception:
            pass

    async def flush_observability(self):
        """Eagerly drain buffered task events and push a metrics
        snapshot — the 1 Hz loop's work, on demand. Called at moments
        the process may be about to die (a train attempt ending), so
        the last second of spans/metrics isn't lost with the worker."""
        from ray_tpu_torch.util import metrics as _metrics

        await self._flush_events()
        snap = _metrics.snapshot()
        if snap:
            try:
                await self.head.call(
                    "report_metrics", worker=self.addr, metrics=snap
                )
            # tpulint: allow(broad-except reason=eager pre-death flush; the head may already be unreachable and there is nobody left to tell)
            except Exception:
                pass

    async def _flush_events_loop(self):
        while True:
            await asyncio.sleep(1.0)
            await self.flush_observability()

    async def _drive_normal_task(
        self, spec, oids, resources, retries, placement=None,
        runtime_env=None, scheduling=None,
    ):
        last_err: Exception | None = None
        tid = spec["task_id"]
        state = self._cancel_state.setdefault(
            tid, {"cancelled": False, "lease": None, "oids": oids}
        )
        try:
            for attempt in range(retries + 1):
                lease = None
                try:
                    if state["cancelled"]:
                        raise TaskCancelledError(
                            f"task {tid[:12]}… was cancelled"
                        )
                    if spec.get("streaming"):
                        # Stamp the attempt so late item reports from a
                        # dead earlier attempt can't interleave.
                        spec = {**spec, "attempt": attempt}
                        self._gen_attempt[spec["task_id"]] = attempt
                    # Resolve self-owned deps BEFORE leasing (reference:
                    # LocalDependencyResolver dependency_resolver.h:36 —
                    # no worker is held while upstream tasks run, and
                    # arg locations are known for the locality hint).
                    await self._wait_own_deps(spec)
                    lease = await self._lease(
                        resources, placement, runtime_env, scheduling,
                        locality=self._locality_hint(spec),
                    )
                    if state["cancelled"]:  # cancelled while queued
                        raise TaskCancelledError(
                            f"task {tid[:12]}… was cancelled"
                        )
                    state["lease"] = lease
                    try:
                        conn = await self._connect(lease["addr"])
                    except (rpc.ConnectionLost, OSError) as e:
                        # Dial failure = the leased WORKER is unreachable
                        # (dead). Returning the lease would re-idle the
                        # corpse and hand it to the next caller — drop it
                        # (the node's reap loop reconciles) and retry on
                        # a fresh lease. sent=False here means "safe to
                        # resend", not "the worker is alive".
                        last_err = e
                        lease = None
                        continue
                    reply = await conn.call("push_task", spec=spec)
                    return self._apply_reply(reply, oids, spec["task_id"])
                except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
                    # OSError: connect() translates ConnectionError but a
                    # dead peer can still surface other socket errors —
                    # they mean the same thing here (worker unreachable).
                    last_err = e
                    if state["cancelled"]:
                        # The kill we issued took the worker down
                        # mid-push: this is cancellation, not failure —
                        # never retry.
                        lease = None
                        raise TaskCancelledError(
                            f"task {tid[:12]}… was cancelled while running"
                        ) from e
                    if spec.get("streaming") and self._gen_delivered.get(
                        spec["task_id"], 0
                    ):
                        # Items were already delivered: a retry would
                        # replay them. Fail instead (reference:
                        # generators restart only via lineage
                        # reconstruction, not mid-stream).
                        if getattr(e, "sent", True):
                            lease = None
                        break
                    if not getattr(e, "sent", True):
                        # The request never reached the worker (closed
                        # conn caught locally, chaos drop): the lease is
                        # intact — the finally clause returns it.
                        continue
                    lease = None  # worker may be gone; don't return it
                    continue
                finally:
                    state["lease"] = None
                    if lease is not None:
                        await self._return_lease(lease)
            raise WorkerDiedError(
                f"task failed after {retries + 1} attempts: {last_err}"
            )
        finally:
            self._cancel_state.pop(tid, None)

    async def _drive_actor_task(self, spec, oids, actor):
        # Prefer the freshest known address: the actor may have been
        # restarted on a different worker since this handle was created.
        failure: Exception | None = None
        dialed_dead = False
        addr = actor.addr
        for _ in range(5):
            addr = self._actor_addrs.get(actor.actor_id, actor.addr)
            try:
                conn = await self._connect(addr)
            except (rpc.ConnectionLost, OSError) as e:
                # Endpoint unreachable (worker process gone): the actor
                # is dead — fall through to the head-driven restart.
                # The request provably never hit the wire, so it is
                # safe to RETRY against the restarted address below.
                failure = e
                dialed_dead = True
                break
            try:
                reply = await conn.call(
                    "actor_call", spec=spec, actor_id=actor.actor_id
                )
                return self._apply_reply(reply, oids, spec["task_id"])
            except (rpc.ConnectionLost, rpc.RpcError, OSError) as e:
                failure = e
                if not getattr(e, "sent", True):
                    # Never reached the wire (chaos drop / locally-closed
                    # conn): the actor is fine — resend, don't restart.
                    # Only evict the cached conn if it actually closed (a
                    # chaos drop leaves it healthy; evicting would leak
                    # the socket and its recv task).
                    cached = self._conns.get(addr)
                    if cached is not None and cached._closed:
                        self._conns.pop(addr, None)
                    continue
                break
        else:
            raise ActorDiedError(
                f"actor {actor.actor_id[:12]}…: request could not be sent"
            ) from failure

        # The connection died. Report to the head; it restarts the actor
        # if max_restarts allows. A call that was (possibly) DELIVERED
        # still fails (it may have half-executed — actor methods are not
        # idempotent by default); a call that provably never reached the
        # wire retries once against the restarted address.
        try:
            reply = await self.head.call(
                "restart_actor", actor_id=actor.actor_id, failed_addr=addr
            )
        except rpc.RpcError:
            reply = {"ok": False}
        if reply.get("ok"):
            self._actor_addrs[actor.actor_id] = reply["addr"]
            if dialed_dead and not spec.pop("_restart_retried", False):
                spec["_restart_retried"] = True  # one retry, no loops
                return await self._drive_actor_task(spec, oids, actor)
            raise ActorDiedError(
                f"actor {actor.actor_id[:12]}… died mid-call and was "
                f"restarted; this call was lost: {failure}"
            ) from failure
        raise ActorDiedError(
            f"actor {actor.actor_id[:12]}… died: {failure}"
        ) from failure

    def _apply_reply(
        self, reply: dict, oids: list, task_id: str | None = None
    ) -> bool:
        """Returns True when the reply carries a task error."""
        if reply["status"] == "error":
            if "error" in reply:
                err = deserialize(reply["error"])
            else:
                # A foreign (C++) worker cannot pickle a RayTaskError;
                # it sends the text only.
                err = RayTaskError(
                    reply.get("error_text") or "foreign task failed"
                )
            for oid_hex in oids:
                self._store_result(oid_hex, ("error", err))
            if task_id is not None:
                q = self._generators.get(task_id)
                if q is not None:  # streaming task failed mid-iteration
                    q.put_nowait(("error", err))
            return True
        for oid_hex, kind, *rest in reply["results"]:
            if kind == "inline":
                self._store_result(oid_hex, ("value", rest[0], rest[1]))
            elif kind == "tensor":  # payload stays in the producer
                self._store_result(oid_hex, ("tensor", rest[0]))
            elif kind == "xmp":
                # Cross-language result: msgpack from a foreign worker,
                # re-serialized into the owner's normal value path.
                s = serialize(
                    rpc.unpack_frame(rest[0])
                ).materialize_buffers()
                self._store_result(
                    oid_hex, ("value", s.inband, s.buffers)
                )
            else:  # in a node's shared store (rest = [holder_node_addr])
                self._store_result(
                    oid_hex, ("in_store", rest[0] if rest else None)
                )
        return False

    # ------------------------------------------------------------ leases
    def _sched_key(
        self,
        resources: dict | None,
        runtime_env: dict | None = None,
        scheduling: dict | None = None,
    ) -> tuple:
        from ray_tpu_torch.runtime.node import env_hash

        def freeze(value):
            # Canonical recursive form: logically equal strategies with
            # different dict insertion order share one lease pool.
            if isinstance(value, dict):
                return tuple(
                    sorted((k, freeze(v)) for k, v in value.items())
                )
            if isinstance(value, (list, tuple, set)):
                return tuple(sorted(repr(freeze(v)) for v in value))
            return value

        return (
            tuple(sorted((resources or {"CPU": 1.0}).items())),
            env_hash(runtime_env),
            None if scheduling is None else freeze(scheduling),
        )

    async def _wait_own_deps(self, spec: dict) -> None:
        """Wait until every by-ref arg OWNED BY THIS PROCESS reaches a
        terminal state (value, store location, or error). Refs owned by
        other processes resolve at the executing worker as before."""
        for entry in spec.get("args", ()):
            if entry[1] != "ref" or entry[3] != self.addr:
                continue
            await self._wait_local(entry[2], timeout=None)

    def _locality_hint(self, spec: dict) -> str | None:
        """Node holding most of this task's store-resident args, if it is
        not the local node (reference: the locality-aware LeasePolicy,
        lease_policy.h — prefer the raylet already holding the task's
        dependencies so args need no transfer). Only refs THIS process
        owns carry location info; best-effort by design."""
        counts: dict[str, int] = {}
        for entry in spec.get("args", ()):
            if entry[1] != "ref":
                continue
            loc = self.memory.get(entry[2])
            if loc and loc[0] == "in_store":
                # holder None = the LOCAL node's store; it must vote too,
                # or one remote arg outweighs any number of local ones.
                # (put() records are ("in_store",) with no holder slot.)
                holder = (loc[1] if len(loc) > 1 else None) or self.node_addr
                if holder:
                    counts[holder] = counts.get(holder, 0) + 1
        if not counts:
            return None
        best = max(counts, key=lambda a: counts[a])
        return best if best != self.node_addr else None

    async def _lease(
        self,
        resources: dict | None,
        placement: tuple | None = None,
        runtime_env: dict | None = None,
        scheduling: dict | None = None,
        locality: str | None = None,
    ) -> dict:
        if placement is not None:
            # Bundle-backed lease on the bundle's node; never cached.
            node_addr, pg_id, index = placement
            node_conn = (
                self.node
                if node_addr is None
                else await self._connect(node_addr)
            )
            reply = await node_conn.call(
                "lease_worker",
                resources=dict(resources or {"CPU": 1.0}),
                bundle=(pg_id, index),
                runtime_env=runtime_env,
            )
            if not reply.get("ok"):
                raise rpc.RpcError(reply.get("error", "bundle lease failed"))
            reply["sched_key"] = None
            reply["node_conn"] = node_conn
            return reply
        key = self._sched_key(resources, runtime_env, scheduling)
        pool = self._pool(key)
        while pool["free"]:
            lease, _ = pool["free"].pop()
            conn = self._conns.get(lease["addr"])
            if conn is None or not conn._closed:
                return lease
        fut = asyncio.get_running_loop().create_future()
        pool["waiters"].append(fut)
        self._maybe_request_lease(
            key, dict(resources or {"CPU": 1.0}), runtime_env, scheduling,
            locality=locality,
        )
        return await fut

    def _pool(self, key: tuple) -> dict:
        import collections

        return self._lease_pools.setdefault(
            key, {"free": [], "waiters": collections.deque(), "inflight": 0}
        )

    def _maybe_request_lease(
        self,
        key: tuple,
        resources: dict,
        runtime_env: dict | None = None,
        scheduling: dict | None = None,
        locality: str | None = None,
    ):
        """Pipeline lease requests: keep at most min(#waiters, cap)
        requests in flight per scheduling class."""
        pool = self._pool(key)
        if pool["inflight"] >= min(
            len(pool["waiters"]), self._max_inflight_leases
        ):
            return
        pool["inflight"] += 1

        async def request():
            try:
                reply = None
                if (
                    scheduling is None
                    and locality
                    and self.node is not None
                ):
                    # Locality-first: lease from the node already
                    # holding the args. Best-effort — unreachable or
                    # infeasible holder falls through to the normal
                    # local-then-spill path (reference: LeasePolicy
                    # picks the raylet, spillback corrects it).
                    try:
                        lconn = await self._connect(locality)
                        lreply = await lconn.call(
                            "lease_worker",
                            resources=resources,
                            runtime_env=runtime_env,
                        )
                        if lreply.get("ok"):
                            lreply["node_conn"] = lconn
                            reply = lreply
                    except (rpc.RpcError, OSError):
                        pass
                if reply is not None:
                    pass
                elif scheduling is not None:
                    reply = await self._lease_with_strategy(
                        resources, runtime_env, scheduling
                    )
                elif self.node is None:
                    # Client mode: no local node — every lease goes
                    # through the head's placement.
                    reply = await self._spill_lease(
                        resources, runtime_env=runtime_env
                    )
                else:
                    reply = await self.node.call(
                        "lease_worker",
                        resources=resources,
                        runtime_env=runtime_env,
                    )
                    if not reply.get("ok") and (
                        reply.get("infeasible") or reply.get("retry_spill")
                    ):
                        # Local node can never satisfy this (infeasible)
                        # or kept us queued past its age limit
                        # (retry_spill): spill via the head (reference:
                        # lease spillback, retry_at_raylet_address
                        # node_manager.proto:78). If the whole cluster is
                        # infeasible, poll — the autoscaler may add a
                        # node.
                        reply = await self._spill_lease(
                            resources, runtime_env=runtime_env
                        )
                if not reply.get("ok"):
                    raise rpc.RpcError(reply.get("error", "lease failed"))
                reply["sched_key"] = key
                # Locally-granted leases carry their node conn too, so
                # cancellation can reach the right kill_worker endpoint.
                reply.setdefault("node_conn", self.node)
                pool["inflight"] -= 1
                self._offer_lease(key, reply)
            # tpulint: allow(broad-except reason=not swallowed - the lease failure is set on the waiting future and raises at the submit site)
            except Exception as e:
                pool["inflight"] -= 1
                while pool["waiters"]:
                    fut = pool["waiters"].popleft()
                    if not fut.done():
                        fut.set_exception(e)
                        break
            # Top up if demand still outstrips supply.
            if pool["waiters"]:
                self._maybe_request_lease(
                    key, resources, runtime_env, scheduling,
                    locality=locality,
                )

        asyncio.ensure_future(request())

    async def _lease_with_strategy(
        self,
        resources: dict,
        runtime_env: dict | None,
        scheduling: dict,
        actor: bool = False,
    ) -> dict:
        """Lease honoring a scheduling strategy (reference:
        python/ray/util/scheduling_strategies.py — NodeAffinity :43,
        NodeLabel :164; the raylet-side policies
        scheduling/policy/node_affinity_scheduling_policy and
        node_label_scheduling_policy)."""
        node_id = scheduling.get("node_id")
        if node_id is not None:
            info = await self.head.call("get_node", node_id=node_id)
            if not info.get("ok"):
                if scheduling.get("soft"):
                    return await self._spill_lease(
                        resources, actor=actor, runtime_env=runtime_env
                    )
                return {
                    "ok": False,
                    "error": f"node affinity (hard): {info.get('error')}",
                }
            conn = await self._connect(info["addr"])
            while True:
                granted = await conn.call(
                    "lease_worker",
                    resources=resources,
                    actor=actor,
                    runtime_env=runtime_env,
                )
                if granted.get("ok"):
                    granted["node_conn"] = conn
                    return granted
                if granted.get("retry_spill") and not scheduling.get("soft"):
                    # Hard affinity: the node is just busy — keep
                    # queueing on IT rather than spilling elsewhere.
                    await asyncio.sleep(0.2)
                    continue
                if scheduling.get("soft"):
                    return await self._spill_lease(
                        resources, actor=actor, runtime_env=runtime_env
                    )
                return {
                    "ok": False,
                    "error": granted.get(
                        "error", "node affinity lease failed"
                    ),
                }
        # Label strategy: the head filters by hard labels and prefers
        # soft matches.
        return await self._spill_lease(
            resources,
            actor=actor,
            runtime_env=runtime_env,
            pick_kwargs={
                "labels_hard": scheduling.get("labels_hard") or None,
                "labels_soft": scheduling.get("labels_soft") or None,
            },
        )

    async def _spill_lease(
        self,
        resources: dict,
        actor: bool = False,
        runtime_env: dict | None = None,
        pick_kwargs: dict | None = None,
    ) -> dict:
        """Find a feasible node through the head and lease there.

        The timeout clock only runs while the WHOLE cluster is infeasible
        (waiting for the autoscaler); when a feasible node exists but is
        saturated, we keep cycling through its queue indefinitely — a
        busy cluster must not fail queued tasks.
        """
        import uuid

        from ray_tpu_torch._private import config

        loop = asyncio.get_running_loop()
        timeout_s = config.get("SCHED_TIMEOUT_S")
        deadline = loop.time() + timeout_s
        requester = uuid.uuid4().hex  # dedups this wait's demand at the head
        while True:
            reply = await self.head.call(
                "pick_node",
                resources=resources,
                requester=requester,
                **{k: v for k, v in (pick_kwargs or {}).items() if v},
            )
            if reply.get("ok"):
                deadline = loop.time() + timeout_s  # feasible: clock resets
                if reply["addr"] == self.node_addr:
                    conn = self.node
                else:
                    conn = await self._connect(reply["addr"])
                granted = await conn.call(
                    "lease_worker",
                    resources=resources,
                    actor=actor,
                    runtime_env=runtime_env,
                )
                if granted.get("ok"):
                    granted["node_conn"] = conn
                    return granted
                # Chosen node raced away, filled up, or bounced us after
                # its queue-age limit; re-pick.
            if loop.time() >= deadline:
                return {
                    "ok": False,
                    "error": (
                        f"no node can satisfy {resources} (waited "
                        f"{timeout_s}s for scale-up; set "
                        "RAY_TPU_SCHED_TIMEOUT_S to wait longer)"
                    ),
                }
            await asyncio.sleep(0.5)

    def _offer_lease(self, key: tuple, lease: dict):
        import time

        pool = self._pool(key)
        while pool["waiters"]:
            fut = pool["waiters"].popleft()
            if not fut.done():
                fut.set_result(lease)
                return
        if len(pool["free"]) < self._lease_cap:
            pool["free"].append((lease, time.monotonic()))
        else:
            asyncio.ensure_future(self._give_back(lease))

    async def _return_lease(self, lease: dict):
        if lease.get("sched_key") is None:  # bundle lease: return directly
            try:
                await lease["node_conn"].call(
                    "return_lease", lease_id=lease["lease_id"]
                )
            except rpc.RpcError:
                pass
            return
        self._offer_lease(lease["sched_key"], lease)

    async def _give_back(self, lease: dict):
        # Spilled leases carry the conn of the (remote) node that granted
        # them; returning to the local node would leak the remote lease.
        conn = lease.get("node_conn") or self.node
        try:
            await conn.call("return_lease", lease_id=lease["lease_id"])
        except rpc.RpcError:
            pass

    async def _lease_reap_loop(self):
        import time

        while True:
            await asyncio.sleep(self._lease_idle_s / 2)
            now = time.monotonic()
            for pool in self._lease_pools.values():
                keep = []
                for lease, since in pool["free"]:
                    if now - since > self._lease_idle_s:
                        asyncio.ensure_future(self._give_back(lease))
                    else:
                        keep.append((lease, since))
                pool["free"][:] = keep

    # ----------------------------------------------------------- actors
    async def create_actor(
        self,
        cls: type,
        args: Sequence,
        kwargs: dict,
        name: str | None = None,
        resources: dict | None = None,
        detached: bool = False,
        placement: tuple | None = None,  # (node_addr, pg_id, bundle_index)
        max_concurrency: int | None = None,
        max_restarts: int = 0,
        runtime_env: dict | None = None,
        scheduling: dict | None = None,
    ):
        actor_id = ActorID.random().hex()
        if placement is None and scheduling is not None:
            reply = await self._lease_with_strategy(
                dict(resources or {"CPU": 1.0}),
                runtime_env,
                scheduling,
                actor=True,
            )
            if not reply.get("ok"):
                raise rpc.RpcError(
                    reply.get("error", "strategy actor lease failed")
                )
            node_conn = reply.get("node_conn") or self.node
        elif placement is not None:
            node_addr, pg_id, index = placement
            node_conn = (
                self.node
                if node_addr is None
                else await self._connect(node_addr)
            )
            reply = await node_conn.call(
                "lease_worker",
                resources=dict(resources or {"CPU": 1.0}),
                actor=True,
                bundle=(pg_id, index),
                runtime_env=runtime_env,
            )
        elif self.node is None:  # client mode: lease via the head
            req = dict(resources or {"CPU": 1.0})
            reply = await self._spill_lease(
                req, actor=True, runtime_env=runtime_env
            )
            node_conn = reply.get("node_conn") if reply.get("ok") else None
        else:
            node_conn = self.node
            req = dict(resources or {"CPU": 1.0})
            reply = await node_conn.call(
                "lease_worker", resources=req, actor=True,
                runtime_env=runtime_env,
            )
            if not reply.get("ok") and (
                reply.get("infeasible") or reply.get("retry_spill")
            ):
                # Same spillback as normal tasks: find a feasible node
                # via the head (and wait out autoscaler scale-up).
                reply = await self._spill_lease(
                    req, actor=True, runtime_env=runtime_env
                )
                if reply.get("ok"):
                    node_conn = reply["node_conn"]
        if not reply.get("ok"):
            raise rpc.RpcError(reply.get("error", "actor lease failed"))
        fn_id = await self.export_function(cls)
        encoded_args = self._encode_args(args, kwargs)
        conn = await self._connect(reply["addr"])
        create = await conn.call(
            "create_actor",
            actor_id=actor_id,
            fn_id=fn_id,
            args=encoded_args,
            max_concurrency=max_concurrency,
        )
        if create["status"] == "error":
            raise deserialize(create["error"])
        info = await node_conn.call("node_info")
        await self.head.call(
            "register_actor",
            actor_id=actor_id,
            name=name,
            class_name=cls.__name__,
            addr=reply["addr"],
            node_id=info["node_id"],
            detached=detached,
            # Restart spec: everything the head needs to re-create this
            # actor on a fresh worker (reference: GcsActorManager keeps
            # the creation TaskSpec for restarts, gcs_actor_manager.h:93).
            restart_spec={
                "fn_id": fn_id,
                "args": encoded_args,
                "resources": dict(resources or {"CPU": 1.0}),
                "max_concurrency": max_concurrency,
                "max_restarts": max_restarts,
                # PG-placed actors must restart on their reserved bundle.
                "placement": placement,
                "runtime_env": runtime_env,
                "scheduling": scheduling,
            },
        )
        return actor_id, reply["addr"]

    async def kill_actor(self, actor_id: str, addr: str):
        # The handle carries the birth address; a head-driven restart may
        # have moved the actor without THIS client ever seeing a failure
        # — ask the head for the authoritative address, then mark the
        # death intentional (no restart, name freed) before killing.
        addr = self._actor_addrs.get(actor_id, addr)
        try:
            info = await self.head.call("get_actor", actor_id=actor_id)
            if info.get("ok") and info.get("addr"):
                addr = info["addr"]  # head is authoritative
        except rpc.RpcError:
            pass
        try:
            await self.head.call(
                "update_actor", actor_id=actor_id, state="DEAD"
            )
        except rpc.RpcError:
            pass
        try:
            conn = await self._connect(addr)
            await conn.call("exit_worker")
        except (rpc.ConnectionLost, rpc.RpcError):
            pass

    # ------------------------------------------------- worker-side serve
    async def _handle(self, method: str, kw: dict, conn: rpc.Connection):
        ext = self.ext_handlers.get(method)
        if ext is not None:
            return await ext(conn=conn, **kw)
        fn = getattr(self, f"_on_{method}", None)
        if fn is None:
            raise rpc.RpcError(f"core_worker: unknown method {method!r}")
        return await fn(conn=conn, **rpc.tolerant_kwargs(fn, kw))

    async def _on_ping(self, conn):
        return {"ok": True}

    async def _on_get_object(self, conn, oid_hex: str):
        """Serve an object I own (reference: PushTaskReply + owner memory
        store; pull protocol object_manager.proto:60)."""
        if oid_hex not in self.memory:
            oid = ObjectID.from_hex(oid_hex)
            if self.store.contains(oid):
                return {"kind": "in_store"}
            await self._wait_local(oid_hex, timeout=None)
        kind, *rest = self.memory[oid_hex]
        if kind == "error":
            return {"kind": "error", "inband": _dumps_small(rest[0])}
        if kind == "value":
            return {"kind": "value", "inband": rest[0], "buffers": rest[1]}
        if kind == "tensor":
            return {"kind": "tensor", "meta": rest[0]}
        primary = rest[0] if rest else None
        holders = [a for a in self._locations.get(oid_hex, ()) if a != primary]
        return {"kind": "in_store", "holder": primary, "holders": holders}

    async def _on_object_location_add(self, conn, oid_hex: str, addr: str):
        """A puller cached a copy of an object we own in its node store;
        record the location so later pulls can fan in from it."""
        self._locations.setdefault(oid_hex, set()).add(addr)
        return {"ok": True}

    async def _on_object_location_remove(
        self, conn, oid_hex: str, addrs: list
    ):
        """A puller found these holders dead/evicted: prune them so the
        next resolve doesn't hand out stale sources."""
        locs = self._locations.get(oid_hex)
        if locs:
            locs.difference_update(addrs)
        return {"ok": True}

    async def _prune_locations(
        self, oid_hex: str, addrs: list, owner_conn
    ) -> None:
        if owner_conn is None:
            locs = self._locations.get(oid_hex)
            if locs:
                locs.difference_update(addrs)
            return
        try:
            await owner_conn.call(
                "object_location_remove", oid_hex=oid_hex, addrs=addrs
            )
        except (rpc.ConnectionLost, rpc.RpcError):
            pass

    async def _on_get_object_meta(self, conn, oid_hex: str):
        """Segment layout of a store-resident object (chunked pull)."""
        from ray_tpu_torch.runtime.object_store import segment_meta

        view = self.store.get(ObjectID.from_hex(oid_hex))
        if view is None:
            return {"ok": False}
        return segment_meta(view)

    async def _on_get_object_chunk(
        self, conn, oid_hex: str, offset: int, size: int
    ):
        from ray_tpu_torch.runtime.object_store import segment_window

        view = self.store.get(ObjectID.from_hex(oid_hex))
        if view is None:
            return {"ok": False}
        return {"ok": True, "data": segment_window(view, offset, size)}

    async def _on_generator_item(
        self, conn, task_id: str, index: int, inband, buffers, done: bool,
        attempt: int = 0,
    ):
        """Owner side of a streaming generator (reference: the owner's
        handling of ReportGeneratorItemReturns)."""
        q = self._generators.get(task_id)
        if q is None:
            return {"ok": False}  # consumer gone; producer may stop
        if attempt != self._gen_attempt.get(task_id, 0):
            return {"ok": False}  # stale report from a superseded attempt
        if done:
            q.put_nowait(("done",))
            return {"ok": True}
        oid_hex = ObjectID.for_return(TaskID.from_hex(task_id), index).hex()
        self._store_result(oid_hex, ("value", inband, buffers))
        q.put_nowait(("item", oid_hex))
        self._gen_delivered[task_id] = self._gen_delivered.get(task_id, 0) + 1
        return {"ok": True, "depth": q.qsize()}

    async def _on_generator_depth(self, conn, task_id: str):
        q = self._generators.get(task_id)
        if q is None:
            return {"ok": False}
        return {"ok": True, "depth": q.qsize()}

    async def next_generator_item(self, task_id: str):
        """("item", oid_hex) | ("done",) | ("error", exc); cleans up on
        terminal entries."""
        q = self._generators.get(task_id)
        if q is None:
            return ("done",)
        entry = await q.get()
        if entry[0] in ("done", "error"):
            del self._generators[task_id]
            self._gen_delivered.pop(task_id, None)
            self._gen_attempt.pop(task_id, None)
        return entry

    async def close_generator(self, task_id: str):
        """Abandon a streaming generator: drop undelivered items from the
        memory store and deregister, so the producer's next report gets
        ok=False and stops."""
        q = self._generators.pop(task_id, None)
        self._gen_delivered.pop(task_id, None)
        self._gen_attempt.pop(task_id, None)
        if q is None:
            return
        while not q.empty():
            entry = q.get_nowait()
            if entry[0] == "item":
                self.memory.pop(entry[1], None)

    async def _on_push_task(self, conn, spec: dict):
        fut = asyncio.get_running_loop().create_future()
        await self._exec_queue.put(("task", spec, None, fut))
        return await fut

    async def _on_actor_call(self, conn, spec: dict, actor_id: str):
        fut = asyncio.get_running_loop().create_future()
        await self._exec_queue.put(("task", spec, actor_id, fut))
        return await fut

    async def _on_create_actor(
        self, conn, actor_id: str, fn_id: str, args, max_concurrency=None
    ):
        try:
            if max_concurrency:
                self._async_sema = asyncio.Semaphore(int(max_concurrency))
            cls = await self._fetch_function(fn_id)
            a, kw = await self._decode_args(args)
            loop = asyncio.get_running_loop()
            self._actor_instance = await loop.run_in_executor(
                self._exec_pool, lambda: cls(*a, **kw)
            )
            self._actor_id = actor_id
            return {"status": "ok"}
        # tpulint: allow(broad-except reason=not swallowed - the construction error is serialized into the reply and raises at the actor handle)
        except Exception as e:
            return {"status": "error", "error": _dumps_small(_as_task_error(e))}

    async def _on_bind_cards(self, conn, cards: str):
        """Take a GPU lease's cards (runtime/node.py) into this process's
        environment, where no CUDA driver was loaded in it yet: CUDA reads
        ``CUDA_VISIBLE_DEVICES`` when it initializes, so a process that
        loaded the driver keeps the cards it saw then, and refuses."""
        import os

        if _cuda_driver_loaded():
            return {"ok": False}
        os.environ["CUDA_VISIBLE_DEVICES"] = cards
        os.environ["CUDA_DEVICE_ORDER"] = "PCI_BUS_ID"
        return {"ok": True}

    async def _on_exit_worker(self, conn):
        # Process workers die hard; inproc workers (WORKER_MODE=inproc,
        # node.py _spawn_worker_inproc) install a soft stop — one
        # simulated worker must not take the host process with it.
        cb = getattr(self, "_exit_cb", None) or _hard_exit
        asyncio.get_running_loop().call_later(0.05, cb)
        return {"ok": True}

    # -------------------------------------------------- execution loop
    async def _exec_loop(self):
        """Strictly ordered execution (reference: ActorSchedulingQueue /
        NormalSchedulingQueue, task_receiver.h:43): tasks run one at a
        time, in arrival order, on the executor thread."""
        while True:
            kind, spec, actor_id, fut = await self._exec_queue.get()
            if actor_id is not None and self._is_async_method(spec):
                asyncio.ensure_future(self._run_async(spec, actor_id, fut))
                continue
            reply = await self._execute(spec, actor_id)
            if not fut.done():
                fut.set_result(reply)

    def _is_async_method(self, spec: dict) -> bool:
        name = spec["fn_id"]
        if name.startswith("@sys:") or self._actor_instance is None:
            return False
        fn = getattr(self._actor_instance, name, None)
        # Async generator methods (streaming actor calls) run concurrently
        # like coroutine methods: a long-lived token stream must not block
        # the ordered exec queue for every other caller.
        return asyncio.iscoroutinefunction(fn) or inspect.isasyncgenfunction(
            fn
        )

    async def _run_async(self, spec: dict, actor_id: str, fut):
        async with self._async_sema:
            reply = await self._execute(spec, actor_id)
        if not fut.done():
            fut.set_result(reply)

    async def _stream_generator(self, spec: dict, gen) -> dict:
        """Report a generator task's yields to the owner incrementally
        (reference: streaming generators, ReportGeneratorItemReturns in
        core_worker.proto + ObjectRefGenerator object_ref_generator.py:32).
        Awaiting each report's ack gives one-item backpressure."""
        loop = asyncio.get_running_loop()
        owner = await self._connect(spec["owner_addr"])
        task_id = spec["task_id"]
        attempt = spec.get("attempt", 0)
        index = 0
        _SENTINEL = object()
        is_async = inspect.isasyncgen(gen)

        async def _next_item():
            if is_async:
                try:
                    return await gen.__anext__()
                except StopAsyncIteration:
                    return _SENTINEL
            return await loop.run_in_executor(
                self._exec_pool, lambda: next(gen, _SENTINEL)
            )

        async def _close_gen():
            try:
                if is_async:
                    await gen.aclose()
                else:
                    getattr(gen, "close", lambda: None)()
            # tpulint: allow(broad-except reason=generator close on a consumer that already went away; there is no caller to surface it to)
            except Exception:
                pass

        while True:
            item = await _next_item()
            if item is _SENTINEL:
                break
            data = serialize(item).materialize_buffers()
            ack = await owner.call(
                "generator_item",
                task_id=task_id,
                index=index,
                inband=data.inband,
                buffers=data.buffers,
                done=False,
                attempt=attempt,
            )
            if not ack.get("ok"):
                # Consumer closed/abandoned the generator: stop producing.
                await _close_gen()
                return {"status": "ok", "results": []}
            index += 1
            # Backpressure: pause while the consumer is far behind
            # (reference: generator_backpressure_num_objects).
            while ack.get("depth", 0) >= GENERATOR_BACKPRESSURE_ITEMS:
                await asyncio.sleep(0.02)
                ack = await owner.call("generator_depth", task_id=task_id)
                if not ack.get("ok"):
                    await _close_gen()
                    return {"status": "ok", "results": []}
        await owner.call(
            "generator_item",
            task_id=task_id,
            index=index,
            inband=None,
            buffers=None,
            done=True,
            attempt=attempt,
        )
        return {"status": "ok", "results": []}

    async def _execute(self, spec: dict, actor_id: str | None) -> dict:
        from ray_tpu_torch.util import tracing

        trace_ctx = spec.get("trace")
        with tracing.activate(trace_ctx):
            # Nested .remote() calls from the executor thread see the
            # span through a per-thread install (run_in_executor wrapper
            # in _execute_inner) — per task, so concurrent traced actor
            # tasks can't be parented to each other's spans.
            return await self._execute_inner(spec, actor_id)

    async def _execute_inner(self, spec: dict, actor_id: str | None) -> dict:
        loop = asyncio.get_running_loop()
        exec_start = time.time()
        try:
            args, kwargs = await self._decode_args(spec["args"])
            if actor_id is not None:
                method_name = spec["fn_id"]  # actor calls carry the name
                instance = self._actor_instance
                if instance is None or actor_id != self._actor_id:
                    raise ActorDiedError("no such actor in this worker")
                if method_name.startswith("@sys:"):
                    # System task: an exported function applied to the
                    # actor instance (used by compiled graphs to inject
                    # the exec loop without touching user classes).
                    sys_fn = await self._fetch_function(method_name[5:])
                    fn = functools.partial(sys_fn, instance)
                else:
                    fn = getattr(instance, method_name)
            else:
                fn = await self._fetch_function(spec["fn_id"])
            if inspect.isasyncgenfunction(fn):
                # Async generator: the object itself is the stream; it is
                # driven on the loop by _stream_generator below.
                result = fn(*args, **kwargs)
            elif asyncio.iscoroutinefunction(fn):
                result = await fn(*args, **kwargs)
            else:
                from ray_tpu_torch.util import tracing

                trace_cur = tracing.current_context()

                def _run_sync(fn=fn, args=args, kwargs=kwargs):
                    with tracing.thread_trace(trace_cur):
                        return fn(*args, **kwargs)

                result = await loop.run_in_executor(
                    self._exec_pool, _run_sync
                )
            if spec.get("streaming"):
                if not inspect.isgenerator(result) and not inspect.isasyncgen(
                    result
                ):
                    # A coroutine method may hand back an async generator
                    # (e.g. `return self.stream(...)`) — stream it too.
                    result = iter(result)  # any other iterable streams
                reply = await self._stream_generator(spec, result)
                self.record_task_event(
                    spec, "RUNNING", ts=exec_start,
                    dur=time.time() - exec_start,
                )
                return reply
            n = spec["num_returns"]
            values = (
                [result]
                if n == 1
                else list(result)
                if n > 1
                else []
            )
            if n > 1 and len(values) != n:
                raise RayTaskError(
                    f"task declared num_returns={n} but returned "
                    f"{len(values)} values"
                )
            results = []
            task_id = TaskID.from_hex(spec["task_id"])
            if spec.get("xlang"):
                # Cross-language caller (cpp/ client): results go back
                # as plain msgpack inline — the foreign driver is the
                # owner and decodes natively; pickle never crosses the
                # language boundary (reference: cross-language
                # serialization is msgpack both ways).
                for i, value in enumerate(values):
                    oid_hex = ObjectID.for_return(task_id, i).hex()
                    try:
                        results.append(
                            (oid_hex, "xmp", rpc.pack_frame(value))
                        )
                    except (TypeError, ValueError) as e:
                        raise RayTaskError(
                            "cross-language task returned a value that "
                            f"is not msgpack-encodable: {e}"
                        ) from None
                self.record_task_event(
                    spec, "RUNNING", ts=exec_start,
                    dur=time.time() - exec_start,
                )
                return {"status": "ok", "results": results}
            transport = spec.get("tensor_transport")
            if transport and actor_id is not None:
                # Tensor transport: values stay in THIS actor's device
                # store; only location metadata enters the result path
                # (reference: gpu_object_manager — tensor_transport
                # threaded through submission, TensorTransportGetter
                # normal_task_submitter.h:101).
                for i, value in enumerate(values):
                    oid_hex = ObjectID.for_return(task_id, i).hex()
                    self.tensor_store[oid_hex] = value
                    meta = {"src_addr": self.addr, "transport": transport}
                    if isinstance(transport, str):
                        from ray_tpu_torch import collective as col

                        if col.is_group_initialized(transport):
                            # Single-controller backends (xla_mesh) have
                            # no per-process rank: consumers then use
                            # the rpc fetch path.
                            rank = getattr(
                                col.get_group(transport), "rank", None
                            )
                            if rank is not None:
                                meta["group"] = transport
                                meta["src_rank"] = rank
                    results.append((oid_hex, "tensor", meta))
                self.record_task_event(
                    spec, "RUNNING", ts=exec_start,
                    dur=time.time() - exec_start,
                )
                return {"status": "ok", "results": results}
            for i, value in enumerate(values):
                oid = ObjectID.for_return(task_id, i)
                data = serialize(value)
                if data.total_bytes() <= INLINE_MAX_BYTES:
                    m = data.materialize_buffers()
                    results.append((oid.hex(), "inline", m.inband, m.buffers))
                else:
                    self.store.put(oid, data)
                    # Carry the holding node's address: the owner may sit
                    # on another node with a different store.
                    results.append((oid.hex(), "in_store", self.node_addr))
            self.record_task_event(
                spec, "RUNNING", ts=exec_start, dur=time.time() - exec_start
            )
            return {"status": "ok", "results": results}
        # tpulint: allow(broad-except reason=not swallowed - the error is wrapped as RayTaskError and travels to the owner in the reply)
        except Exception as e:
            # Post-mortem attach point (reference: RAY_DEBUG_POST_MORTEM,
            # util/rpdb.py): with RAY_TPU_POST_MORTEM set, the worker
            # parks at the failure frame until a debugger attaches and
            # continues; the error then travels to the owner as usual.
            # Runs on an executor thread — the accept() must not block
            # this event loop, which also answers node health RPCs.
            from ray_tpu_torch.util.rpdb import _maybe_post_mortem

            await asyncio.get_running_loop().run_in_executor(
                None, functools.partial(_maybe_post_mortem, e.__traceback__)
            )
            self.record_task_event(
                spec, "RUNNING", ts=exec_start,
                dur=time.time() - exec_start, failed=True,
            )
            reply = {
                "status": "error",
                "error": _dumps_small(_as_task_error(e)),
            }
            if spec.get("xlang"):
                # Foreign drivers cannot unpickle: give them text too.
                reply["error_text"] = f"{type(e).__name__}: {e}"
            return reply


class ActorSubmitTarget:
    __slots__ = ("actor_id", "addr")

    def __init__(self, actor_id: str, addr: str):
        self.actor_id = actor_id
        self.addr = addr


def _dumps_small(value: Any) -> bytes:
    """Serialize fully in-band (no out-of-band buffers) — for errors and
    other payloads that must survive as a single bytes blob."""
    import cloudpickle

    try:
        return cloudpickle.dumps(value)
    # tpulint: allow(broad-except reason=unpicklable error values degrade to their repr so the reply still carries the failure)
    except Exception:
        return cloudpickle.dumps(RayTaskError(repr(value)))


def _as_task_error(e: Exception) -> Exception:
    if isinstance(e, RayTaskError):
        return e
    tb = traceback.format_exc()
    try:
        wrapped = RayTaskError(f"{type(e).__name__}: {e}\n{tb}")
        wrapped.cause = e
        return wrapped
    # tpulint: allow(broad-except reason=error wrapping must never raise; the traceback string alone still reaches the owner)
    except Exception:
        return RayTaskError(tb)


def _hard_exit():
    import os

    os._exit(0)
