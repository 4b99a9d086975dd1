"""CPU collective backend: host tensors over the runtime RPC.

Fills the role of the reference's gloo backend (reference:
python/ray/util/collective/collective_group/torch_gloo_collective_group.py)
as the CPU baseline and test stand-in. Topology is hub-reduce: rank 0
collects contributions, reduces with numpy, and answers every member's
in-flight RPC with the result — one round trip per op, fine for control-
plane-sized tensors (accelerator tensors take the XLA backends).

Payloads are numpy arrays or torch tensors: a tensor crosses the RPC as
the port's serializer carries it (out of band, rebuilt on its device: a
CUDA tensor is rebuilt on the card, or the receiver raises), the hub
reduces tensors with torch on the device they arrive on, and a verb's
result comes back on the device of the tensor it was given. A tensor is
never moved to host memory behind the caller's back.

Rendezvous replaces the reference's NCCLUniqueID named-actor store
(nccl_collective_group.py:29): members publish rank→addr in the head KV
and poll until the group is complete.

Fault tolerance (reference: NCCL abort + destroy_collective_group
semantics; "Efficient AllReduce with Stragglers" motivates the
telemetry):

- Every op and the rendezvous itself run under a deadline. The hub arms
  a timer when an op's first contribution arrives; expiry answers every
  waiting member with a structured timeout naming the missing ranks
  (raised member-side as CollectiveTimeoutError) and fire-and-forgets a
  head probe so a genuinely dead member is *confirmed* dead instead of
  timing out again next op.
- Members register with the head (addr + node addr + worker id). When
  the head declares a member dead — node heartbeat loss, worker reap,
  or a probe — it publishes on the "collective" channel; survivors
  poison the group and fail in-flight and future ops with
  CollectiveMemberDiedError immediately instead of burning the full
  timeout. The hub additionally watches member connections: a dropped
  conn aborts pending ops at once.
- A poisoned (or op-desynced) group is repaired by reform(): survivors
  re-rendezvous under a bumped epoch (fresh KV keys, fresh op
  sequence), re-ranked densely, with the lowest surviving rank as the
  new hub.
- Straggler telemetry: the hub records per-op first→last contribution
  lag and the slowest rank (util/metrics.py histogram + counter), so a
  chronically slow member is visible before it becomes a timeout.
- Partial K-of-N mode ("Efficient AllReduce with Stragglers",
  arXiv:2505.23523): ``allreduce/reducescatter/allgather(...,
  min_ranks=K, grace_s=...)`` arms a SECOND, earlier timer when the
  first contribution arrives. If the grace sub-deadline passes with ≥K
  contributions in hand (or the K-th lands after it), the hub completes
  the op over the contributors — SUM rescaled by world/K so downstream
  mean math stays correct; an allgather fills skipped slots with zeros —
  and answers everyone with typed PartialResult metadata naming the
  skipped ranks. A "partial" tombstone keeps the op's reply around so a
  straggler's late contribution is acked-and-discarded with the same
  result (it rejoins op-sequence-synchronized instead of hanging or
  desyncing). The hard deadline still raises CollectiveTimeoutError
  when even K never arrive. Skips feed the straggler stats, the
  ray_tpu_collective_partial_* metrics, and — past a sliding-window
  threshold — an escalation report to the head that triggers the
  chronic-straggler drain-and-replace path. The grace window itself is
  adaptive by default: once the hub has enough full-op lag samples, it
  derives grace from the straggler-lag histogram (p99 × 1.5, clamped)
  instead of the static config default.
- Compression (`EQuARX <https://arxiv.org/abs/2506.17615>`_):
  ``compression="int8"`` on allreduce/reducescatter/allgather ships
  block-scaled int8 + per-block fp32 absmax scales on the wire (~3.9×
  fewer bytes at block=256) while the hub dequantizes and ACCUMULATES
  IN FP32, requantizing only the reply — the codec is a wire format,
  never an accumulator. Measured wire bytes (the actual packed RPC
  payloads, both directions) feed the flight recorder's
  ray_tpu_collective_wire_bytes_total counter and compression-ratio
  gauge.
- Topology-aware algorithms ("The Big Send-off", arXiv:2504.18658):
  ``allreduce(..., algo=)`` can bypass the hub for a flat ring
  (bandwidth-optimal reduce-scatter + all-gather over the p2p mailbox)
  or a binomial tree (log2(n) latency terms — wins for small
  messages); ``algo="auto"`` picks by message size via the
  collective.algo crossover table. The default (None) keeps the hub
  path, byte-identical to before.
"""

from __future__ import annotations

import asyncio
import sys
import time
from typing import Any

import numpy as np

from ray_tpu_torch._private import rpc
from ray_tpu_torch._private.serialization import deserialize, serialize
from ray_tpu_torch.collective import algo as colalgo
from ray_tpu_torch.collective import codec
from ray_tpu_torch.collective.flight_recorder import record_op, record_partial
from ray_tpu_torch.collective.types import (
    CollectiveGroupDestroyedError,
    CollectiveMemberDiedError,
    CollectiveTimeoutError,
    PartialResult,
    ReduceOp,
)
from ray_tpu_torch.util.metrics import Counter, Histogram


def _as_payload(tensor):
    """A verb's payload: a torch tensor as it is, anything else as a
    numpy array."""
    return tensor if codec.is_tensor(tensor) else np.asarray(tensor)


def _reducer(np_fn, torch_name: str):
    """Stack-and-reduce over axis 0 of a list of contributions: numpy for
    arrays, torch (on the first contribution's device) for tensors."""
    def run(xs):
        if codec.is_tensor(xs[0]):
            import torch

            st = torch.stack([torch.as_tensor(x).to(xs[0].device)
                              for x in xs])
            return getattr(st, torch_name)(0)
        return np_fn(np.stack(xs), axis=0)

    return run


_REDUCERS = {
    ReduceOp.SUM: _reducer(np.sum, "sum"),
    ReduceOp.PRODUCT: _reducer(np.prod, "prod"),
    ReduceOp.MIN: _reducer(np.min, "amin"),
    ReduceOp.MAX: _reducer(np.max, "amax"),
}


def _combiner(np_fn, torch_name: str):
    def run(a, b):
        if codec.is_tensor(a):
            import torch

            return getattr(torch, torch_name)(a, b.to(a.device))
        return np_fn(a, b)

    return run


# Pairwise combiners for the ring/tree p2p algorithms (streaming
# accumulation instead of the hub's stack-and-reduce).
_COMBINERS = {
    ReduceOp.SUM: _combiner(np.add, "add"),
    ReduceOp.PRODUCT: _combiner(np.multiply, "mul"),
    ReduceOp.MIN: _combiner(np.minimum, "minimum"),
    ReduceOp.MAX: _combiner(np.maximum, "maximum"),
}


def _acc_dtype(arr, compression):
    """The ring/tree accumulation dtype: fp32 under the codec, else the
    payload's own."""
    if compression is None:
        return arr.dtype
    if codec.is_tensor(arr):
        import torch

        return torch.float32
    return np.float32


def _as(x, dtype, like):
    """``x`` as an array of ``dtype`` of ``like``'s kind (a tensor on
    ``like``'s device, or a numpy array)."""
    if codec.is_tensor(like):
        import torch

        return torch.as_tensor(x).to(device=like.device, dtype=dtype)
    return np.asarray(x, dtype)


def _array_split(arr, n: int) -> list:
    """np.array_split along axis 0 (torch.tensor_split for tensors: the
    same cut, the first ``len % n`` pieces one longer)."""
    if codec.is_tensor(arr):
        return list(arr.tensor_split(n, dim=0))
    return np.array_split(np.asarray(arr), n, axis=0)


def _zeros(n: int, dtype, like):
    if codec.is_tensor(like):
        import torch

        return torch.zeros(n, dtype=dtype, device=like.device)
    return np.zeros(n, dtype)


def _concat(xs):
    if codec.is_tensor(xs[0]):
        import torch

        return torch.cat(xs)
    return np.concatenate(xs)


def _numel(x) -> int:
    return x.numel() if codec.is_tensor(x) else x.size


def _on_device(value, device):
    """A verb's result back on the caller's device (tensors inside a list
    or a PartialResult too)."""
    if codec.is_tensor(value):
        return value.to(device)
    if isinstance(value, list):
        return [_on_device(v, device) for v in value]
    if isinstance(value, PartialResult):
        value.value = _on_device(value.value, device)
    return value

# Ops that support partial K-of-N completion on the hub.
_PARTIAL_KINDS = frozenset({"allreduce", "reducescatter", "allgather"})

# Full-op lag samples needed before the adaptive grace window replaces
# the static default.
_ADAPTIVE_MIN_SAMPLES = 16

# Extra member-side wait beyond the hub's deadline: the hub answers
# expiry itself, so a member only hits its own backstop when the hub
# process is gone or wedged.
_HUB_GRACE_S = 5.0

_LAG_HIST = Histogram(
    "collective_straggler_lag_s",
    "first→last contribution spread per collective op (hub-measured)",
    boundaries=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1.0, 5.0, 30.0),
    tag_keys=("group", "op"),
)
_STRAGGLER_TOTAL = Counter(
    "collective_straggler_total",
    "ops in which this rank was the slowest (or missing) contributor",
    tag_keys=("group", "rank"),
)
_ABORT_TOTAL = Counter(
    "collective_abort_total",
    "collective ops aborted by timeout or member death",
    tag_keys=("group", "reason"),
)


class _Pending:
    __slots__ = ("contrib", "futures", "arrived", "started", "arrive_ts",
                 "timer", "grace_timer", "grace_passed", "min_ranks",
                 "grace_s", "meta")

    def __init__(self, world: int):
        self.contrib: list = [None] * world
        self.futures: list = []
        self.arrived = 0
        self.started = time.monotonic()
        self.arrive_ts: dict[int, float] = {}
        self.timer: asyncio.TimerHandle | None = None
        # Partial K-of-N state (None min_ranks = classic all-N op; the
        # partial path is never entered, byte-identical behavior).
        self.grace_timer: asyncio.TimerHandle | None = None
        self.grace_passed = False
        self.min_ranks: int | None = None
        self.grace_s: float = 0.0
        self.meta: dict = {}

    def cancel_timers(self):
        if self.timer is not None:
            self.timer.cancel()
        if self.grace_timer is not None:
            self.grace_timer.cancel()


def _pack(value) -> tuple[bytes, list[bytes]]:
    s = serialize(value).materialize_buffers()
    return s.inband, s.buffers


def _unpack(packed: tuple) -> Any:
    return deserialize(packed[0], packed[1])


def _packed_nbytes(packed: tuple) -> int:
    """Measured wire size of one packed payload (inband + oob buffers)."""
    inband, buffers = packed
    return len(inband) + sum(
        int(getattr(b, "nbytes", 0)) or len(b) for b in buffers
    )


def _compress(arr: np.ndarray, compression: str | None):
    """Payload → what goes on the wire (a codec dict when compressing; a
    tensor's int8 data and scales stay tensors on its device)."""
    if compression is None:
        return arr
    from ray_tpu_torch._private import config

    block = config.get("COLLECTIVE_COMPRESSION_BLOCK")
    if codec.is_tensor(arr):
        q, scales = codec.quantize_torch(arr, block)
        return {
            "__q8__": 1,
            "q": q.reshape(-1),
            "scales": scales,
            "shape": list(arr.shape),
            "dtype": str(arr.dtype),
            "block": block,
        }
    return codec.to_wire(codec.quantize(arr, block=block))


def _dequantize_wire(value, cast: bool):
    """A codec payload back as fp32 (``cast``: in its original dtype)."""
    if codec.is_tensor(value["q"]):
        import torch

        block = int(value["block"])
        flat = codec.dequantize_torch(value["q"].reshape(-1, block),
                                      value["scales"])
        shape = tuple(value["shape"])
        out = flat[: int(np.prod(shape)) if shape else 1].reshape(shape)
        dtype = getattr(torch, value["dtype"].split(".")[-1])
        return out.to(dtype) if cast else out
    qt = codec.from_wire(value)
    return codec.dequantize(qt, dtype=qt.dtype if cast else None)


def _decompress(value):
    """Inverse of :func:`_compress`, recursing into allgather lists."""
    if codec.is_wire(value):
        return _dequantize_wire(value, cast=True)
    if isinstance(value, list):
        return [_decompress(v) for v in value]
    return value


def _contrib_array(value) -> np.ndarray:
    """A hub-side contribution as an fp32-accumulation-grade array
    (dequantizing codec payloads; raw arrays and tensors pass
    through)."""
    if codec.is_wire(value):
        return _dequantize_wire(value, cast=False)
    return _as_payload(value)


def _default_timeout() -> float:
    from ray_tpu_torch._private import config

    return config.get("COLLECTIVE_TIMEOUT_S")


def _default_partial_grace() -> float:
    from ray_tpu_torch._private import config

    return config.get("COLLECTIVE_PARTIAL_GRACE_S")


class CpuGroup:
    def __init__(
        self,
        core,
        group_name: str,
        world_size: int,
        rank: int,
        timeout_s: float | None = None,
        epoch: int = 0,
    ):
        self.core = core  # CoreWorker (for RPC + head KV)
        self.base_name = group_name
        self.epoch = epoch
        # Epoch-scoped internal name: a reformed group must never
        # rendezvous against (or serve ops for) a previous incarnation's
        # KV keys / handlers.
        self.name = group_name if epoch == 0 else f"{group_name}~e{epoch}"
        self.world = world_size
        self.rank = rank
        self.timeout_s = (
            _default_timeout() if timeout_s is None else float(timeout_s)
        )
        self.root_addr: str | None = None
        self._seq = 0
        self._pending: dict[tuple, _Pending] = {}  # (op_kind, seq) → state
        # (src, seq) → (deque[payload], deque[waiter futures])
        self._mailbox: dict[tuple, tuple] = {}
        self._dead: set[int] = set()      # ranks declared dead (poison)
        self._destroyed = False
        self._inflight: set[asyncio.Future] = set()  # member-side calls
        self._rank_conns: dict[int, rpc.Connection] = {}  # hub-side
        # straggler telemetry (hub-side): rank → times slowest
        self._straggler_counts: dict[int, int] = {}
        self._ops_completed = 0
        self._last_lag_s = 0.0
        # Partial-mode state (hub-side). _partial_done is the tombstone
        # cache: (kind, seq) → the completed op's reply, kept so a
        # straggler's LATE contribution is acked with the same partial
        # result instead of opening a fresh pending op that can only
        # time out. _skip_events is the sliding window feeding the
        # chronic-skip escalation to the head.
        self._partial_done: "dict[tuple, dict]" = {}
        self._partial_ops = 0
        self._skip_counts: dict[int, int] = {}
        self._skip_events: list[tuple[float, int]] = []
        self._skip_reported: set[int] = set()
        # Adaptive grace: sliding window of full-op first→last lag
        # samples (the straggler-lag histogram's raw feed); the hub
        # derives the partial grace window from its p99 once enough
        # samples exist.
        from collections import deque

        self._lag_samples: "deque[float]" = deque(maxlen=512)
        # Ring/tree p2p algorithm state: op counter for tag scoping and
        # a peer addr cache so each hop is one conn call, not a head KV
        # lookup per send.
        self._algo_seq = 0
        self._peer_addrs: dict[int, str] = {}
        if rank == 0:
            self.core.ext_handlers[f"col_op:{self.name}"] = self._on_op
        self.core.ext_handlers[f"col_sendrecv:{self.name}"] = self._on_sendrecv

    # --------------------------------------------------------- bootstrap
    async def init(self, timeout_s: float | None = None):
        """Rendezvous through the head KV, bounded by the group deadline:
        members that never join surface as CollectiveTimeoutError with
        the missing ranks, not an infinite poll loop."""
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        deadline = time.monotonic() + t
        key = f"collective:{self.name}:{self.rank}"
        await self.core.head.call("kv_put", key=key, value=self.core.addr.encode())
        # Membership registration: the head's table is what lets node /
        # worker death fan out to survivors as a typed abort.
        try:
            await self.core.head.call(
                "collective_register",
                group=self.base_name,
                rank=self.rank,
                epoch=self.epoch,
                addr=self.core.addr,
                node_addr=getattr(self.core, "node_addr", None),
                worker_id=getattr(self.core, "worker_id", None),
            )
        except rpc.RpcError:
            pass  # older head without the membership table: deadline
            # enforcement still works, only death fan-out is lost
        import ray_tpu_torch.collective as _col

        await _col._ensure_death_watch(self.core)
        prefix = f"collective:{self.name}:"
        while True:
            reply = await self.core.head.call("kv_keys", prefix=prefix)
            present = set()
            for k in reply.get("keys", []):
                tail = k[len(prefix):]
                if tail.isdigit():
                    present.add(int(tail))
            if len(present & set(range(self.world))) == self.world:
                break
            if time.monotonic() > deadline:
                missing = sorted(set(range(self.world)) - present)
                await self._cleanup_rendezvous(key)
                raise CollectiveTimeoutError(
                    self.base_name, "rendezvous", t, missing_ranks=missing
                )
            await asyncio.sleep(0.05)
        reply = await self.core.head.call(
            "kv_get", key=f"{prefix}0"
        )
        self.root_addr = reply["value"].decode()

    async def _cleanup_rendezvous(self, key: str):
        """Failed init must not leave a half-registered member behind."""
        self.core.ext_handlers.pop(f"col_op:{self.name}", None)
        self.core.ext_handlers.pop(f"col_sendrecv:{self.name}", None)
        try:
            await self.core.head.call("kv_del", key=key)
            await self.core.head.call(
                "collective_deregister",
                group=self.base_name,
                epoch=self.epoch,
                rank=self.rank,
            )
        except rpc.RpcError:
            pass

    async def destroy(self, reason: str = "destroyed"):
        """Tear down AND fail everything in flight: hub-side pending op
        futures, member-side in-flight calls, and mailbox recv waiters —
        an awaiting coroutine must never stay pending past destroy.

        A tombstone handler replaces the hub's op endpoint so a straggler
        member's LATE op against this incarnation gets a typed answer
        (``reason`` of "reformed" lets auto_reform rejoin the new epoch)
        instead of an unknown-method RpcError."""
        self._destroyed = True

        async def _tombstone(conn, **kw):
            return {"ok": False, "error": reason}

        if self.rank == 0:
            self.core.ext_handlers[f"col_op:{self.name}"] = _tombstone
        self.core.ext_handlers.pop(f"col_sendrecv:{self.name}", None)
        for key, st in list(self._pending.items()):
            st.cancel_timers()
            for _rank, fut in st.futures:
                if not fut.done():
                    fut.set_result({"ok": False, "error": "destroyed"})
        self._pending.clear()
        self._partial_done.clear()
        for call in list(self._inflight):
            call.cancel()
        for payloads, waiters in self._mailbox.values():
            for fut in waiters:
                if not fut.done():
                    fut.set_exception(
                        CollectiveGroupDestroyedError(self.base_name, "recv")
                    )
        self._mailbox.clear()
        try:
            await self.core.head.call(
                "collective_deregister",
                group=self.base_name,
                epoch=self.epoch,
                rank=self.rank,
            )
        except rpc.RpcError:
            pass
        if self.rank == 0:
            for r in range(self.world):
                try:
                    await self.core.head.call(
                        "kv_del", key=f"collective:{self.name}:{r}"
                    )
                except rpc.RpcError:
                    pass

    # ------------------------------------------------- abort-and-reform
    async def reform(self, timeout_s: float | None = None) -> "CpuGroup":
        """Re-run rendezvous with the surviving ranks under a bumped
        epoch: new dense ranks (order-preserving), new world size, the
        lowest surviving rank becomes the hub. Also repairs a desynced
        group after an op timeout (dead set empty → same shape, fresh
        op sequence)."""
        survivors = [r for r in range(self.world) if r not in self._dead]
        if self.rank not in survivors:
            raise CollectiveMemberDiedError(
                self.base_name,
                "reform",
                dead_ranks=sorted(self._dead),
                detail="this rank is itself marked dead",
            )
        g = CpuGroup(
            self.core,
            self.base_name,
            len(survivors),
            survivors.index(self.rank),
            timeout_s=self.timeout_s if timeout_s is None else timeout_s,
            epoch=self.epoch + 1,
        )
        await self.destroy(reason="reformed")
        await g.init()
        g.auto_reform = getattr(self, "auto_reform", False)
        return g

    # ------------------------------------------------ death propagation
    def _on_member_dead(self, ranks, epoch: int | None = None):
        """Head fan-out (or hub conn-loss) declared members dead: poison
        the group and abort everything in flight, now."""
        if self._destroyed:
            return
        if epoch is not None and epoch != self.epoch:
            return  # stale event about a previous incarnation
        dead = {int(r) for r in ranks} - {self.rank}
        if not dead or dead <= self._dead:
            return
        self._dead |= dead
        _ABORT_TOTAL.inc(
            tags={"group": self.base_name, "reason": "member_died"}
        )
        reply = {
            "ok": False,
            "error": "member_died",
            "dead_ranks": sorted(self._dead),
        }
        for key, st in list(self._pending.items()):
            st.cancel_timers()
            for _rank, fut in st.futures:
                if not fut.done():
                    fut.set_result(dict(reply))
        self._pending.clear()
        for call in list(self._inflight):
            call.cancel()
        err = CollectiveMemberDiedError(
            self.base_name, "recv", dead_ranks=sorted(self._dead)
        )
        for payloads, waiters in self._mailbox.values():
            for fut in waiters:
                if not fut.done():
                    fut.set_exception(err)

    def _watch_conn(self, rank: int, conn: rpc.Connection):
        """Hub-side: a member's dropped connection is a death signal —
        abort its group-mates' pending ops instead of waiting out the
        deadline (reference: NCCL comm abort on peer loss)."""
        if self._rank_conns.get(rank) is conn:
            return
        self._rank_conns[rank] = conn
        prev = conn.on_close

        def on_close(c, _prev=prev, _rank=rank):
            if _prev:
                _prev(c)
            if (
                not self._destroyed
                and self._rank_conns.get(_rank) is c
            ):
                self._on_member_dead([_rank])

        conn.on_close = on_close

    def _check_alive(self, op: str):
        if self._destroyed:
            raise CollectiveGroupDestroyedError(self.base_name, op)
        if self._dead:
            raise CollectiveMemberDiedError(
                self.base_name,
                op,
                dead_ranks=sorted(self._dead),
                detail="group is poisoned; reform_group() to continue",
            )

    def _probe_missing(self, ranks):
        """Fire-and-forget head probe: confirm whether silent ranks are
        dead so the next failure is a fast typed abort, and a dead node
        is reaped without waiting out HEALTH_TIMEOUT_S."""
        async def probe():
            try:
                await self.core.head.call(
                    "collective_probe",
                    group=self.base_name,
                    ranks=list(ranks),
                )
            except rpc.RpcError:
                pass

        asyncio.ensure_future(probe())

    # -------------------------------------------------------- hub (rank0)
    async def _on_op(
        self, conn, kind: str, seq: int, rank: int, payload: tuple, meta: dict
    ):
        if self._destroyed:
            return {"ok": False, "error": "destroyed"}
        if self._dead:
            return {
                "ok": False,
                "error": "member_died",
                "dead_ranks": sorted(self._dead),
            }
        key = (kind, seq)
        done = self._partial_done.get(key)
        if done is not None:
            # This op already partially completed without this rank:
            # ack-and-discard the late contribution, answering with the
            # SAME rescaled result + partial metadata (the straggler
            # rejoins typed and op-sequence-synchronized; a fresh
            # pending entry here could only hang until the deadline).
            # reducescatter tombstones are per-rank (each rank's chunk
            # differs); the other kinds share one reply.
            per_rank = done.get("per_rank")
            return per_rank[rank] if per_rank is not None else done["reply"]
        st = self._pending.get(key)
        if st is None:
            st = self._pending[key] = _Pending(self.world)
            timeout = float(meta.get("timeout_s") or self.timeout_s)
            loop = asyncio.get_running_loop()
            st.timer = loop.call_later(timeout, self._expire, key, timeout)
            min_ranks = meta.get("min_ranks")
            if min_ranks is not None and kind in _PARTIAL_KINDS:
                # Two-stage timer: the grace sub-deadline is measured
                # from the FASTEST arrival — which is this one, the
                # contribution that created the pending entry.
                st.min_ranks = max(1, min(int(min_ranks), self.world))
                st.grace_s = float(
                    meta.get("grace_s") or self._resolve_grace()
                )
                st.meta = dict(meta)
                st.grace_timer = loop.call_later(
                    st.grace_s, self._grace_fire, key
                )
        self._watch_conn(rank, conn)
        st.contrib[rank] = _unpack(payload)
        st.arrived += 1
        st.arrive_ts[rank] = time.monotonic()
        fut = asyncio.get_running_loop().create_future()
        st.futures.append((rank, fut))
        if st.arrived == self.world:
            st.cancel_timers()
            self._record_op_stats(kind, st)
            self._complete(key, st, kind, meta)
        elif (
            st.grace_passed
            and st.min_ranks is not None
            and st.arrived >= st.min_ranks
        ):
            # The K-th contribution landed after the grace sub-deadline:
            # proceed now rather than waiting out the hard deadline.
            self._complete_partial(key, st, kind, meta)
        return await fut

    def _grace_fire(self, key: tuple):
        """Grace sub-deadline: proceed with the K-of-N contributions in
        hand; with fewer than K, keep waiting (the K-th arrival or the
        hard deadline resolves the op)."""
        st = self._pending.get(key)
        if st is None:
            return
        st.grace_passed = True
        if st.min_ranks is not None and st.arrived >= st.min_ranks:
            self._complete_partial(key, st, key[0], st.meta)

    def _expire(self, key: tuple, timeout: float):
        """Hub deadline: answer every waiting member with the missing
        ranks, then probe them — a dead member becomes a confirmed
        death, a merely slow one shows up in the straggler stats."""
        st = self._pending.pop(key, None)
        if st is None:
            return
        st.cancel_timers()
        missing = [r for r in range(self.world) if st.contrib[r] is None]
        _ABORT_TOTAL.inc(tags={"group": self.base_name, "reason": "timeout"})
        for r in missing:
            self._straggler_counts[r] = self._straggler_counts.get(r, 0) + 1
            _STRAGGLER_TOTAL.inc(
                tags={"group": self.base_name, "rank": str(r)}
            )
        reply = {
            "ok": False,
            "error": "timeout",
            "missing_ranks": missing,
            "timeout_s": timeout,
            "op": key[0],
        }
        for _rank, fut in st.futures:
            if not fut.done():
                fut.set_result(dict(reply))
        self._probe_missing(missing)

    def _record_op_stats(self, kind: str, st: _Pending):
        self._ops_completed += 1
        if len(st.arrive_ts) < 2:
            return
        first = min(st.arrive_ts.values())
        last = max(st.arrive_ts.values())
        self._last_lag_s = last - first
        # Full-op arrivals only feed the adaptive-grace window: a
        # partial completion's spread is censored at the grace deadline
        # and would bias the p99 down.
        self._lag_samples.append(self._last_lag_s)
        slowest = max(st.arrive_ts, key=st.arrive_ts.get)
        self._straggler_counts[slowest] = (
            self._straggler_counts.get(slowest, 0) + 1
        )
        _LAG_HIST.observe(
            self._last_lag_s, tags={"group": self.base_name, "op": kind}
        )
        _STRAGGLER_TOTAL.inc(
            tags={"group": self.base_name, "rank": str(slowest)}
        )

    def _lag_p99(self) -> float | None:
        if len(self._lag_samples) < _ADAPTIVE_MIN_SAMPLES:
            return None
        return float(np.percentile(np.asarray(self._lag_samples), 99))

    def _resolve_grace(self) -> float:
        """Partial-mode grace window when the caller passed none: the
        straggler-lag histogram's p99 with 1.5x headroom, clamped to
        [COLLECTIVE_GRACE_MIN_S, COLLECTIVE_GRACE_MAX_S] — a group
        whose normal spread is 10ms stops waiting a full second for a
        straggler, and one whose spread is 2s is not strangled by the
        1s static default. Falls back to COLLECTIVE_PARTIAL_GRACE_S
        until enough full-op samples exist (or when the adaptive knob
        is off)."""
        from ray_tpu_torch._private import config

        static = _default_partial_grace()
        if not config.get("COLLECTIVE_ADAPTIVE_GRACE"):
            return static
        p99 = self._lag_p99()
        if p99 is None:
            return static
        return float(
            min(
                max(p99 * 1.5, config.get("COLLECTIVE_GRACE_MIN_S")),
                config.get("COLLECTIVE_GRACE_MAX_S"),
            )
        )

    def straggler_stats(self) -> dict:
        """Hub-side per-rank slowest/missing counts (empty off-hub).
        ``partial_ops`` / ``skip_counts`` cover the K-of-N mode: how
        many ops completed without someone, and who got skipped.
        ``adaptive_grace_s`` is the grace window a partial op with no
        explicit grace_s would get right now; ``lag_p99_s`` the
        histogram percentile behind it (None until enough samples)."""
        return {
            "ops_completed": self._ops_completed,
            "last_lag_s": self._last_lag_s,
            "slowest_counts": dict(self._straggler_counts),
            "partial_ops": self._partial_ops,
            "skip_counts": dict(self._skip_counts),
            "lag_p99_s": self._lag_p99(),
            "adaptive_grace_s": self._resolve_grace(),
        }

    # -------------------------------------------- partial K-of-N (hub)
    def _complete_partial(self, key, st: _Pending, kind: str, meta: dict):
        """Complete an op over the K..N-1 contributions in hand: reduce
        the contributors (dequantized, fp32), rescale SUM by world/K (so
        result/world is the mean over actual contributors), answer every
        waiter with the result + partial metadata, and leave a tombstone
        reply for the stragglers' late contributions.

        Per kind: allreduce returns the rescaled reduction to everyone;
        reducescatter returns each rank ITS chunk of it (per-rank
        tombstones); allgather returns the contributed entries with
        zero-filled slots for the skipped ranks — the skip list, not the
        zeros, is the signal downstream code should branch on."""
        del self._pending[key]
        st.cancel_timers()
        compression = meta.get("compression")
        contributed = sorted(st.arrive_ts)
        skipped = [r for r in range(self.world) if st.contrib[r] is None]
        op = ReduceOp(meta.get("op", "sum"))
        self._partial_ops += 1
        self._ops_completed += 1
        record_partial(self.base_name, kind, skipped)
        now = time.monotonic()
        for r in skipped:
            self._skip_counts[r] = self._skip_counts.get(r, 0) + 1
            self._straggler_counts[r] = self._straggler_counts.get(r, 0) + 1
            _STRAGGLER_TOTAL.inc(
                tags={"group": self.base_name, "rank": str(r)}
            )
            self._skip_events.append((now, r))
        partial_meta = {
            "contributed": contributed,
            "skipped": skipped,
            "world": self.world,
        }
        done: dict
        if kind == "allgather":
            first = _contrib_array(st.contrib[contributed[0]])
            zero = (sys.modules["torch"].zeros_like(first)
                    if codec.is_tensor(first) else np.zeros_like(first))
            entries = [
                st.contrib[r]
                if st.contrib[r] is not None
                else _compress(zero, compression)
                for r in range(self.world)
            ]
            reply = {
                "ok": True,
                "payload": _pack(entries),
                "partial": partial_meta,
            }
            done = {"reply": reply}
        else:
            result = _REDUCERS[op](
                [_contrib_array(st.contrib[r]) for r in contributed]
            )
            if op is ReduceOp.SUM:
                result = result * (self.world / float(len(contributed)))
            if kind == "reducescatter":
                chunks = _array_split(result, self.world)
                per_rank = [
                    {
                        "ok": True,
                        "payload": _pack(_compress(c, compression)),
                        "partial": partial_meta,
                    }
                    for c in chunks
                ]
                done = {"per_rank": per_rank}
            else:
                reply = {
                    "ok": True,
                    "payload": _pack(_compress(result, compression)),
                    "partial": partial_meta,
                }
                done = {"reply": reply}
        for rank, fut in st.futures:
            if not fut.done():
                per_rank = done.get("per_rank")
                fut.set_result(
                    dict(per_rank[rank] if per_rank is not None
                         else done["reply"])
                )
        # Tombstone for the stragglers (bounded: ops complete in seq
        # order, old tombstones can no longer be asked for).
        self._partial_done[key] = done
        while len(self._partial_done) > 128:
            self._partial_done.pop(next(iter(self._partial_done)))
        self._escalate_chronic_skips(now)

    def _escalate_chronic_skips(self, now: float):
        """Report a rank whose skip count crossed the sliding-window
        threshold to the head — feeding the existing chronic-straggler
        drain-and-replace escalation (autoscaler straggler_drain) from
        inside the op instead of waiting on metric-snapshot latency."""
        from ray_tpu_torch._private import config

        window = config.get("COLLECTIVE_SKIP_WINDOW_S")
        threshold = config.get("COLLECTIVE_SKIP_DRAIN_THRESHOLD")
        cutoff = now - window
        self._skip_events = [e for e in self._skip_events if e[0] >= cutoff]
        counts: dict[int, int] = {}
        for _ts, r in self._skip_events:
            counts[r] = counts.get(r, 0) + 1
        for r, n in counts.items():
            if n < threshold or r in self._skip_reported:
                continue
            self._skip_reported.add(r)

            async def report(rank=r, skips=n):
                try:
                    await self.core.head.call(
                        "collective_straggler_report",
                        group=self.base_name,
                        rank=rank,
                        skips=skips,
                        window_s=window,
                    )
                except rpc.RpcError:
                    pass  # older head: the metric-snapshot path still
                    # carries the signal, only the fast escalation is lost

            asyncio.ensure_future(report())

    def _complete(self, key, st: _Pending, kind: str, meta: dict):
        del self._pending[key]
        op = ReduceOp(meta.get("op", "sum"))
        compression = meta.get("compression")
        if compression is None:
            # Classic path: untouched numpy reduce over the raw
            # contributions — byte-identical to before the codec landed.
            contrib = st.contrib
        else:
            # Codec path: dequantize EVERY contribution and accumulate
            # in fp32; only the reply is requantized.
            contrib = [
                _contrib_array(c) if c is not None else None
                for c in st.contrib
            ]
        if kind == "allreduce" or kind == "reduce":
            result = _REDUCERS[op](contrib)
            if compression is not None and kind == "allreduce":
                result = _compress(result, compression)
        elif kind == "allgather":
            # Compressed allgather passes the members' wire payloads
            # through untouched — nothing to reduce, nothing to requant.
            result = list(st.contrib)
        elif kind == "reducescatter":
            red = _REDUCERS[op](contrib)
            result = [
                _compress(c, compression)
                for c in _array_split(red, self.world)
            ]
        elif kind == "broadcast":
            result = st.contrib[meta.get("root", 0)]
        elif kind == "barrier":
            result = None
        else:
            raise rpc.RpcError(f"unknown collective {kind}")
        for rank, fut in st.futures:
            if fut.done():
                continue
            if kind == "reducescatter":
                fut.set_result({"ok": True, "payload": _pack(result[rank])})
            elif kind == "reduce" and rank != meta.get("root", 0):
                fut.set_result({"ok": True, "payload": _pack(None)})
            else:
                fut.set_result({"ok": True, "payload": _pack(result)})

    # ----------------------------------------------------------- verbs
    def _interpret(self, kind: str, reply: dict):
        if reply.get("ok"):
            value = _unpack(reply["payload"]) if "payload" in reply else None
            partial = reply.get("partial")
            if partial is not None:
                return PartialResult(
                    value=value,
                    contributed=[int(r) for r in partial["contributed"]],
                    skipped=[int(r) for r in partial["skipped"]],
                    world=int(partial["world"]),
                )
            return value
        error = reply.get("error")
        if error == "timeout":
            raise CollectiveTimeoutError(
                self.base_name,
                kind,
                reply.get("timeout_s"),
                missing_ranks=reply.get("missing_ranks"),
            )
        if error in ("destroyed", "reformed"):
            raise CollectiveGroupDestroyedError(
                self.base_name,
                kind,
                detail="reformed" if error == "reformed" else "",
            )
        dead = [int(r) for r in reply.get("dead_ranks") or []]
        self._dead.update(d for d in dead if d != self.rank)
        raise CollectiveMemberDiedError(
            self.base_name, kind, dead_ranks=dead
        )

    async def _op(
        self, kind: str, tensor: Any, timeout_s: float | None = None, **meta
    ):
        self._check_alive(kind)
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        self._seq += 1
        seq = self._seq
        # Deterministic straggler injection (RAY_TPU_STRAGGLER_DELAY=
        # "rank:seconds,…"): the named ranks are late to every
        # contribution — the chaos knob the partial-collective and
        # straggler-stats tests are built on. Read per call so tests
        # can flip it at runtime; zero-cost when the spec is unset.
        from ray_tpu_torch._private.test_utils import straggler_delay_for_rank

        delay = straggler_delay_for_rank(self.rank)
        if delay > 0:
            await asyncio.sleep(delay)
        wall_start = time.time()
        t0 = time.perf_counter()
        try:
            conn = await self.core._connect(self.root_addr)
        except rpc.ConnectionLost:
            self._dead.add(0)
            raise CollectiveMemberDiedError(
                self.base_name, kind, dead_ranks=[0],
                detail="cannot reach the hub rank",
            )
        # The packed RPC payloads are the ACTUAL wire bytes of this op:
        # measure them (both directions) for the flight recorder's wire
        # counter — the compression win shows up here, not in the
        # logical byte counter.
        packed = _pack(_compress(tensor, meta.get("compression"))
                       if tensor is not None else tensor)
        wire_sent = _packed_nbytes(packed)
        call = asyncio.ensure_future(
            conn.call(
                f"col_op:{self.name}",
                kind=kind,
                seq=seq,
                rank=self.rank,
                payload=packed,
                meta={**meta, "timeout_s": t},
            )
        )
        self._inflight.add(call)
        try:
            # The hub answers its own deadline; the grace-padded backstop
            # only fires when the hub process itself is gone or wedged.
            reply = await asyncio.wait_for(call, t + _HUB_GRACE_S)
        except asyncio.TimeoutError:
            self._probe_missing([0])
            raise CollectiveTimeoutError(
                self.base_name, kind, t,
                detail="hub rank 0 did not answer within the deadline",
            )
        except asyncio.CancelledError:
            # destroy() / death fan-out cancelled the in-flight call.
            if self._destroyed:
                raise CollectiveGroupDestroyedError(self.base_name, kind)
            if self._dead:
                raise CollectiveMemberDiedError(
                    self.base_name, kind, dead_ranks=sorted(self._dead)
                )
            raise
        except rpc.ConnectionLost:
            self._dead.add(0)
            raise CollectiveMemberDiedError(
                self.base_name, kind, dead_ranks=[0],
                detail="hub connection lost",
            )
        finally:
            self._inflight.discard(call)
        wire_recv = (
            _packed_nbytes(reply["payload"])
            if reply.get("ok") and "payload" in reply
            else 0
        )
        result = self._interpret(kind, reply)
        if meta.get("compression") is not None:
            if isinstance(result, PartialResult):
                result.value = _decompress(result.value)
            else:
                result = _decompress(result)
        if codec.is_tensor(tensor):
            result = _on_device(result, tensor.device)
        record_op(
            self.base_name, kind, "cpu", self.world, tensor,
            wall_start, time.perf_counter() - t0,
            wire_bytes=wire_sent + wire_recv,
        )
        return result

    def _partial_meta(self, meta: dict, min_ranks, grace_s) -> dict:
        if min_ranks is not None:
            if not 1 <= int(min_ranks) <= self.world:
                raise ValueError(
                    f"min_ranks {min_ranks} out of range 1..{self.world}"
                )
            meta["min_ranks"] = int(min_ranks)
            if grace_s is not None:
                meta["grace_s"] = float(grace_s)
        return meta

    def _wrap_partial(self, out, min_ranks):
        if min_ranks is not None and not isinstance(out, PartialResult):
            # Everyone made the grace window: same typed envelope, no
            # skips — callers in partial mode always see PartialResult.
            out = PartialResult(
                value=out,
                contributed=list(range(self.world)),
                skipped=[],
                world=self.world,
            )
        return out

    def _resolve_algo(
        self, algo: str | None, nbytes: int, verb: str = "allreduce"
    ) -> str:
        """None → the hub (the default data plane, byte-identical to
        before algo= existed); "auto" → ring/tree by message size via
        the crossover table; explicit names pass through validated.

        For the reducescatter/allgather verbs (the ZeRO-sharded path's
        two hops) the latency-optimal plane IS the hub star — TREE maps
        to it — so "auto" routes small payloads through the hub and
        large ones onto the ring data plane."""
        if algo is None:
            return colalgo.HUB
        if algo == colalgo.AUTO:
            chosen = colalgo.choose_algorithm(nbytes, self.world, verb=verb)
        elif algo not in (colalgo.HUB, colalgo.RING, colalgo.TREE):
            raise ValueError(
                f"cpu backend supports algo hub/ring/tree/auto, "
                f"got {algo!r}"
            )
        else:
            chosen = algo
        if verb != "allreduce" and chosen == colalgo.TREE:
            return colalgo.HUB
        return chosen

    async def allreduce(
        self,
        tensor,
        op=ReduceOp.SUM,
        timeout_s=None,
        min_ranks: int | None = None,
        grace_s: float | None = None,
        compression: str | None = None,
        algo: str | None = None,
    ):
        """``min_ranks=K`` enables partial K-of-N mode: the hub proceeds
        once K contributions are in hand after ``grace_s`` past the
        fastest arrival, returning PartialResult metadata; with the
        default None the classic all-N path runs unchanged.

        ``compression="int8"`` ships block-scaled int8 on the wire
        (fp32 accumulation at the hub); ``algo=`` picks the data plane —
        hub (default), ring, tree, or auto (crossover by size)."""
        arr = _as_payload(tensor)
        compression = codec.check_codec(compression)
        chosen = self._resolve_algo(algo, arr.nbytes)
        if chosen in (colalgo.RING, colalgo.TREE) and self.world > 1:
            if min_ranks is not None:
                raise ValueError(
                    "partial mode (min_ranks=) requires the hub "
                    "algorithm: ring/tree have no central grace timer"
                )
            return await self._algo_allreduce(
                arr, op, chosen, timeout_s, compression
            )
        meta: dict = {"op": op.value}
        if compression is not None:
            meta["compression"] = compression
        self._partial_meta(meta, min_ranks, grace_s)
        out = await self._op("allreduce", arr, timeout_s=timeout_s, **meta)
        return self._wrap_partial(out, min_ranks)

    async def reduce(self, tensor, root=0, op=ReduceOp.SUM, timeout_s=None):
        return await self._op(
            "reduce", _as_payload(tensor), timeout_s=timeout_s,
            root=root, op=op.value,
        )

    async def broadcast(self, tensor, root=0, timeout_s=None):
        return await self._op(
            "broadcast", _as_payload(tensor), timeout_s=timeout_s, root=root
        )

    async def allgather(
        self,
        tensor,
        timeout_s=None,
        min_ranks: int | None = None,
        grace_s: float | None = None,
        compression: str | None = None,
        algo: str | None = None,
    ):
        """Partial mode (``min_ranks=K``) returns the gathered list with
        zero-filled entries for skipped ranks — the PartialResult's
        ``skipped`` list, not the zeros, is the authoritative signal.
        ``algo=`` picks the data plane (hub default; ring for large
        payloads under "auto" — the ZeRO allgather hop's routing)."""
        arr = _as_payload(tensor)
        compression = codec.check_codec(compression)
        chosen = self._resolve_algo(algo, arr.nbytes, "allgather")
        if chosen == colalgo.RING and self.world > 1:
            if min_ranks is not None:
                raise ValueError(
                    "partial mode (min_ranks=) requires the hub "
                    "algorithm: the ring has no central grace timer"
                )
            return await self._algo_scatter_gather(
                "allgather", arr, None, timeout_s, compression
            )
        meta: dict = {}
        if compression is not None:
            meta["compression"] = compression
        self._partial_meta(meta, min_ranks, grace_s)
        out = await self._op(
            "allgather", arr, timeout_s=timeout_s, **meta
        )
        return self._wrap_partial(out, min_ranks)

    async def reducescatter(
        self,
        tensor,
        op=ReduceOp.SUM,
        timeout_s=None,
        min_ranks: int | None = None,
        grace_s: float | None = None,
        compression: str | None = None,
        algo: str | None = None,
    ):
        """Partial mode rescales SUM by world/K like allreduce; each
        rank still receives its own chunk of the partial reduction.
        ``algo=`` picks the data plane (hub default; ring for large
        payloads under "auto" — the ZeRO reduce hop's routing)."""
        arr = _as_payload(tensor)
        compression = codec.check_codec(compression)
        chosen = self._resolve_algo(algo, arr.nbytes, "reducescatter")
        if chosen == colalgo.RING and self.world > 1:
            if min_ranks is not None:
                raise ValueError(
                    "partial mode (min_ranks=) requires the hub "
                    "algorithm: the ring has no central grace timer"
                )
            return await self._algo_scatter_gather(
                "reducescatter", arr, op, timeout_s, compression
            )
        meta: dict = {"op": op.value}
        if compression is not None:
            meta["compression"] = compression
        self._partial_meta(meta, min_ranks, grace_s)
        out = await self._op(
            "reducescatter", arr, timeout_s=timeout_s, **meta
        )
        return self._wrap_partial(out, min_ranks)

    async def barrier(self, timeout_s=None):
        await self._op("barrier", None, timeout_s=timeout_s)

    # ------------------------------------------- ring / tree algorithms
    # Flat-ring and binomial-tree allreduce over the p2p mailbox ("The
    # Big Send-off", arXiv:2504.18658): the ring moves 2(n-1)/n of the
    # payload per rank across 2(n-1) latency-bound steps
    # (bandwidth-optimal, wins for large messages); the tree moves the
    # full payload across ~2*log2(n) rounds (latency-optimal, wins
    # below the crossover size). Both compose with the int8 codec —
    # every hop quantizes its payload and accumulates in fp32 after
    # dequantizing.

    async def _algo_allreduce(
        self, arr, op, algo_name, timeout_s, compression
    ):
        self._check_alive("allreduce")
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        from ray_tpu_torch._private.test_utils import straggler_delay_for_rank

        delay = straggler_delay_for_rank(self.rank)
        if delay > 0:
            await asyncio.sleep(delay)
        wall_start = time.time()
        t0 = time.perf_counter()
        self._algo_seq += 1
        tag_base = f"_{algo_name}{self._algo_seq}"
        wire = [0]
        run = (
            self._ring_allreduce if algo_name == colalgo.RING
            else self._tree_allreduce
        )
        try:
            result = await asyncio.wait_for(
                run(arr, op, tag_base, compression, wire), t
            )
        except asyncio.TimeoutError:
            missing = sorted(set(range(self.world)) - {self.rank})
            self._probe_missing(missing)
            raise CollectiveTimeoutError(
                self.base_name, "allreduce", t,
                detail=f"{algo_name} algorithm starved waiting on a peer "
                       "hop",
            )
        record_op(
            self.base_name, "allreduce", "cpu", self.world, arr,
            wall_start, time.perf_counter() - t0, wire_bytes=wire[0],
        )
        return result

    async def _algo_scatter_gather(
        self, verb, arr, op, timeout_s, compression
    ):
        """Shared driver for the ring reducescatter / allgather data
        planes (the two hops the ZeRO-sharded gradient path issues):
        deadline, straggler chaos, typed starvation, and honest
        measured wire bytes, mirroring :meth:`_algo_allreduce`."""
        self._check_alive(verb)
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        from ray_tpu_torch._private.test_utils import straggler_delay_for_rank

        delay = straggler_delay_for_rank(self.rank)
        if delay > 0:
            await asyncio.sleep(delay)
        wall_start = time.time()
        t0 = time.perf_counter()
        self._algo_seq += 1
        tag_base = f"_{colalgo.RING}{verb[0]}{self._algo_seq}"
        wire = [0]
        run = (
            self._ring_reducescatter(arr, op, tag_base, compression, wire)
            if verb == "reducescatter"
            else self._ring_allgather(arr, tag_base, compression, wire)
        )
        try:
            result = await asyncio.wait_for(run, t)
        except asyncio.TimeoutError:
            missing = sorted(set(range(self.world)) - {self.rank})
            self._probe_missing(missing)
            raise CollectiveTimeoutError(
                self.base_name, verb, t,
                detail="ring algorithm starved waiting on a peer hop",
            )
        record_op(
            self.base_name, verb, "cpu", self.world, arr,
            wall_start, time.perf_counter() - t0, wire_bytes=wire[0],
        )
        return result

    async def _ring_reducescatter(
        self, arr, op, tag_base, compression, wire
    ):
        """Ring reduce-scatter: the first phase of the ring allreduce —
        n-1 hops, each shipping one 1/n chunk — after which rank r holds
        the fully reduced chunk r (matching the hub's
        ``np.array_split(result, world, axis=0)[r]`` contract)."""
        n, r = self.world, self.rank
        combine = _COMBINERS[op]
        acc_dtype = _acc_dtype(arr, compression)
        chunks = [_as(c, acc_dtype, arr) for c in _array_split(arr, n)]
        right, left = (r + 1) % n, (r - 1) % n
        # After hop s, chunk (r-s-1) mod n holds the running reduction
        # of s+2 ranks; n-1 hops leave rank r owning chunk r's total
        # (the classic schedule ends at (r+1) mod n — start one step
        # earlier so ownership lands on r itself).
        for s in range(n - 1):
            send_idx = (r - s - 1) % n
            recv_idx = (r - s - 2) % n
            got = await self._exchange(
                right, left, f"{tag_base}:rs{s}", chunks[send_idx],
                compression, wire,
            )
            chunks[recv_idx] = combine(
                chunks[recv_idx], _as(got, acc_dtype, arr)
            )
        return _as(chunks[r], arr.dtype, arr)

    async def _ring_allgather(self, arr, tag_base, compression, wire):
        """Ring all-gather: n-1 hops, each forwarding the chunk received
        on the previous hop; returns the per-rank list (the hub
        allgather contract). Chunk shapes may differ per rank (the
        array_split remainder) — the mailbox ships arrays, not fixed
        frames, so unequal hops are fine."""
        n, r = self.world, self.rank
        entries: list = [None] * n
        entries[r] = _as_payload(arr)
        right, left = (r + 1) % n, (r - 1) % n
        cur = entries[r]
        for s in range(n - 1):
            got = await self._exchange(
                right, left, f"{tag_base}:ag{s}", cur, compression, wire
            )
            cur = _as(got, entries[r].dtype, arr)
            entries[(r - s - 1) % n] = cur
        return entries

    async def _exchange(self, dst, src, tag, value, compression, wire):
        """One algorithm hop: send ``value`` to ``dst`` while receiving
        the same-tagged payload from ``src``; returns the received
        array (dequantized when the codec is on)."""
        packed = _pack(_compress(value, compression))
        wire[0] += _packed_nbytes(packed)

        async def _send():
            conn = await self.core._connect(await self._peer_addr(dst))
            await conn.call(
                f"col_sendrecv:{self.name}",
                src_rank=self.rank,
                seq=tag,
                payload=packed,
            )

        send_task = asyncio.ensure_future(_send())
        try:
            got = await self._p2p_recv(src, tag, wire)
        except BaseException:
            # Cancelled/timed out mid-hop: do not let the finally-await
            # of a wedged send block the cancellation itself.
            send_task.cancel()
            raise
        await send_task
        return got

    async def _peer_addr(self, rank: int) -> str:
        addr = self._peer_addrs.get(rank)
        if addr is None:
            reply = await self.core.head.call(
                "kv_get", key=f"collective:{self.name}:{rank}"
            )
            if not reply.get("ok"):
                raise CollectiveMemberDiedError(
                    self.base_name, "allreduce", dead_ranks=[rank],
                    detail=f"rank {rank} left the rendezvous KV",
                )
            addr = reply["value"].decode()
            self._peer_addrs[rank] = addr
        return addr

    async def _p2p_recv(self, src: int, tag, wire):
        payloads, waiters = self._mail_queues((src, tag))
        if payloads:
            packed = payloads.popleft()
        else:
            fut = asyncio.get_running_loop().create_future()
            waiters.append(fut)
            packed = await fut  # outer wait_for bounds the whole op
        # Algo tags are single-use: drop the drained queue entry so a
        # long-lived group does not leak one mailbox slot per hop.
        if not payloads and not waiters:
            self._mailbox.pop((src, tag), None)
        wire[0] += _packed_nbytes(packed)
        got = _unpack(packed)
        if codec.is_wire(got):
            return _dequantize_wire(got, cast=False)
        return got

    async def _ring_allreduce(self, arr, op, tag_base, compression, wire):
        """Flat ring: reduce-scatter (n-1 hops, each 1/n of the
        payload) then all-gather (n-1 more). After hop s of the first
        phase, chunk (rank-s-1) mod n holds the running reduction of
        s+2 ranks; rank r ends owning the fully reduced chunk
        (r+1) mod n."""
        n, r = self.world, self.rank
        combine = _COMBINERS[op]
        acc_dtype = _acc_dtype(arr, compression)
        flat = _as(arr, acc_dtype, arr).reshape(-1)
        length = _numel(flat)
        chunk_len = max(1, -(-length // n))
        padded = _zeros(n * chunk_len, acc_dtype, arr)
        padded[:length] = flat
        chunks = [
            padded[i * chunk_len:(i + 1) * chunk_len].copy()
            if not codec.is_tensor(padded)
            else padded[i * chunk_len:(i + 1) * chunk_len].clone()
            for i in range(n)
        ]
        right, left = (r + 1) % n, (r - 1) % n
        for s in range(n - 1):
            send_idx = (r - s) % n
            recv_idx = (r - s - 1) % n
            got = await self._exchange(
                right, left, f"{tag_base}:rs{s}", chunks[send_idx],
                compression, wire,
            )
            chunks[recv_idx] = combine(
                chunks[recv_idx], _as(got, acc_dtype, arr)
            )
        for s in range(n - 1):
            send_idx = (r + 1 - s) % n
            recv_idx = (r - s) % n
            got = await self._exchange(
                right, left, f"{tag_base}:ag{s}", chunks[send_idx],
                compression, wire,
            )
            chunks[recv_idx] = _as(got, acc_dtype, arr)
        out = _concat(chunks)[:length].reshape(arr.shape)
        return _as(out, arr.dtype, arr)

    async def _tree_allreduce(self, arr, op, tag_base, compression, wire):
        """Binomial tree rooted at rank 0: reduce up (children with
        lowbit m send to parent r-m), broadcast the result back down —
        2*ceil(log2(n)) full-payload rounds, exponentially fewer
        latency terms than the ring."""
        n, r = self.world, self.rank
        combine = _COMBINERS[op]
        acc_dtype = _acc_dtype(arr, compression)
        val = _as(arr, acc_dtype, arr)
        val = val.clone() if codec.is_tensor(val) else val.copy()
        maxmask = 1 << max(0, (n - 1).bit_length())
        lowbit = (r & -r) if r else maxmask
        # Reduce: receive from my children (r+m for m < lowbit),
        # smallest subtree first, then send the subtotal to my parent.
        m = 1
        while m < lowbit:
            child = r + m
            if child < n:
                got = await self._p2p_recv(child, f"{tag_base}:r{m}", wire)
                val = combine(val, _as(got, acc_dtype, arr))
            m <<= 1
        if r != 0:
            packed = _pack(_compress(val, compression))
            wire[0] += _packed_nbytes(packed)
            conn = await self.core._connect(await self._peer_addr(r - lowbit))
            await conn.call(
                f"col_sendrecv:{self.name}",
                src_rank=self.rank,
                seq=f"{tag_base}:r{lowbit}",
                payload=packed,
            )
            # Broadcast: the reduced total comes back from the parent.
            got = await self._p2p_recv(
                r - lowbit, f"{tag_base}:b{lowbit}", wire
            )
            val = _as(got, acc_dtype, arr)
        # Relay down to my children, largest subtree first.
        m = lowbit >> 1
        while m >= 1:
            child = r + m
            if child < n:
                packed = _pack(_compress(val, compression))
                wire[0] += _packed_nbytes(packed)
                conn = await self.core._connect(await self._peer_addr(child))
                await conn.call(
                    f"col_sendrecv:{self.name}",
                    src_rank=self.rank,
                    seq=f"{tag_base}:b{m}",
                    payload=packed,
                )
            m >>= 1
        return _as(_as(val, acc_dtype, arr).reshape(arr.shape), arr.dtype,
                   arr)

    # ------------------------------------------------------- send / recv
    # Mailbox is a queue per (src, seq) so back-to-back sends with the
    # same tag enqueue rather than clobbering an already-resolved future.
    def _mail_queues(self, key):
        q = self._mailbox.get(key)
        if q is None:
            from collections import deque

            q = self._mailbox[key] = (deque(), deque())  # payloads, waiters
        return q

    async def _on_sendrecv(self, conn, src_rank: int, seq: int, payload: tuple):
        payloads, waiters = self._mail_queues((src_rank, seq))
        while waiters:
            fut = waiters.popleft()
            if not fut.done():
                fut.set_result(payload)
                return {"ok": True}
        payloads.append(payload)
        return {"ok": True}

    async def send(self, tensor, dst_rank: int, seq: int = 0, timeout_s=None):
        self._check_alive("send")
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        arr = _as_payload(tensor)
        wall_start = time.time()
        t0 = time.perf_counter()

        async def _send():
            reply = await self.core.head.call(
                "kv_get", key=f"collective:{self.name}:{dst_rank}"
            )
            if not reply["ok"]:
                raise rpc.RpcError(
                    f"rank {dst_rank} not in group {self.name}"
                )
            conn = await self.core._connect(reply["value"].decode())
            await conn.call(
                f"col_sendrecv:{self.name}",
                src_rank=self.rank,
                seq=seq,
                payload=_pack(arr),
            )

        try:
            await asyncio.wait_for(_send(), t)
        except asyncio.TimeoutError:
            raise CollectiveTimeoutError(
                self.base_name, "send", t, missing_ranks=[dst_rank]
            )
        record_op(
            self.base_name, "send", "cpu", self.world, arr,
            wall_start, time.perf_counter() - t0,
        )

    async def recv(self, src_rank: int, seq: int = 0, timeout_s=None):
        self._check_alive("recv")
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        wall_start = time.time()
        t0 = time.perf_counter()
        payloads, waiters = self._mail_queues((src_rank, seq))
        if payloads:
            result = _unpack(payloads.popleft())
        else:
            fut = asyncio.get_running_loop().create_future()
            waiters.append(fut)
            try:
                result = _unpack(await asyncio.wait_for(fut, t))
            except asyncio.TimeoutError:
                raise CollectiveTimeoutError(
                    self.base_name, "recv", t, missing_ranks=[src_rank]
                )
        record_op(
            self.base_name, "recv", "cpu", self.world, result,
            wall_start, time.perf_counter() - t0,
        )
        return result
