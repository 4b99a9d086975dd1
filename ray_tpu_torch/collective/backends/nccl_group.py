"""NCCL collective backends: eager collectives on torch tensors.

Replaces ray_tpu/collective/backends/xla_group.py (the JAX package's
compiled ICI/DCN collectives behind eager verbs), which replaced the
reference's NCCL backend (reference:
python/ray/util/collective/collective_group/nccl_collective_group.py).
On GPUs the verbs are eager: NCCL calls, device-local torch and device
copies, with nothing to compile.

Two flavors:
  NcclMeshGroup — the group is a set of devices visible to this process
      ("ranks" = devices, single controller). Ranks on distinct GPUs run
      NCCL's single-process collectives (``torch.cuda.nccl``); ranks that
      share one device (several ranks on one card), or CPU tensors,
      reduce with device-local torch in rank order. ``route`` names which.
  NcclDistGroup + bootstrap_distributed — ranks are processes; the
      coordinator rendezvous through the head KV publishes a TCPStore
      address in place of the NCCLUniqueID named-actor store, and every
      group gets a ``torch.distributed`` process group of its own (never
      the process-global default), backend "nccl" for CUDA tensors or
      "gloo" when the caller asks for it. NCCL failing raises; the group
      never switches backends by itself.

Numerics: sums run in rank order (the JAX package's psum on CPU agrees to
fp32 reassociation); the int8 codec (collective/codec.py) is bit for bit
the JAX package's; partial mode is the same masked sum with the
``world / Σw`` rescale.
"""

from __future__ import annotations

import asyncio
import datetime
import functools
import json
import threading
import time
from typing import Any, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.collective import algo as colalgo
from ray_tpu_torch.collective import codec
from ray_tpu_torch.collective.flight_recorder import record_op, record_partial
from ray_tpu_torch.collective.types import (
    CollectiveMemberDiedError,
    CollectiveTimeoutError,
    CollectiveWork,
    FutureCollectiveWork,
    PartialResult,
    ReduceOp,
)


def _default_timeout() -> float:
    from ray_tpu_torch._private import config

    return config.get("COLLECTIVE_TIMEOUT_S")


def _default_partial_grace() -> float:
    from ray_tpu_torch._private import config

    return config.get("COLLECTIVE_PARTIAL_GRACE_S")


def _compression_block() -> int:
    from ray_tpu_torch._private import config

    return int(config.get("COLLECTIVE_COMPRESSION_BLOCK"))


def _check_partial_args(op, dtype, min_ranks, world):
    """Partial mode is a masked sum: SUM only (min/max/product have no
    meaningful zero-weight identity under the rescale) over floating
    dtypes (the mask multiply and world/K rescale are float ops)."""
    if op is not ReduceOp.SUM:
        raise ValueError(
            f"partial allreduce supports ReduceOp.SUM only, got {op}"
        )
    if not dtype.is_floating_point:
        raise TypeError(
            f"partial allreduce needs a floating dtype, got {dtype}"
        )
    if min_ranks is not None and not 1 <= int(min_ranks) <= world:
        raise ValueError(
            f"min_ranks {min_ranks} out of range 1..{world}"
        )


def _check_float(dtype, what: str):
    if not dtype.is_floating_point:
        raise TypeError(f"{what} needs a floating dtype, got {dtype}")


class _RecordStateMixin:
    """Per-THREAD flight-recorder state: the reentrancy flag and the
    analytic wire-byte drop box. Thread-local because the async
    dispatch thread runs verbs concurrently with the issuing thread —
    a shared flag would let one thread's in-flight op suppress or
    clobber the other's recording."""

    @property
    def _in_recorded_op(self) -> bool:
        return getattr(self._rec_tl, "flag", False)

    @_in_recorded_op.setter
    def _in_recorded_op(self, v: bool) -> None:
        self._rec_tl.flag = v

    @property
    def _last_wire_bytes(self):
        return getattr(self._rec_tl, "wire", None)

    @_last_wire_bytes.setter
    def _last_wire_bytes(self, v) -> None:
        self._rec_tl.wire = v


def _recorded(verb: str):
    """Flight-recorder wrapper for an eager verb: latency + bytes +
    bus-bandwidth metrics and a timeline SPAN on success. Reentrancy-
    guarded per group — verbs that lower onto other verbs (reduce →
    allreduce, barrier → allreduce, non-sum reducescatter) record only
    the outermost call."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(self, *args, **kw):
            if self._in_recorded_op:
                return fn(self, *args, **kw)
            self._in_recorded_op = True
            # Ops whose transfers the host cannot measure (NCCL's, the
            # device-local route's) deposit their analytic wire-byte
            # count here; None keeps the legacy convention.
            self._last_wire_bytes = None
            wall_start = time.time()
            t0 = time.perf_counter()
            try:
                out = fn(self, *args, **kw)
            finally:
                self._in_recorded_op = False
            record_op(
                self.name, verb, self.backend_tag, self.world,
                args[0] if args else None,
                wall_start, time.perf_counter() - t0,
                wire_bytes=self._last_wire_bytes,
            )
            return out

        return wrapper

    return deco


def _compressed_wire_bytes(world: int, length: int, block: int) -> int:
    """Per-rank analytic wire bytes of the compressed allreduce: the
    all_to_all and the all_gather each move (n-1)/n of the quantized
    payload (int8 data + fp32 scales)."""
    chunk_len = codec.padded_len(-(-max(1, length) // world), block)
    payload = world * (chunk_len + (chunk_len // block) * 4)
    return int(2 * (world - 1) / world * payload)


def _flat_pad(x: torch.Tensor, total: int) -> torch.Tensor:
    flat = x.reshape(-1)
    return torch.nn.functional.pad(flat, (0, total - flat.numel()))


def _numel(shape) -> int:
    return int(np.prod(shape)) if len(shape) else 1


def _combine_(op: ReduceOp, acc: torch.Tensor, x: torch.Tensor):
    """acc = acc (op) x, in place (the streaming combine of a sum in rank
    order)."""
    if op is ReduceOp.SUM:
        acc.add_(x)
    elif op is ReduceOp.PRODUCT:
        acc.mul_(x)
    elif op is ReduceOp.MIN:
        torch.minimum(acc, x, out=acc)
    else:
        torch.maximum(acc, x, out=acc)


def _as_device(d) -> torch.device:
    dev = torch.device(colalgo.device_of(d))
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class NcclCollectiveWork(CollectiveWork):
    """Async handle over the device streams: the verb's kernels (NCCL's
    or device-local torch) are enqueued when the handle exists, and the
    handle OWNS the result tensors — ``wait()`` blocks on a CUDA event
    recorded after them on each device's current stream and returns the
    same value the synchronous verb would have. The flight-recorder
    entry is written once, at completion, with the dispatch→completion
    wall interval and the op's analytic wire bytes, so overlapped device
    time is attributed honestly instead of as a near-zero dispatch
    blip."""

    __slots__ = ("_mgroup", "_out", "_events", "_wall_start", "_t0",
                 "_wire_bytes", "_payload")

    def __init__(self, group, verb, out, events, wall_start, t0, wire_bytes,
                 payload):
        super().__init__(group_name=group.name, verb=verb)
        self._mgroup = group
        self._out = out
        self._events = events
        self._wall_start = wall_start
        self._t0 = t0
        self._wire_bytes = wire_bytes
        self._payload = payload

    def _join(self, timeout_s):
        # In-process device work completes or raises — there is no
        # remote member to wait on, so the local deadline is moot (API
        # parity with the process-backed handles).
        del timeout_s
        for ev in self._events:
            ev.synchronize()
        record_op(
            self._mgroup.name, self.verb, self._mgroup.backend_tag,
            self._mgroup.world, self._payload, self._wall_start,
            time.perf_counter() - self._t0,
            wire_bytes=self._wire_bytes,
        )
        return self._out

    def _probe(self) -> bool:
        return all(ev.query() for ev in self._events)


_NCCL_OPS = {ReduceOp.SUM: 0, ReduceOp.PRODUCT: 1, ReduceOp.MAX: 2,
             ReduceOp.MIN: 3}  # ncclRedOp_t, as torch.cuda.nccl takes it


class NcclMeshGroup(_RecordStateMixin):
    """Eager collectives over the devices visible to this process.

    Single-controller semantics: every verb takes a *sequence* of
    world_size per-rank tensors (rank = device) and returns the per-rank
    results, each on its rank's device. ``devices`` defaults to every
    visible CUDA device; a device may repeat (several ranks on one card)
    and may be a :class:`~ray_tpu_torch.collective.algo.SliceDevice`.
    ``route`` is "nccl" when the ranks are distinct GPUs (NCCL's
    single-process collectives; all-to-all and permute as device-to-device
    copies, which ``torch.cuda.nccl`` has no verb for) and "local"
    otherwise (device-local torch, sums in rank order); ``last_route`` is
    the route of the latest verb."""

    expects_per_rank_tensors = True
    backend_tag = "nccl_mesh"

    def __init__(self, devices: Sequence | None = None,
                 name: str = "nccl_mesh"):
        if devices is None:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        self.devices = list(devices)
        self.world = len(self.devices)
        if not self.world:
            raise ValueError(
                "nccl_mesh: no devices (no CUDA device is visible; pass "
                "devices=)"
            )
        self.name = name
        self._devs = [_as_device(d) for d in self.devices]
        distinct = len(set(self._devs)) == self.world
        self.route = (
            "nccl"
            if self.world > 1 and distinct
            and all(d.type == "cuda" for d in self._devs)
            else "local"
        )
        self.last_route: str | None = None
        self._rec_tl = threading.local()

    # ------------------------------------------------------------ plumbing
    def _stack(self, tensors: Sequence[Any]) -> list[torch.Tensor]:
        """Per-rank tensors, each on its rank's device (a copy only where
        a tensor lies elsewhere); shapes and dtypes must agree."""
        if len(tensors) != self.world:
            raise ValueError(
                f"expected {self.world} per-rank tensors, got {len(tensors)}"
            )
        xs = [torch.as_tensor(t).to(d) for t, d in zip(tensors, self._devs)]
        for x in xs[1:]:
            if x.shape != xs[0].shape or x.dtype != xs[0].dtype:
                raise ValueError(
                    "per-rank tensors must share one shape and dtype, got "
                    f"{tuple(xs[0].shape)} {xs[0].dtype} and "
                    f"{tuple(x.shape)} {x.dtype}"
                )
        self.last_route = self.route
        return xs

    def _fan_out(self, x: torch.Tensor) -> list[torch.Tensor]:
        """One result to every rank: rank 0 keeps ``x``, the others get
        copies on their devices (results never alias each other)."""
        return [x] + [x.to(d, copy=True) for d in self._devs[1:]]

    def _all_reduce(self, xs, op=ReduceOp.SUM) -> list[torch.Tensor]:
        if self.route == "nccl":
            from torch.cuda import nccl

            outs = [torch.empty_like(x) for x in xs]
            nccl.all_reduce([x.contiguous() for x in xs], outs,
                            op=_NCCL_OPS[op])
            return outs
        home = self._devs[0]
        acc = xs[0].to(home, copy=True)
        for x in xs[1:]:
            _combine_(op, acc, x.to(home))
        return self._fan_out(acc)

    def _reduce_scatter(self, xs, op=ReduceOp.SUM) -> list[torch.Tensor]:
        """Rank r gets chunk r (along dim 0) of the reduction."""
        w = self.world
        if self.route == "nccl":
            from torch.cuda import nccl

            outs = [torch.empty((x.shape[0] // w, *x.shape[1:]),
                                dtype=x.dtype, device=x.device) for x in xs]
            nccl.reduce_scatter([x.contiguous() for x in xs], outs,
                                op=_NCCL_OPS[op])
            return outs
        full = self._all_reduce(xs, op)[0]
        chunk = full.shape[0] // w
        return [full[r * chunk:(r + 1) * chunk].to(d, copy=True)
                for r, d in enumerate(self._devs)]

    def _all_gather(self, xs) -> list[torch.Tensor]:
        """Every rank gets the ranks' tensors concatenated along dim 0."""
        if self.route == "nccl":
            from torch.cuda import nccl

            outs = [torch.empty((self.world * x.shape[0], *x.shape[1:]),
                                dtype=x.dtype, device=x.device) for x in xs]
            nccl.all_gather([x.contiguous() for x in xs], outs)
            return outs
        home = self._devs[0]
        return self._fan_out(torch.cat([x.to(home) for x in xs]))

    def _all_to_all(self, chunks) -> list[list[torch.Tensor]]:
        """``chunks[src][dst]`` → ``recv[dst][src]`` on dst's device: the
        all_to_all as device copies (peer copies across GPUs)."""
        return [[chunks[s][d].to(self._devs[d]) for s in range(self.world)]
                for d in range(self.world)]

    # ------------------------------------------------------------- verbs
    # timeout_s is accepted for API parity with the fault-tolerant
    # backends: in-process device collectives either complete or raise —
    # there is no remote member to wait on.
    @_recorded("allreduce")
    def allreduce(
        self,
        tensors: Sequence[Any],
        op=ReduceOp.SUM,
        timeout_s=None,
        min_ranks: int | None = None,
        grace_s=None,
        skip_ranks: Sequence[int] | None = None,
        compression: str | None = None,
        algo: str | None = None,
    ) -> list:
        del timeout_s, grace_s
        if codec.check_codec(compression) is not None:
            # Compressed path subsumes partial: the mask rides the same
            # exchange (weight-0 contributions, world/Σw rescale).
            return self._compressed_allreduce(
                tensors, op, min_ranks, skip_ranks
            )
        if min_ranks is not None or skip_ranks:
            # Single-controller partial mode: local devices cannot
            # straggle on the wire, so the "slow" set is EXPLICIT —
            # ranks flagged by drain notices / external straggler
            # telemetry mask to weight 0 in a masked sum.
            return self._partial_allreduce(
                tensors, op, min_ranks, skip_ranks
            )
        if algo is not None:
            chosen = self._choose_algo(algo, tensors, op)
            if chosen == colalgo.RING:
                return self._ring_allreduce(tensors)
        return self._all_reduce(self._stack(tensors), op)

    def _partial_allreduce(
        self, tensors, op, min_ranks, skip_ranks
    ) -> PartialResult:
        """Masked sum: contribution r is multiplied by weight w_r (0 for
        skipped ranks) and the sum rescaled by world / Σw, so
        result/world equals the mean over actual contributors."""
        xs = self._stack(tensors)
        _check_partial_args(op, xs[0].dtype, min_ranks, self.world)
        skipped = sorted({int(r) for r in (skip_ranks or ())})
        contributed = [r for r in range(self.world) if r not in skipped]
        if len(contributed) < int(min_ranks or 1):
            raise CollectiveTimeoutError(
                self.name,
                "allreduce",
                None,
                missing_ranks=skipped,
                detail=f"masking left {len(contributed)} contributors, "
                       f"below min_ranks {min_ranks}",
            )
        world = self.world
        w = self._weights(skipped, xs[0].dtype)
        tot = self._all_reduce([x * wr for x, wr in zip(xs, w)])
        cnt = self._all_reduce(w)
        out = [t * (world / torch.clamp(c, min=1.0))
               for t, c in zip(tot, cnt)]
        if skipped:
            record_partial(self.name, "allreduce", skipped)
        return PartialResult(
            value=out, contributed=contributed, skipped=skipped, world=world
        )

    def _weights(self, skipped, dtype) -> list[torch.Tensor]:
        """Each rank's 0-d weight (0 for a skipped rank) on its device."""
        return [
            torch.tensor(0.0 if r in skipped else 1.0, dtype=dtype, device=d)
            for r, d in enumerate(self._devs)
        ]

    def _choose_algo(self, algo: str, tensors, op) -> str:
        """Resolve algo=: "tree" keeps the one-shot allreduce, "ring"
        runs reduce-scatter + all-gather (bandwidth-optimal), "auto"
        picks by per-rank message size via the crossover table; a
        multi-slice device set under "auto" routes to the hierarchical
        two-level op."""
        first = tensors[0] if tensors else None
        nbytes = (
            int(torch.as_tensor(first).nbytes) if first is not None else 0
        )
        n_slices = len(
            {getattr(d, "slice_index", 0) for d in self.devices}
        )
        chosen = colalgo.choose_algorithm(
            nbytes, self.world, n_slices=n_slices, override=algo
        )
        if chosen == colalgo.HUB:
            raise ValueError(
                "the hub algorithm is a cpu-backend data plane; "
                "the nccl backends take tree/ring/auto"
            )
        if chosen == colalgo.RING and op is not ReduceOp.SUM:
            # reduce-scatter + all-gather is the SUM decomposition; the
            # one-shot allreduce already handles min/max/product.
            return colalgo.TREE
        return chosen

    def _ring_allreduce(self, tensors: Sequence[Any]) -> list:
        """Bandwidth-optimal decomposition: reduce-scatter + all-gather
        of the flat payload padded to a multiple of world."""
        xs = self._stack(tensors)
        shape = xs[0].shape
        length = _numel(shape)
        padded = -(-max(1, length) // self.world) * self.world
        shards = self._reduce_scatter([_flat_pad(x, padded) for x in xs])
        full = self._all_gather(shards)
        self._last_wire_bytes = colalgo.wire_bytes_per_rank(
            colalgo.RING, length * xs[0].element_size(), self.world
        )
        return [f[:length].reshape(shape) for f in full]

    def _compressed_allreduce(
        self, tensors, op, min_ranks, skip_ranks
    ):
        """Block-scaled int8 allreduce: each rank quantizes its payload as
        ``world`` destination chunks → all_to_all int8 + scales →
        dequantize and ACCUMULATE IN FP32 (sources in rank order) →
        rescale by world/Σw (partial-mode mask) → requantize the reduced
        chunk → all_gather int8 back → dequantize. Results are fp32, as
        the JAX package's are. Composes with partial mode: skip_ranks
        mask to weight 0 inside the same exchange."""
        xs = self._stack(tensors)
        if op is not ReduceOp.SUM:
            raise ValueError(
                f"compressed allreduce supports ReduceOp.SUM only, "
                f"got {op}"
            )
        _check_float(xs[0].dtype, "compressed allreduce")
        partial = min_ranks is not None or bool(skip_ranks)
        skipped = sorted({int(r) for r in (skip_ranks or ())})
        contributed = [r for r in range(self.world) if r not in skipped]
        if partial and len(contributed) < int(min_ranks or 1):
            raise CollectiveTimeoutError(
                self.name,
                "allreduce",
                None,
                missing_ranks=skipped,
                detail=f"masking left {len(contributed)} contributors, "
                       f"below min_ranks {min_ranks}",
            )
        block = _compression_block()
        world = self.world
        shape = xs[0].shape
        length = _numel(shape)
        chunk_len = codec.padded_len(-(-max(1, length) // world), block)
        nblk = chunk_len // block
        w = self._weights(skipped, xs[0].dtype)
        qs, ss = [], []
        for x, wr in zip(xs, w):
            flat = _flat_pad(x.float() * wr, world * chunk_len)
            q, sc = codec.quantize_blocked_torch(
                flat.reshape(world, nblk, block)
            )
            qs.append(q)
            ss.append(sc)
        q_t = self._all_to_all(qs)
        s_t = self._all_to_all(ss)
        cnt = self._all_reduce(w)
        q2s, s2s = [], []
        for r in range(world):
            red = q_t[r][0].float() * s_t[r][0][..., None]
            for src in range(1, world):  # fp32 accumulate, rank order
                red.add_(q_t[r][src].float() * s_t[r][src][..., None])
            red = red * (world / torch.clamp(cnt[r], min=1.0)).float()
            q2, s2 = codec.quantize_blocked_torch(red)
            q2s.append(q2)
            s2s.append(s2)
        qg = self._all_gather(q2s)  # [world * nblk, block] per rank
        sg = self._all_gather(s2s)
        result = [
            (q.float() * s[..., None]).reshape(-1)[:length].reshape(shape)
            for q, s in zip(qg, sg)
        ]
        self._last_wire_bytes = _compressed_wire_bytes(
            world, length, block
        )
        if not partial:
            return result
        if skipped:
            record_partial(self.name, "allreduce", skipped)
        return PartialResult(
            value=result, contributed=contributed, skipped=skipped,
            world=world,
        )

    # ------------------------------------------------------ async verbs
    def _verb_async(self, verb: str, args, kw) -> CollectiveWork:
        """Enqueue a verb and hand back a handle owning the results. The
        verb body only launches device work (nothing reads a value back),
        so calling it here returns at dispatch; an event recorded on each
        CUDA device's current stream marks completion, and the
        flight-recorder entry moves to the handle's completion."""
        wall_start = time.time()
        t0 = time.perf_counter()
        prev = self._in_recorded_op
        self._in_recorded_op = True  # the handle records, not the verb
        if not prev:
            self._last_wire_bytes = None
        try:
            out = getattr(self, verb)(*args, **kw)
        finally:
            self._in_recorded_op = prev
        events = []
        for dev in sorted({d for d in self._devs if d.type == "cuda"},
                          key=lambda d: d.index):
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(dev))
            events.append(ev)
        return NcclCollectiveWork(
            self, verb, out, events, wall_start, t0, self._last_wire_bytes,
            args[0] if args else None,
        )

    def allreduce_async(self, tensors: Sequence[Any], **kw) -> CollectiveWork:
        """Async :meth:`allreduce`: returns a :class:`CollectiveWork`
        immediately; composes with every sync kwarg (op/min_ranks/
        skip_ranks/compression/algo) — partial mode resolves its mask at
        dispatch (the skip set is explicit on this backend), so
        ``wait()`` returns the same PartialResult envelope."""
        return self._verb_async("allreduce", (tensors,), kw)

    def reducescatter_async(
        self, tensors: Sequence[Any], **kw
    ) -> CollectiveWork:
        return self._verb_async("reducescatter", (tensors,), kw)

    def allgather_async(self, tensors: Sequence[Any], **kw) -> CollectiveWork:
        return self._verb_async("allgather", (tensors,), kw)

    @_recorded("broadcast")
    def broadcast(
        self, tensors: Sequence[Any], root: int = 0, timeout_s=None
    ) -> list:
        del timeout_s
        src = torch.as_tensor(tensors[root]).to(self._devs[root])
        self.last_route = self.route
        if self.route == "nccl":
            from torch.cuda import nccl

            outs = [src.clone() if r == root else
                    torch.empty_like(src, device=d)
                    for r, d in enumerate(self._devs)]
            # On the card torch.cuda.nccl took the list's first tensor as
            # the source whatever its root argument (sharded_chip.py
            # nccl-ranks): the root goes first, as root 0.
            nccl.broadcast([outs[root]] + [t for r, t in enumerate(outs)
                                           if r != root], root=0)
            return outs
        return [src.to(d, copy=True) for d in self._devs]

    @_recorded("allgather")
    def allgather(
        self, tensors: Sequence[Any], timeout_s=None,
        compression: str | None = None,
        algo: str | None = None,
    ) -> list:
        del timeout_s
        xs = self._stack(tensors)
        # all_gather has one data plane (NCCL's ring, or one local
        # concatenation); algo= is accepted for selector parity and the
        # wire is priced as the ring.
        del algo
        if codec.check_codec(compression) is not None:
            return self._compressed_allgather(xs)
        out = self._all_gather(xs)
        nbytes = xs[0].nbytes if xs[0].dim() else xs[0].element_size()
        self._last_wire_bytes = colalgo.wire_bytes_per_rank(
            colalgo.RING, nbytes, self.world, verb="allgather"
        )
        return out

    def _compressed_allgather(self, xs) -> list:
        """Quantize the local payload → all_gather int8 + scales →
        dequantize: the gather's wire traffic is the compressed size."""
        _check_float(xs[0].dtype, "compressed allgather")
        block = _compression_block()
        world = self.world
        shape = xs[0].shape
        length = _numel(shape)
        padded = codec.padded_len(length, block)
        qs, ss = zip(*(codec.quantize_blocked_torch(
            _flat_pad(x.float(), padded).reshape(-1, block)) for x in xs))
        qg = self._all_gather(list(qs))
        sg = self._all_gather(list(ss))
        out = []
        for q, s in zip(qg, sg):
            deq = (q.float() * s[..., None]).reshape(world, -1)[:, :length]
            out.append(deq.reshape(world, *shape).reshape(
                world * shape[0] if len(shape) else world, *shape[1:]
            ).to(xs[0].dtype))
        q_payload = padded + (padded // block) * 4
        self._last_wire_bytes = int(
            (world - 1) / world * world * q_payload
        )
        return out

    @_recorded("reducescatter")
    def reducescatter(
        self, tensors: Sequence[Any], op=ReduceOp.SUM, timeout_s=None,
        compression: str | None = None,
        algo: str | None = None,
        min_ranks: int | None = None,
        grace_s=None,
        skip_ranks: Sequence[int] | None = None,
    ) -> list:
        del timeout_s, grace_s
        xs = self._stack(tensors)
        if xs[0].shape[0] % self.world:
            raise ValueError(
                f"reducescatter dim0 {xs[0].shape[0]} not divisible by "
                f"world {self.world}"
            )
        nbytes = xs[0].nbytes
        if codec.check_codec(compression) is not None:
            if op is not ReduceOp.SUM:
                raise ValueError(
                    "compressed reducescatter supports ReduceOp.SUM only"
                )
            if min_ranks is not None or skip_ranks:
                raise ValueError(
                    "compressed reducescatter does not compose with "
                    "partial mode yet: drop min_ranks/skip_ranks or "
                    "compression"
                )
            return self._compressed_reducescatter(xs)
        if min_ranks is not None or skip_ranks:
            # Partial K-of-N on the reduce hop (the ZeRO reduce-scatter
            # composes with allow_partial_grads): masked reduce-scatter —
            # skipped ranks contribute weight 0, SUM rescaled world/Σw.
            return self._partial_reducescatter(
                xs, op, min_ranks, skip_ranks
            )
        if op is ReduceOp.SUM:
            chosen = colalgo.RING
            if algo is not None:
                chosen = colalgo.choose_algorithm(
                    nbytes, self.world, override=algo,
                    verb="reducescatter",
                )
            if chosen == colalgo.TREE:
                # Latency-optimal one-shot: full allreduce, keep our
                # slice — the small-payload branch of the selector.
                full = self._all_reduce(xs)
                chunk = full[0].shape[0] // self.world
                self._last_wire_bytes = colalgo.wire_bytes_per_rank(
                    colalgo.TREE, nbytes, self.world,
                    verb="reducescatter",
                )
                return [f[r * chunk:(r + 1) * chunk].clone()
                        for r, f in enumerate(full)]
            self._last_wire_bytes = colalgo.wire_bytes_per_rank(
                colalgo.RING, nbytes, self.world, verb="reducescatter"
            )
            return self._reduce_scatter(xs)
        # Non-sum reductions: reduce via the matching allreduce, then each
        # rank keeps its slice.
        reduced = self.allreduce(tensors, op=op)
        chunk = reduced[0].shape[0] // self.world
        return [
            r[i * chunk : (i + 1) * chunk] for i, r in enumerate(reduced)
        ]

    def _partial_reducescatter(
        self, xs, op, min_ranks, skip_ranks
    ) -> PartialResult:
        """Masked reduce-scatter: contribution r is weighted w_r (0 for
        skipped ranks), the scattered SUM rescaled by world/Σw — the
        same semantics as :meth:`_partial_allreduce` applied to the
        ZeRO reduce hop. The gather hop never runs partial (a skipped
        OWNER would zero its weight shard, not merely degrade it)."""
        _check_partial_args(op, xs[0].dtype, min_ranks, self.world)
        skipped = sorted({int(r) for r in (skip_ranks or ())})
        contributed = [r for r in range(self.world) if r not in skipped]
        if len(contributed) < int(min_ranks or 1):
            raise CollectiveTimeoutError(
                self.name,
                "reducescatter",
                None,
                missing_ranks=skipped,
                detail=f"masking left {len(contributed)} contributors, "
                       f"below min_ranks {min_ranks}",
            )
        world = self.world
        w = self._weights(skipped, xs[0].dtype)
        shards = self._reduce_scatter([x * wr for x, wr in zip(xs, w)])
        cnt = self._all_reduce(w)
        out = [s * (world / torch.clamp(c, min=1.0))
               for s, c in zip(shards, cnt)]
        if skipped:
            record_partial(self.name, "reducescatter", skipped)
        return PartialResult(
            value=out, contributed=contributed, skipped=skipped, world=world
        )

    def _compressed_reducescatter(self, xs) -> list:
        """Quantized chunks → all_to_all int8 → fp32 dequant-accumulate:
        each rank ends with its fully reduced slice, having moved only
        int8 on the wire (the first half of the compressed allreduce —
        no requantize, the result never travels again)."""
        _check_float(xs[0].dtype, "compressed reducescatter")
        block = _compression_block()
        world = self.world
        shape = xs[0].shape
        chunk_shape = (shape[0] // world, *shape[1:])
        clen = _numel(chunk_shape)
        padded = codec.padded_len(clen, block)
        qs, ss = [], []
        for x in xs:
            v = torch.nn.functional.pad(
                x.float().reshape(world, clen), (0, padded - clen)
            )
            q, sc = codec.quantize_blocked_torch(v.reshape(world, -1, block))
            qs.append(q)
            ss.append(sc)
        q_t = self._all_to_all(qs)
        s_t = self._all_to_all(ss)
        out = []
        for r in range(world):
            red = q_t[r][0].float() * s_t[r][0][..., None]
            for src in range(1, world):
                red.add_(q_t[r][src].float() * s_t[r][src][..., None])
            out.append(red.reshape(-1)[:clen].reshape(chunk_shape)
                       .to(xs[0].dtype))
        q_payload = world * (padded + (padded // block) * 4)
        self._last_wire_bytes = int((world - 1) / world * q_payload)
        return out

    @_recorded("permute")
    def permute(self, tensors: Sequence[Any], perm: list[tuple[int, int]]):
        """collective_permute: rank ``dst`` of each ``(src, dst)`` pair
        gets rank ``src``'s tensor, every other rank zeros (a device
        copy; across GPUs a peer copy)."""
        xs = self._stack(tensors)
        out = [torch.zeros_like(x) for x in xs]
        for src, dst in perm:
            out[dst] = xs[src].to(self._devs[dst], copy=True)
        return out

    @_recorded("reduce")
    def reduce(
        self, tensors: Sequence[Any], root: int = 0, op=ReduceOp.SUM,
        timeout_s=None,
    ):
        """Single-controller semantics: returns the reduced tensor (the
        'root' distinction is process-level and meaningless in-process)."""
        del root, timeout_s
        return self.allreduce(tensors, op=op)

    def send(self, *a, **kw):
        raise NotImplementedError(
            "nccl_mesh is single-controller: point-to-point movement is "
            "`permute` (a device copy between ranks), not send/recv"
        )

    recv = send

    @_recorded("barrier")
    def barrier(self, timeout_s=None):
        del timeout_s
        self.allreduce([torch.zeros((), dtype=torch.int32, device=d)
                        for d in self._devs])


def _make_process_group(dist_backend: str, store, rank: int, world: int,
                        timeout_s: float):
    """A process group of the group's own over ``store`` (the
    process-global default group is never touched, so one process may
    join several named groups)."""
    timeout = datetime.timedelta(seconds=max(1.0, float(timeout_s)))
    if dist_backend == "gloo":
        return dist.ProcessGroupGloo(store, rank, world, timeout)
    if dist_backend == "nccl":
        if not dist.is_nccl_available():
            raise RuntimeError(
                "the nccl backend needs PyTorch built with NCCL; pass "
                "dist_backend='gloo' to run the group on gloo"
            )
        opts = dist.ProcessGroupNCCL.Options()
        opts._timeout = timeout
        return dist.ProcessGroupNCCL(store, rank, world, opts)
    raise ValueError(
        f"unknown dist_backend {dist_backend!r}; 'nccl' or 'gloo'"
    )


def _opts(cls, **fields):
    o = cls()
    for k, v in fields.items():
        setattr(o, k, v)
    return o


_DIST_OPS = {
    ReduceOp.SUM: dist.ReduceOp.SUM,
    ReduceOp.PRODUCT: dist.ReduceOp.PRODUCT,
    ReduceOp.MIN: dist.ReduceOp.MIN,
    ReduceOp.MAX: dist.ReduceOp.MAX,
}


class NcclDistGroup(_RecordStateMixin):
    """Multi-process eager collectives: rank = process.

    Every process calls the same verb with *its own* tensor. The group
    owns a ``torch.distributed`` process group built over the TCPStore
    that :func:`bootstrap_distributed` publishes (``store``):
    ``dist_backend`` "nccl" (CUDA tensors; the default) or "gloo", only
    when the caller passes it. On gloo a CUDA tensor is staged through
    host memory explicitly, one copy each way (gloo's send/recv does not
    take CUDA tensors); ``last_route`` says "gloo:host" then, "gloo" for
    CPU tensors, "nccl" on NCCL. Results come back on the caller's
    device. Tested with real process boundaries over gloo on the CPU
    (tests/test_torch_collective_dist.py); on GPUs the same code runs
    over NCCL.
    """

    expects_per_rank_tensors = False
    backend_tag = "nccl"

    def __init__(
        self,
        world_size: int,
        rank: int,
        timeout_s: float | None = None,
        name: str = "nccl",
        core=None,
        store=None,
        dist_backend: str = "nccl",
    ):
        if store is None:
            raise ValueError(
                "NcclDistGroup needs the store bootstrap_distributed "
                "returns (or a torch.distributed Store)"
            )
        self.world = world_size
        self.rank = rank
        self.name = name
        self.base_name = name
        self.epoch = 0
        self.core = core  # CoreWorker, for head membership deregistration
        self.store = store
        self.dist_backend = dist_backend
        self.last_route: str | None = None
        self._rec_tl = threading.local()
        # Poison state, fed by the head's death fan-out (see
        # _on_member_dead): the deadline-bounded sync polls this BETWEEN
        # bounded waits, so a fan-out interrupts a wedged collective
        # well before its deadline, not at it.
        self._dead: set[int] = set()
        self.timeout_s = (
            _default_timeout() if timeout_s is None else float(timeout_s)
        )
        self._pg = _make_process_group(
            dist_backend, dist.PrefixStore(f"pg:{name}", store), rank,
            world_size, self.timeout_s or _default_timeout(),
        )
        # NCCL's ranks run on this process's current CUDA device.
        self._cuda = (torch.device("cuda", torch.cuda.current_device())
                      if dist_backend == "nccl" else None)
        self._sync_pool: Any = None  # lazy single-thread deadline pool
        # Lazy single-thread async-dispatch pool: one thread keeps the
        # issue order of handle-based ops identical across ranks (a
        # reordered collective is a deadlock).
        self._dispatch_pool: Any = None
        self._gate_seq = 0  # partial-mode pre-op gate sequence
        self._sends: list = []  # (work, tensor) of posted p2p sends
        self._last_wire_bytes: int | None = None

    # ------------------------------------------------------------ plumbing
    def _local(self, tensor) -> tuple[torch.Tensor, torch.device]:
        """(the tensor the process group takes, the caller's device): a
        CUDA tensor on gloo is copied to host memory here, explicitly."""
        x = torch.as_tensor(tensor)
        dev = x.device
        if self.dist_backend == "gloo":
            if dev.type == "cuda":
                self.last_route = "gloo:host"
                return x.to("cpu").contiguous(), dev
            self.last_route = "gloo"
        else:
            if dev.type != "cuda":
                raise ValueError(
                    f"group {self.name!r} runs NCCL, which takes CUDA "
                    f"tensors only, got one on {dev} (pass "
                    "dist_backend='gloo' for CPU tensors)"
                )
            self.last_route = "nccl"
        return x.contiguous(), dev

    def _on_member_dead(self, ranks, epoch: int | None = None):
        """Head fan-out declared members dead: poison the group. The
        sync loop (and every future op's entry check) turns this into a
        typed abort — the waiting THREAD stops waiting immediately."""
        if epoch is not None and epoch != self.epoch:
            return
        self._dead.update(
            int(r) for r in (ranks or []) if int(r) != self.rank
        )

    def _check_poisoned(self, op: str):
        if self._dead:
            raise CollectiveMemberDiedError(
                self.name,
                op,
                dead_ranks=sorted(self._dead),
                detail="re-form the group to recover",
            )

    async def destroy(self):
        """Deregister from the head's membership table and release the
        process group. Sends still in flight are waited for first
        (bounded by the group's deadline: a posted send has not delivered
        its data until its peer receives it). Queued-but-unstarted async
        dispatches are cancelled — their handles fail typed
        (CollectiveGroupDestroyedError) instead of hanging."""
        sends, self._sends = self._sends, []
        for work, _buf in sends:
            try:
                await asyncio.to_thread(self._sync, work, "send", None)
            # tpulint: allow(broad-except reason=a peer that never received: teardown goes on, the send is abandoned with the group)
            except Exception:
                pass
        if self._sync_pool is not None:
            self._sync_pool.shutdown(wait=False)
            self._sync_pool = None
        if self._dispatch_pool is not None:
            self._dispatch_pool.shutdown(wait=False, cancel_futures=True)
            self._dispatch_pool = None
        if self.core is not None:
            try:
                await self.core.head.call(
                    "collective_deregister",
                    group=self.base_name,
                    epoch=self.epoch,
                    rank=self.rank,
                )
            # tpulint: allow(broad-except reason=deregistration during teardown; the head may already be gone and the membership table reaps dead members anyway)
            except Exception:
                pass

    _POISON_POLL_S = 0.25

    def _sync(self, work, op: str, timeout_s):
        """Deadline-bounded wait for one process-group op. A peer process
        dying mid-op leaves the op blocked with no abort handle; waiting
        on a side thread turns that silent hang into a typed
        CollectiveTimeoutError at the deadline. Between bounded waits the
        loop polls the group's poison flag, so a head death fan-out
        aborts the wait as soon as it arrives. The wedged thread is
        abandoned — the caller is expected to tear down / re-form the
        group. (Work.is_completed alone cannot be polled: gloo's
        reduce-scatter runs inside wait().)"""
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        if t and t > 0:
            if self._sync_pool is None:
                from concurrent.futures import ThreadPoolExecutor

                self._sync_pool = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix="nccl_col_sync"
                )
            from concurrent.futures import TimeoutError as _FutTimeout

            fut = self._sync_pool.submit(self._block, work)
            deadline = time.monotonic() + t
            while True:
                if self._dead:
                    # Abandon the wedged wait NOW — the fan-out beat the
                    # deadline. Fresh pool for the post-reform op.
                    self._sync_pool = None
                    self._check_poisoned(op)
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    self._sync_pool = None
                    raise CollectiveTimeoutError(
                        self.name, op, t,
                        detail="collective never completed (peer process "
                               "lost?); re-form the group to recover",
                    )
                try:
                    fut.result(min(self._POISON_POLL_S, remaining))
                    break
                except _FutTimeout:
                    continue
            if self.dist_backend == "nccl":
                # Orders the caller's current stream after the op (gloo's
                # wait must not run twice: a second recv wait waits for
                # another message).
                work.wait()
        else:
            work.wait()

    def _block(self, work):
        """Wait until ``work`` has finished on the host's clock (NCCL's
        wait() only orders a stream: sync the stream it ordered)."""
        if self.dist_backend == "nccl":
            with torch.cuda.device(self._cuda):
                work.wait()
                torch.cuda.current_stream(self._cuda).synchronize()
        else:
            work.wait()

    def _run(self, op: str, timeout_s, issue):
        """Issue one process-group op (``issue()`` returns its Work) and
        wait for it under the deadline."""
        self._sync(issue(), op, timeout_s)

    def _allreduce_t(self, x, op, timeout_s, verb="allreduce"):
        self._run(verb, timeout_s, lambda: self._pg.allreduce(
            [x], _opts(dist.AllreduceOptions, reduceOp=_DIST_OPS[op])))
        return x

    def _allgather_t(self, x, timeout_s, verb="allgather"):
        out = torch.empty((self.world * x.shape[0], *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._run(verb, timeout_s,
                  lambda: self._pg._allgather_base(out, x))
        return out

    def _all_to_all_t(self, x, timeout_s, verb):
        """Chunk d (along dim 0) of ``x`` to rank d; returns the chunks
        received, source rank order along dim 0."""
        out = torch.empty_like(x)
        self._run(verb, timeout_s, lambda: self._pg.alltoall_base(
            out, x, [], [], dist.AllToAllOptions()))
        return out

    @_recorded("allreduce")
    def allreduce(
        self,
        tensor,
        op=ReduceOp.SUM,
        timeout_s=None,
        min_ranks: int | None = None,
        grace_s: float | None = None,
        compression: str | None = None,
        algo: str | None = None,
    ):
        self._check_poisoned("allreduce")
        if codec.check_codec(compression) is not None:
            return self._compressed_allreduce_dist(
                tensor, op, min_ranks, grace_s, timeout_s
            )
        if min_ranks is not None:
            return self._partial_allreduce(
                tensor, op, min_ranks, grace_s, timeout_s
            )
        x, dev = self._local(tensor)
        if algo is not None:
            chosen = colalgo.choose_algorithm(
                int(x.nbytes), self.world, override=algo,
            )
            if chosen == colalgo.RING and op is ReduceOp.SUM:
                length = x.numel()
                padded = -(-max(1, length) // self.world) * self.world
                shard = torch.empty(padded // self.world, dtype=x.dtype,
                                    device=x.device)
                flat = _flat_pad(x, padded)
                self._run("allreduce", timeout_s,
                          lambda: self._pg._reduce_scatter_base(
                              shard, flat, _opts(dist.ReduceScatterOptions,
                                                 reduceOp=dist.ReduceOp.SUM)))
                full = self._allgather_t(shard, timeout_s)
                self._last_wire_bytes = colalgo.wire_bytes_per_rank(
                    colalgo.RING, length * x.element_size(), self.world
                )
                return full[:length].reshape(x.shape).to(dev)
        out = x.clone() if x.device == dev else x
        return self._allreduce_t(out, op, timeout_s).to(dev)

    def _coord_gate_open_ts(self, key: str, now: float) -> float | None:
        """First-arrival timestamp via the group's TCPStore: every rank
        races one compare-and-set of ``key`` from absent (first writer
        wins) and reads back the winner. Returns None when the store is
        unavailable (head-KV fallback applies)."""
        try:
            got = self.store.compare_set(key, "", repr(now))
            return float(got.decode() if isinstance(got, bytes) else got)
        # tpulint: allow(broad-except reason=store mid-teardown; gate falls back to head-KV pricing)
        except Exception:
            return None

    def _gate_weight(self, grace_s: float) -> float:
        """Pre-op bounded barrier, self-flagging: the first rank to
        reach the op claims a gate-open timestamp; a rank arriving more
        than ``grace_s`` later contributes with weight 0. Each rank
        owns only ITS OWN weight, so clock skew or races can never make
        the op's inputs inconsistent — a mis-decided rank merely
        includes/excludes itself. No waiting happens here: the
        collective is the synchronization point, the gate only prices
        the contribution.

        The claim goes through the group's TCPStore (the same fault
        domain as the op, not behind head-KV wall clocks); the head KV
        remains the fallback."""
        self._gate_seq += 1
        key = f"pgate:{self.name}:{self._gate_seq}"
        now = time.time()
        open_ts = self._coord_gate_open_ts(key, now)
        if open_ts is not None:
            return 0.0 if (now - open_ts) > grace_s else 1.0
        if self.core is None:
            return 1.0

        async def claim():
            reply = await self.core.head.call("kv_get", key=key)
            if reply.get("ok"):
                return float(reply["value"].decode())
            await self.core.head.call("kv_put", key=key, value=str(now).encode())
            if self._gate_seq > 1 and self.rank == 0:
                # Best-effort GC of the previous op's gate key. A
                # straggler still on that seq just re-claims it and
                # self-prices at weight 1 — the safe direction.
                await self.core.head.call(
                    "kv_del", key=f"pgate:{self.name}:{self._gate_seq - 1}"
                )
            return now

        try:
            import ray_tpu_torch.api as _api

            open_ts = _api._runtime.run(claim())
        except Exception as e:  # noqa: BLE001 - gate is advisory
            import logging

            logger = logging.getLogger("ray_tpu_torch.collective")
            logger.debug(
                "partial gate unavailable (%s): contributing at weight 1",
                e,
            )
            return 1.0
        return 0.0 if (now - open_ts) > grace_s else 1.0

    def _mask(self, w_self: float, dtype, device, verb, timeout_s):
        """Every rank's gate weight, gathered (rank order)."""
        return self._allgather_t(
            torch.tensor([w_self], dtype=dtype, device=device), timeout_s,
            verb,
        )

    def _partial_result(self, out, maskv, verb, min_ranks, grace):
        world = self.world
        contributed = [r for r in range(world) if maskv[r] > 0]
        skipped = [r for r in range(world) if maskv[r] <= 0]
        if len(contributed) < int(min_ranks):
            raise CollectiveTimeoutError(
                self.name,
                verb,
                grace,
                missing_ranks=skipped,
                detail=f"only {len(contributed)} contributions beat the "
                       f"partial grace window, below min_ranks {min_ranks}",
            )
        if skipped and self.rank == 0:
            record_partial(self.name, verb, skipped)
        return PartialResult(
            value=out, contributed=contributed, skipped=skipped, world=world
        )

    def _partial_allreduce(self, tensor, op, min_ranks, grace_s, timeout_s):
        """Masked sum: every rank contributes ``(grad * w, w)`` where
        w∈{0,1} comes from the pre-op gate, so the op's shape never
        changes whoever straggles. The gathered weight mask doubles as
        the skipped-rank metadata; the rescale is world/Σw."""
        grace = (
            float(grace_s) if grace_s is not None
            else _default_partial_grace()
        )
        x, dev = self._local(tensor)
        _check_partial_args(op, x.dtype, min_ranks, self.world)
        w_self = self._gate_weight(grace)
        mask = self._mask(w_self, x.dtype, x.device, "allreduce", timeout_s)
        tot = self._allreduce_t(x * mask[self.rank], ReduceOp.SUM,
                                timeout_s)
        cnt = mask.sum()
        out = (tot * (self.world / torch.clamp(cnt, min=1.0))).to(dev)
        return self._partial_result(out, mask.tolist(), "allreduce",
                                    min_ranks, grace)

    def _partial_reducescatter_dist(
        self, tensor, op, min_ranks, grace_s, timeout_s
    ):
        """Masked reduce-scatter — the ZeRO reduce hop under
        allow_partial_grads on the multi-process backend: the same
        pre-op gate as :meth:`_partial_allreduce` prices each rank's
        contribution (w∈{0,1}), the scattered SUM rescales by world/Σw,
        and the gather hop stays all-N (a skipped OWNER would zero weight
        shards)."""
        grace = (
            float(grace_s) if grace_s is not None
            else _default_partial_grace()
        )
        x, dev = self._local(tensor)
        if x.shape[0] % self.world:
            raise ValueError(
                f"reducescatter dim0 {x.shape[0]} not divisible by "
                f"world {self.world}"
            )
        _check_partial_args(op, x.dtype, min_ranks, self.world)
        w_self = self._gate_weight(grace)
        mask = self._mask(w_self, x.dtype, x.device, "reducescatter",
                          timeout_s)
        shard = self._reduce_scatter_t(x * mask[self.rank], timeout_s)
        out = (shard * (self.world / torch.clamp(mask.sum(), min=1.0))
               ).to(dev)
        return self._partial_result(out, mask.tolist(), "reducescatter",
                                    min_ranks, grace)

    def _reduce_scatter_t(self, x, timeout_s):
        out = torch.empty((x.shape[0] // self.world, *x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        self._run("reducescatter", timeout_s,
                  lambda: self._pg._reduce_scatter_base(
                      out, x, _opts(dist.ReduceScatterOptions,
                                    reduceOp=dist.ReduceOp.SUM)))
        return out

    def _compressed_allreduce_dist(
        self, tensor, op, min_ranks, grace_s, timeout_s
    ):
        """Compressed allreduce composed with the masked partial path:
        every rank contributes ``(quantized grad, w)`` where w comes from
        the pre-op gate when partial mode is on (1.0 otherwise); quantize
        → all_to_all int8 → fp32 dequant-accumulate → world/Σw rescale →
        requantize → all_gather int8. Returns fp32, as the JAX package's
        does."""
        x, dev = self._local(tensor)
        if op is not ReduceOp.SUM:
            raise ValueError(
                f"compressed allreduce supports ReduceOp.SUM only, got {op}"
            )
        _check_float(x.dtype, "compressed allreduce")
        partial = min_ranks is not None
        grace = None
        if partial:
            grace = (
                float(grace_s) if grace_s is not None
                else _default_partial_grace()
            )
            _check_partial_args(op, x.dtype, min_ranks, self.world)
            w_self = self._gate_weight(grace)
        else:
            w_self = 1.0
        block = _compression_block()
        world = self.world
        length = x.numel()
        chunk_len = codec.padded_len(-(-max(1, length) // world), block)
        nblk = chunk_len // block
        mask = self._mask(w_self, x.dtype, x.device, "allreduce", timeout_s)
        flat = _flat_pad(x.float() * mask[self.rank], world * chunk_len)
        q, sc = codec.quantize_blocked_torch(flat.reshape(world, nblk, block))
        q_t = self._all_to_all_t(q, timeout_s, "allreduce")
        s_t = self._all_to_all_t(sc, timeout_s, "allreduce")
        red = q_t[0].float() * s_t[0][..., None]
        for src in range(1, world):  # fp32 accumulate, rank order
            red.add_(q_t[src].float() * s_t[src][..., None])
        red = red * (world / torch.clamp(mask.sum(), min=1.0)).float()
        q2, s2 = codec.quantize_blocked_torch(red)
        qg = self._allgather_t(q2, timeout_s)
        sg = self._allgather_t(s2, timeout_s)
        out = (qg.float() * sg[..., None]).reshape(-1)[:length].reshape(
            x.shape).to(dev)
        self._last_wire_bytes = _compressed_wire_bytes(
            world, length, block
        )
        if not partial:
            return out
        return self._partial_result(out, mask.tolist(), "allreduce",
                                    min_ranks, grace)

    @_recorded("allgather")
    def allgather(self, tensor, timeout_s=None,
                  compression: str | None = None,
                  algo: str | None = None):
        self._check_poisoned("allgather")
        # One data plane (the process group's gather); algo= accepted for
        # selector parity, the wire estimate below stays honest.
        del algo
        x, dev = self._local(tensor)
        world = self.world
        if codec.check_codec(compression) is not None:
            _check_float(x.dtype, "compressed allgather")
            block = _compression_block()
            shape = x.shape
            length = x.numel()
            padded = codec.padded_len(length, block)
            q, sc = codec.quantize_blocked_torch(
                _flat_pad(x.float(), padded).reshape(-1, block)
            )
            qg = self._allgather_t(q, timeout_s)
            sg = self._allgather_t(sc, timeout_s)
            deq = (qg.float() * sg[..., None]).reshape(world, -1)[:, :length]
            q_payload = padded + (padded // block) * 4
            self._last_wire_bytes = int(
                (world - 1) / world * world * q_payload
            )
            return deq.reshape(world, *shape).reshape(
                world * shape[0] if len(shape) else world, *shape[1:]
            ).to(x.dtype).to(dev)
        out = self._allgather_t(x if x.dim() else x.reshape(1), timeout_s)
        nbytes = x.nbytes if x.dim() else x.element_size()
        self._last_wire_bytes = colalgo.wire_bytes_per_rank(
            colalgo.RING, nbytes, self.world, verb="allgather"
        )
        return out.to(dev)

    @_recorded("broadcast")
    def broadcast(self, tensor, root: int = 0, timeout_s=None):
        self._check_poisoned("broadcast")
        x, dev = self._local(tensor)
        out = x.clone() if x.device == dev else x
        self._run("broadcast", timeout_s, lambda: self._pg.broadcast(
            [out], _opts(dist.BroadcastOptions, rootRank=root,
                         rootTensor=0)))
        return out.to(dev)

    @_recorded("reducescatter")
    def reducescatter(self, tensor, op=ReduceOp.SUM, timeout_s=None,
                      compression: str | None = None,
                      algo: str | None = None,
                      min_ranks: int | None = None,
                      grace_s: float | None = None):
        self._check_poisoned("reducescatter")
        if min_ranks is not None:
            if codec.check_codec(compression) is not None:
                raise ValueError(
                    "compressed reducescatter does not compose with "
                    "partial mode yet: drop min_ranks or compression"
                )
            return self._partial_reducescatter_dist(
                tensor, op, min_ranks, grace_s, timeout_s
            )
        x, dev = self._local(tensor)
        world = self.world
        if x.shape[0] % world:
            raise ValueError(
                f"reducescatter dim0 {x.shape[0]} not divisible by "
                f"world {world}"
            )
        if codec.check_codec(compression) is not None:
            if op is not ReduceOp.SUM:
                raise ValueError(
                    "compressed reducescatter supports ReduceOp.SUM only"
                )
            _check_float(x.dtype, "compressed reducescatter")
            block = _compression_block()
            chunk_shape = (x.shape[0] // world, *x.shape[1:])
            clen = _numel(chunk_shape)
            padded = codec.padded_len(clen, block)
            v = torch.nn.functional.pad(
                x.float().reshape(world, clen), (0, padded - clen)
            )
            q, sc = codec.quantize_blocked_torch(v.reshape(world, -1, block))
            q_t = self._all_to_all_t(q, timeout_s, "reducescatter")
            s_t = self._all_to_all_t(sc, timeout_s, "reducescatter")
            red = q_t[0].float() * s_t[0][..., None]
            for src in range(1, world):
                red.add_(q_t[src].float() * s_t[src][..., None])
            q_payload = world * (padded + (padded // block) * 4)
            self._last_wire_bytes = int((world - 1) / world * q_payload)
            return red.reshape(-1)[:clen].reshape(chunk_shape).to(
                x.dtype).to(dev)
        nbytes = x.nbytes
        if op is ReduceOp.SUM:
            chosen = colalgo.RING
            if algo is not None:
                chosen = colalgo.choose_algorithm(
                    nbytes, world, override=algo, verb="reducescatter",
                )
            if chosen == colalgo.TREE:
                # Small payload: one-shot allreduce then keep our slice —
                # the latency-optimal branch of the selector.
                full = self.allreduce(tensor, op=op, timeout_s=timeout_s)
                self._last_wire_bytes = colalgo.wire_bytes_per_rank(
                    colalgo.TREE, nbytes, world, verb="reducescatter",
                )
                chunk = full.shape[0] // world
                return full[self.rank * chunk:(self.rank + 1) * chunk]
            self._last_wire_bytes = colalgo.wire_bytes_per_rank(
                colalgo.RING, nbytes, world, verb="reducescatter"
            )
            return self._reduce_scatter_t(x, timeout_s).to(dev)
        full = self.allreduce(tensor, op=op, timeout_s=timeout_s)
        chunk = full.shape[0] // world
        return full[self.rank * chunk : (self.rank + 1) * chunk]

    # ------------------------------------------------------- send / recv
    # The device-object transport's point-to-point path
    # (runtime/core_worker.py: tensor_send / _fetch_tensor_payload): the
    # producer posts a send tagged ``seq`` without waiting for it (the
    # consumer posts the matching recv after the producer acks), and a
    # header in the group's store tells the receiver the shape and dtype
    # to allocate. Coroutines, as the core worker awaits them.
    def _p2p_key(self, src: int, dst: int, seq: int) -> str:
        return f"p2p:{self.name}:{src}:{dst}:{seq}"

    async def send(self, tensor, dst_rank: int, seq: int = 0,
                   timeout_s=None):
        self._check_poisoned("send")
        wall_start = time.time()
        t0 = time.perf_counter()
        x, dev = self._local(tensor)
        header = {"shape": list(x.shape), "dtype": str(x.dtype),
                  "cuda": dev.type == "cuda", "route": self.last_route}
        self.store.set(self._p2p_key(self.rank, dst_rank, seq),
                       json.dumps(header))
        work = self._pg.send([x], int(dst_rank), int(seq) & 0x7FFFFFFF)
        # Keep the work and its buffer alive until it completes.
        self._sends = [(w, t) for w, t in self._sends if not w.is_completed()]
        self._sends.append((work, x))
        record_op(self.name, "send", self.backend_tag, self.world, x,
                  wall_start, time.perf_counter() - t0)

    async def recv(self, src_rank: int, seq: int = 0, timeout_s=None):
        self._check_poisoned("recv")
        t = self.timeout_s if timeout_s is None else float(timeout_s)
        wall_start = time.time()
        t0 = time.perf_counter()
        key = self._p2p_key(src_rank, self.rank, seq)
        loop = asyncio.get_running_loop()
        # The device a CUDA tensor arrives on: NCCL's (the group's device)
        # or, on gloo, the calling thread's current one, read here (the
        # executor thread below has its own) where this process already
        # uses CUDA; else the process's first card.
        here = self._cuda
        if here is None and torch.cuda.is_initialized():
            here = torch.device("cuda", torch.cuda.current_device())

        def fetch():
            self.store.wait([key], datetime.timedelta(seconds=max(t, 1.0)))
            header = json.loads(self.store.get(key))
            dtype = getattr(torch, header["dtype"].split(".")[-1])
            if header["cuda"] and not torch.cuda.is_available():
                raise RuntimeError(
                    f"recv: rank {src_rank} sent a CUDA tensor and this "
                    "process has no CUDA device"
                )
            dev = (torch.device("cpu") if not header["cuda"]
                   else here or torch.device("cuda", 0))
            buf = torch.empty(header["shape"], dtype=dtype,
                              device="cpu" if self.dist_backend == "gloo"
                              else dev)
            self._sync(self._pg.recv([buf], int(src_rank),
                                     int(seq) & 0x7FFFFFFF), "recv", t)
            self.store.delete_key(key)
            self.last_route = ("gloo:host" if self.dist_backend == "gloo"
                               and dev.type == "cuda"
                               else self.dist_backend)
            return buf.to(dev)

        try:
            out = await loop.run_in_executor(None, fetch)
        except dist.DistStoreError:
            raise CollectiveTimeoutError(
                self.name, "recv", t, missing_ranks=[src_rank]
            ) from None
        record_op(self.name, "recv", self.backend_tag, self.world, out,
                  wall_start, time.perf_counter() - t0)
        return out

    # ------------------------------------------------------ async verbs
    def _verb_async(self, verb: str, args, kw) -> CollectiveWork:
        """Dispatch a verb on the group's background dispatch thread
        and return a :class:`FutureCollectiveWork`. The dist verbs block
        internally (the deadline-bounded wait, partial-gate store reads),
        so true async needs a thread; one thread per group keeps
        handle-based ops issued in program order across ranks. The op
        records its own dispatch→completion interval from inside the
        thread."""
        from concurrent.futures import ThreadPoolExecutor

        from ray_tpu_torch.util import tracing

        if self._dispatch_pool is None:
            self._dispatch_pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="nccl_col_dispatch"
            )
        wall_start = time.time()
        t0 = time.perf_counter()
        ctx = tracing.active_context()
        payload = args[0] if args else None

        def run():
            prev = self._in_recorded_op
            self._in_recorded_op = True  # record here, not in the verb
            self._last_wire_bytes = None
            with tracing.thread_trace(ctx):
                try:
                    out = getattr(self, verb)(*args, **kw)
                finally:
                    self._in_recorded_op = prev
                record_op(
                    self.name, verb, self.backend_tag, self.world,
                    payload, wall_start, time.perf_counter() - t0,
                    wire_bytes=self._last_wire_bytes,
                )
            return out

        return FutureCollectiveWork(
            self._dispatch_pool.submit(run),
            group_name=self.name,
            verb=verb,
        )

    def allreduce_async(self, tensor, **kw) -> CollectiveWork:
        """Async :meth:`allreduce` (handle-based): composes with
        min_ranks/grace_s, compression and algo exactly like the sync
        verb — the partial gate prices the contribution at dispatch
        time on the dispatch thread."""
        return self._verb_async("allreduce", (tensor,), kw)

    def reducescatter_async(self, tensor, **kw) -> CollectiveWork:
        return self._verb_async("reducescatter", (tensor,), kw)

    def allgather_async(self, tensor, **kw) -> CollectiveWork:
        return self._verb_async("allgather", (tensor,), kw)

    @_recorded("barrier")
    def barrier(self, timeout_s=None):
        dev = "cuda" if self.dist_backend == "nccl" else "cpu"
        self.allreduce(torch.zeros(1, dtype=torch.int32, device=dev),
                       timeout_s=timeout_s)


async def bootstrap_distributed(
    core,
    group_name: str,
    world_size: int,
    rank: int,
    timeout_s: float | None = None,
):
    """Multi-process bootstrap with head-KV rendezvous; returns the
    group's TCPStore.

    Rank 0 starts a TCPStore server on a free port of its RPC host and
    publishes ``host:port`` in the cluster KV; every other rank polls the
    KV, then connects. This replaces the reference's NCCLUniqueID
    rendezvous actor (nccl_collective_group.py:29-56). The coordinator
    poll is deadline-bounded: a rank-0 process that never comes up raises
    CollectiveTimeoutError instead of polling the KV forever."""
    import time as _time

    t = _default_timeout() if timeout_s is None else float(timeout_s)
    key = f"torchdist:{group_name}:coordinator"
    timeout = datetime.timedelta(seconds=max(t, 1.0))
    host = core.addr.rsplit(":", 1)[0]
    loop = asyncio.get_running_loop()
    if rank == 0:
        store = await loop.run_in_executor(
            None,
            lambda: dist.TCPStore(host, 0, world_size, True, timeout,
                                  wait_for_workers=False),
        )
        coord = f"{host}:{store.port}"
        await core.head.call("kv_put", key=key, value=coord.encode())
        return store
    deadline = _time.monotonic() + t
    while True:
        reply = await core.head.call("kv_get", key=key)
        if reply["ok"]:
            coord = reply["value"].decode()
            break
        if _time.monotonic() > deadline:
            raise CollectiveTimeoutError(
                group_name, "rendezvous", t, missing_ranks=[0],
                detail="the group's TCPStore was never published",
            )
        await asyncio.sleep(0.05)
    chost, cport = coord.rsplit(":", 1)
    return await loop.run_in_executor(
        None,
        lambda: dist.TCPStore(chost, int(cport), world_size, False, timeout),
    )
