"""Collective communication API (reference surface:
python/ray/util/collective/collective.py — init_collective_group :171,
allreduce :328, barrier :368, reduce :381, broadcast :443, allgather :493,
reducescatter :542, send :601, recv :664).

The default data plane is XLA collectives (ICI within a slice, DCN across
slices) instead of NCCL/Gloo; host-memory tensors use the CPU backend over
the runtime RPC. Groups are process-wide, keyed by name, and rendezvous
through the cluster head's KV store.

Fault tolerance: every op takes a deadline (group default via
``init_collective_group(timeout_s=)``, per-op override on each verb);
expiry raises CollectiveTimeoutError naming the missing ranks. Members
register with the head, which fans out node/worker death on the
"collective" pubsub channel — survivors' in-flight and future ops fail
fast with CollectiveMemberDiedError, and ``reform_group()`` re-runs
rendezvous with the survivors (new world size, re-ranked).

Straggler tolerance: ``allreduce(..., min_ranks=K, grace_s=...)`` is the
partial K-of-N mode (Efficient AllReduce with Stragglers,
arXiv:2505.23523) — the op proceeds with the contributions that beat a
grace sub-deadline (adaptive, p99-derived from the straggler-lag
histogram by default), rescales the mean, and returns PartialResult
naming the skipped ranks; chronic skips escalate to the head's
drain-and-replace path. Partial mode covers allreduce, reducescatter,
and allgather on the cpu backend.

Communication efficiency: ``compression="int8"`` on
allreduce/reducescatter/allgather ships block-scaled int8 + per-block
absmax scales on the wire with fp32 accumulation (EQuARX,
arXiv:2506.17615; collective/codec.py); ``algo=`` picks the data-plane
algorithm — hub/ring/tree on the cpu backend, tree/ring lowering on the
XLA backends, "auto" by message size via the crossover table, and a
hierarchical two-level ICI/DCN allreduce for multi-slice meshes (The
Big Send-off, arXiv:2504.18658; collective/algo.py). The flight
recorder tracks logical vs wire bytes separately
(ray_tpu_collective_wire_bytes_total, compression-ratio gauge).
"""

from __future__ import annotations

from typing import Any, Sequence

from ray_tpu_torch.collective.types import (
    Backend,
    CollectiveError,
    CollectiveGroupDestroyedError,
    CollectiveMemberDiedError,
    CollectiveTimeoutError,
    CollectiveWork,
    FutureCollectiveWork,
    PartialResult,
    ReduceOp,
)

_groups: dict[str, Any] = {}


def _runtime():
    import ray_tpu_torch.api as api

    if not api._runtime.ready:
        raise RuntimeError("ray_tpu_torch.init() must be called before collectives")
    return api._runtime


def _resolve_backend(backend) -> Backend:
    backend = Backend(backend)
    if backend is Backend.AUTO:
        import torch

        return (Backend.XLA_MESH if torch.cuda.device_count() > 1
                else Backend.CPU)
    return backend


async def _ensure_death_watch(core) -> None:
    """Subscribe this process (once per CoreWorker) to the head's
    "collective" channel and route member-death fan-out to the local
    group objects: a head-declared dead node/worker poisons every group
    it belonged to, immediately."""
    if getattr(core, "_collective_death_watch", False):
        return
    core._collective_death_watch = True

    def _on_event(msg):
        if not isinstance(msg, dict):
            return
        event = msg.get("event")
        if event == "member_dead":
            g = _groups.get(msg.get("group"))
            if g is not None and hasattr(g, "_on_member_dead"):
                g._on_member_dead(
                    msg.get("ranks") or [], epoch=msg.get("epoch")
                )
        elif event == "node_draining":
            # Drain notices ride the same fan-out channel: record them
            # process-locally so the train session (emergency
            # checkpoint) and anyone polling preemption_notice() learns
            # BEFORE the node dies. A drain does NOT poison groups —
            # the node is alive until its deadline.
            from ray_tpu_torch.runtime import drain

            drain.record(msg)
        elif event == "node_undrain":
            from ray_tpu_torch.runtime import drain

            drain.clear(msg.get("node_id"))
        elif event == "profile_capture":
            # Head-triggered compiled-program capture: arm this
            # process's per-step profiler hook (train/profile.py). The
            # same fan-out channel reaches every rank with a live
            # CoreWorker, so one head RPC captures the whole job.
            from ray_tpu_torch.train import profile

            profile.note_capture_request(msg)

    await core.subscribe("collective", _on_event)


def init_collective_group(
    world_size: int,
    rank: int,
    backend: str | Backend = Backend.AUTO,
    group_name: str = "default",
    timeout_s: float | None = None,
    auto_reform: bool = False,
) -> None:
    """Join this process into a named collective group.

    ``timeout_s`` is the group's default deadline for rendezvous and
    every op (config COLLECTIVE_TIMEOUT_S when None); individual verbs
    can override per call.

    ``auto_reform``: on an op failure where no member is actually dead
    (a transient timeout, a peer that already reformed), re-run
    rendezvous in place via :func:`reform_in_place` and retry the op
    once — the caller keeps its in-memory state and never sees the
    error. Confirmed member death still raises, so real failures
    escalate to the elastic restart path."""
    if group_name in _groups:
        raise ValueError(f"collective group {group_name!r} already exists")
    backend = _resolve_backend(backend)
    rt = _runtime()
    if backend is Backend.CPU:
        from ray_tpu_torch.collective.backends.cpu_group import CpuGroup

        async def make():
            g = CpuGroup(
                rt.core, group_name, world_size, rank, timeout_s=timeout_s
            )
            await g.init()
            return g

        _groups[group_name] = rt.run(make())
    elif backend is Backend.XLA_MESH:
        from ray_tpu_torch.collective.backends.xla_group import XlaMeshGroup

        g = XlaMeshGroup(name=group_name)
        if g.world != world_size:
            raise ValueError(
                f"xla_mesh backend: {g.world} local devices != "
                f"world_size {world_size}"
            )
        _groups[group_name] = g
    elif backend is Backend.XLA_DIST:
        from ray_tpu_torch.collective.backends.xla_group import (
            XlaDistGroup,
            bootstrap_distributed,
        )

        rt.run(
            bootstrap_distributed(
                rt.core, group_name, world_size, rank, timeout_s=timeout_s
            )
        )
        _groups[group_name] = XlaDistGroup(
            world_size, rank, timeout_s=timeout_s, name=group_name,
            core=rt.core,
        )

        async def _register_dist():
            # Head membership + death watch: the fan-out is what lets
            # XlaDistGroup's deadline-bounded sync abort EARLY (poison
            # polling between bounded waits) instead of at the deadline.
            try:
                await rt.core.head.call(
                    "collective_register",
                    group=group_name,
                    rank=rank,
                    epoch=0,
                    addr=rt.core.addr,
                    node_addr=getattr(rt.core, "node_addr", None),
                    worker_id=getattr(rt.core, "worker_id", None),
                )
            # tpulint: allow(broad-except reason=membership registration on an older head is best-effort; deadlines still work, only death fan-out is lost)
            except Exception:
                pass
            await _ensure_death_watch(rt.core)

        rt.run(_register_dist())
    else:
        raise ValueError(f"unsupported backend {backend}")
    _groups[group_name].auto_reform = auto_reform


def is_group_initialized(group_name: str = "default") -> bool:
    return group_name in _groups


def destroy_collective_group(group_name: str = "default") -> None:
    """Destroy the local group object. In-flight op futures on it are
    cancelled/failed (CollectiveGroupDestroyedError) rather than left
    pending."""
    g = _groups.pop(group_name, None)
    if g is not None and hasattr(g, "destroy"):
        _runtime().run(g.destroy())


def reform_group(
    group_name: str = "default", timeout_s: float | None = None
) -> tuple[int, int]:
    """Abort-and-reform: re-run rendezvous with the surviving ranks of a
    poisoned (or op-desynced) group. Every survivor must call this; the
    group keeps its public name but gets a new epoch, dense re-ranking,
    and a fresh op sequence. Returns ``(new_rank, new_world)``."""
    g = get_group(group_name)
    if not hasattr(g, "reform"):
        raise ValueError(
            f"backend {type(g).__name__} does not support reform_group"
        )
    new_g = _runtime().run(g.reform(timeout_s=timeout_s))
    _groups[group_name] = new_g
    return new_g.rank, new_g.world


def reform_in_place(
    group_name: str = "default", timeout_s: float | None = None
) -> tuple[int, int] | None:
    """Repair a desynced/poisoned group WITHOUT an attempt restart —
    but only when every member is still alive.

    Probes the head (collective_probe cross-references the node and
    worker tables) to confirm whether any silent rank is actually dead.
    If none is — a transient op timeout, or a drain of a node that
    hosts no member — re-runs rendezvous via :func:`reform_group` at
    the SAME shape and returns ``(rank, world)``: callers continue from
    in-memory state, no checkpoint restore, no new attempt. If a member
    is confirmed dead, returns ``None`` — the caller escalates to the
    restart/elastic path."""
    g = get_group(group_name)
    if not hasattr(g, "reform"):
        return None
    rt = _runtime()
    confirmed: set[int] = set()
    try:
        reply = rt.run(
            rt.core.head.call(
                "collective_probe",
                group=getattr(g, "base_name", group_name),
            )
        )
        if reply.get("ok"):
            confirmed = {int(r) for r in reply.get("dead_ranks") or []}
    # tpulint: allow(broad-except reason=the probe is advisory; the local dead set below still gates the reform)
    except Exception:
        pass
    if confirmed and hasattr(g, "_dead"):
        g._dead |= confirmed
    if confirmed or getattr(g, "_dead", None):
        return None
    return reform_group(group_name, timeout_s=timeout_s)


def _reformable(e: Exception) -> bool:
    """Errors worth an in-place reform attempt: transient timeouts, a
    peer that already reformed under us, or a death claim the probe can
    refute (reform_in_place re-checks). A deliberate destroy is not."""
    if isinstance(e, CollectiveTimeoutError):
        return True
    if isinstance(e, CollectiveMemberDiedError):
        return True
    if isinstance(e, CollectiveGroupDestroyedError):
        return "reform" in str(e)
    return False


def straggler_stats(group_name: str = "default") -> dict:
    """Per-rank slowest-contributor telemetry (hub rank only; other
    ranks see zeros). Chronic stragglers show up here — and in the
    collective_straggler_* metrics — before they become timeouts.

    ``slice_skip_counts`` merges the hierarchical allreduce's per-slice
    DCN skip counts (slice index → skips) when ``group_name`` names a
    hierarchical op's group — that op is driver-side and needs no
    init_collective_group, so the group object may not exist."""
    from ray_tpu_torch.collective import algo as _algo

    slice_skips = _algo.slice_skip_stats(group_name)
    g = _groups.get(group_name)
    if g is None:
        if slice_skips:
            return {"slice_skip_counts": slice_skips}
        raise ValueError(
            f"collective group {group_name!r} not initialized"
        )
    fn = getattr(g, "straggler_stats", None)
    out = dict(fn()) if fn is not None else {}
    if slice_skips:
        out["slice_skip_counts"] = slice_skips
    return out


def get_group(group_name: str = "default"):
    g = _groups.get(group_name)
    if g is None:
        raise ValueError(f"collective group {group_name!r} not initialized")
    return g


def get_rank(group_name: str = "default") -> int:
    return getattr(get_group(group_name), "rank", 0)


def get_collective_group_size(group_name: str = "default") -> int:
    return get_group(group_name).world


def _dispatch(name: str, group_name: str, *args, **kw):
    g = get_group(group_name)
    if (
        getattr(g, "expects_per_rank_tensors", False)
        and args
        and args[0] is not None
        and not isinstance(args[0], (list, tuple))
    ):
        raise TypeError(
            f"group {group_name!r} uses the single-controller xla_mesh "
            f"backend: pass a list of {g.world} per-rank tensors, one per "
            "device (each rank is a local device, not a process)"
        )
    # With auto_reform, one failed dispatch may retry once after an
    # in-place reform (no member actually dead → same shape, fresh
    # epoch). The retry re-fetches the group: reform replaced it.
    for attempt in range(2):
        g = get_group(group_name)
        out, err = _dispatch_once(g, name, *args, **kw)
        if err is None:
            return out
        if (
            attempt > 0
            or not getattr(g, "auto_reform", False)
            or not _reformable(err)
        ):
            raise err
        if reform_in_place(group_name) is None:
            raise err  # a member really died: escalate


def _dispatch_once(g, name: str, *args, **kw):
    fn = getattr(g, name)
    import inspect

    try:
        if inspect.iscoroutinefunction(fn):
            from ray_tpu_torch.util import tracing

            coro = fn(*args, **kw)
            # Carry the caller's trace context onto the runtime loop so
            # the flight recorder's op span parents under the issuing
            # task (contextvars do not cross run_coroutine_threadsafe).
            ctx = tracing._active()
            if ctx is not None:
                coro = tracing.carry_context(coro, ctx)
            return _runtime().run(coro), None
        return fn(*args, **kw), None
    except CollectiveError as e:
        return None, e


def _note_partial(out):
    """An active train session charges the skipped fraction of this
    step to the goodput ledger's "degraded" category. sys.modules
    lookup, not an import: no train session can be active unless
    the session module is already loaded, and pure collective
    users must not pay the train-package import."""
    if isinstance(out, PartialResult) and out.skipped:
        import sys

        _session = sys.modules.get("ray_tpu_torch.train.session")
        if _session is not None:
            _session.note_partial_op(out)
    return out


def allreduce(
    tensor,
    group_name: str = "default",
    op=ReduceOp.SUM,
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
):
    """``min_ranks=K`` turns on straggler-tolerant partial mode: the op
    proceeds once K of N contributions have arrived by ``grace_s`` past
    the fastest arrival (adaptive p99-derived window when None, falling
    back to config COLLECTIVE_PARTIAL_GRACE_S), SUM rescaled by
    world/contributors, returning a :class:`PartialResult` that names
    the skipped ranks. Skips feed ``straggler_stats()`` and —
    chronically — the head's drain-and-replace escalation.

    ``compression="int8"`` ships block-scaled int8 on the wire (~3.9x
    fewer bytes; fp32 accumulation — see collective/codec.py);
    ``algo=`` selects the data-plane algorithm ("ring"/"tree"/"auto",
    backend-dependent — see collective/algo.py). With the defaults
    (None everywhere) the classic all-N path runs, byte-identical to
    before."""
    kw: dict = {}
    if min_ranks is not None:
        kw["min_ranks"] = min_ranks
        kw["grace_s"] = grace_s
    if compression is not None:
        kw["compression"] = compression
    if algo is not None:
        kw["algo"] = algo
    return _note_partial(
        _dispatch(
            "allreduce", group_name, tensor, op=ReduceOp(op),
            timeout_s=timeout_s, **kw,
        )
    )


def reduce(
    tensor,
    dst_rank: int = 0,
    group_name: str = "default",
    op=ReduceOp.SUM,
    timeout_s=None,
):
    return _dispatch(
        "reduce", group_name, tensor, root=dst_rank, op=ReduceOp(op),
        timeout_s=timeout_s,
    )


def broadcast(
    tensor, src_rank: int = 0, group_name: str = "default", timeout_s=None
):
    return _dispatch(
        "broadcast", group_name, tensor, root=src_rank, timeout_s=timeout_s
    )


def allgather(
    tensor,
    group_name: str = "default",
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
):
    """Partial mode (cpu backend): skipped ranks' entries come back
    zero-filled with the skip list in the PartialResult envelope.
    ``compression="int8"`` gathers block-scaled int8 payloads;
    ``algo=`` selects the data plane ("ring"/"auto" — the crossover
    routing the ZeRO weight-allgather hop uses)."""
    kw: dict = {}
    if min_ranks is not None:
        kw["min_ranks"] = min_ranks
        kw["grace_s"] = grace_s
    if compression is not None:
        kw["compression"] = compression
    if algo is not None:
        kw["algo"] = algo
    return _note_partial(
        _dispatch("allgather", group_name, tensor, timeout_s=timeout_s, **kw)
    )


def reducescatter(
    tensor,
    group_name: str = "default",
    op=ReduceOp.SUM,
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
):
    """Partial mode (cpu backend): SUM rescaled by world/contributors
    like allreduce; each rank still receives its own chunk.
    ``compression="int8"`` ships and returns block-scaled int8;
    ``algo=`` selects the data plane ("ring"/"auto" — the crossover
    routing the ZeRO grad reduce-scatter hop uses)."""
    kw: dict = {}
    if min_ranks is not None:
        kw["min_ranks"] = min_ranks
        kw["grace_s"] = grace_s
    if compression is not None:
        kw["compression"] = compression
    if algo is not None:
        kw["algo"] = algo
    return _note_partial(
        _dispatch(
            "reducescatter", group_name, tensor, op=ReduceOp(op),
            timeout_s=timeout_s, **kw,
        )
    )


def _dispatch_async(
    name: str, group_name: str, tensor, **kw
) -> CollectiveWork:
    """Dispatch a verb asynchronously, returning a typed
    :class:`CollectiveWork` handle.

    cpu backend: the op coroutine is scheduled on the runtime loop
    (run_coroutine_threadsafe) — the existing hub/mailbox protocol runs
    unchanged on that background thread while the caller's thread keeps
    computing; the op's flight-recorder interval is its real
    dispatch→completion window on the loop. XLA backends: the group's
    own ``<verb>_async`` (mesh — XLA async dispatch; dist — the
    group's dispatch thread). Async handles do not auto-reform: a
    failure surfaces typed from ``wait()``."""
    g = get_group(group_name)
    if (
        getattr(g, "expects_per_rank_tensors", False)
        and tensor is not None
        and not isinstance(tensor, (list, tuple))
    ):
        raise TypeError(
            f"group {group_name!r} uses the single-controller xla_mesh "
            f"backend: pass a list of {g.world} per-rank tensors, one per "
            "device (each rank is a local device, not a process)"
        )
    fn = getattr(g, name, None)
    import inspect

    if fn is not None and inspect.iscoroutinefunction(fn):
        import asyncio

        from ray_tpu_torch.util import tracing

        rt = _runtime()
        coro = fn(tensor, **kw)
        ctx = tracing._active()
        if ctx is not None:
            coro = tracing.carry_context(coro, ctx)
        return FutureCollectiveWork(
            asyncio.run_coroutine_threadsafe(coro, rt.loop),
            group_name=group_name,
            verb=name,
            finalize=_note_partial,
        )
    async_fn = getattr(g, f"{name}_async", None)
    if async_fn is None:
        raise ValueError(
            f"backend {type(g).__name__} does not support async {name}"
        )
    work = async_fn(tensor, **kw)
    work._finalize_cb = _note_partial
    return work


def _async_kwargs(
    op, timeout_s, min_ranks, grace_s, compression, algo, with_op=True
) -> dict:
    kw: dict = {"timeout_s": timeout_s}
    if with_op:
        kw["op"] = ReduceOp(op)
    if min_ranks is not None:
        kw["min_ranks"] = min_ranks
        kw["grace_s"] = grace_s
    if compression is not None:
        kw["compression"] = compression
    if algo is not None:
        kw["algo"] = algo
    return kw


def allreduce_async(
    tensor,
    group_name: str = "default",
    op=ReduceOp.SUM,
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
) -> CollectiveWork:
    """Asynchronous :func:`allreduce`: the op is in flight when this
    returns; ``.wait()`` joins it (same result, same typed errors, same
    PartialResult envelope in partial mode) and ``.done()`` probes
    completion. The overlap primitive the gradient bucketer builds on —
    issue bucket syncs during remaining backward compute, join before
    the optimizer update. Composes with ``min_ranks=``/``grace_s=``,
    ``compression=`` and ``algo=`` exactly like the sync verb."""
    return _dispatch_async(
        "allreduce", group_name, tensor,
        **_async_kwargs(op, timeout_s, min_ranks, grace_s, compression,
                        algo),
    )


def reducescatter_async(
    tensor,
    group_name: str = "default",
    op=ReduceOp.SUM,
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
) -> CollectiveWork:
    """Asynchronous :func:`reducescatter` — see :func:`allreduce_async`."""
    return _dispatch_async(
        "reducescatter", group_name, tensor,
        **_async_kwargs(op, timeout_s, min_ranks, grace_s, compression,
                        algo),
    )


def allgather_async(
    tensor,
    group_name: str = "default",
    timeout_s=None,
    min_ranks: int | None = None,
    grace_s: float | None = None,
    compression: str | None = None,
    algo: str | None = None,
) -> CollectiveWork:
    """Asynchronous :func:`allgather` — see :func:`allreduce_async`."""
    return _dispatch_async(
        "allgather", group_name, tensor,
        **_async_kwargs(None, timeout_s, min_ranks, grace_s, compression,
                        algo, with_op=False),
    )


def barrier(group_name: str = "default", timeout_s=None):
    return _dispatch("barrier", group_name, timeout_s=timeout_s)


def send(
    tensor, dst_rank: int, group_name: str = "default", seq: int = 0,
    timeout_s=None,
):
    return _dispatch(
        "send", group_name, tensor, dst_rank, seq=seq, timeout_s=timeout_s
    )


def recv(
    src_rank: int, group_name: str = "default", seq: int = 0, timeout_s=None
):
    return _dispatch(
        "recv", group_name, src_rank, seq=seq, timeout_s=timeout_s
    )


__all__ = [
    "Backend",
    "ReduceOp",
    "PartialResult",
    "CollectiveError",
    "CollectiveTimeoutError",
    "CollectiveMemberDiedError",
    "CollectiveGroupDestroyedError",
    "init_collective_group",
    "destroy_collective_group",
    "reform_group",
    "reform_in_place",
    "straggler_stats",
    "is_group_initialized",
    "get_rank",
    "get_collective_group_size",
    "allreduce",
    "reduce",
    "broadcast",
    "allgather",
    "reducescatter",
    "barrier",
    "send",
    "recv",
    "CollectiveWork",
    "allreduce_async",
    "reducescatter_async",
    "allgather_async",
]

from ray_tpu_torch._private.usage import record_library_usage as _rlu

_rlu('collective')
del _rlu
