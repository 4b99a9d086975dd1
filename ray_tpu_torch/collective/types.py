"""Collective types and fault-tolerance exceptions (reference:
python/ray/util/collective/types.py; abort semantics follow the
reference's NCCL-abort / destroy_collective_group contract; partial
K-of-N semantics follow "Efficient AllReduce with Stragglers",
arXiv:2505.23523)."""

from __future__ import annotations

import dataclasses
import enum

from ray_tpu_torch.exceptions import RayTpuError


class Backend(str, enum.Enum):
    """Which data plane carries the collective.

    NCCL_MESH — the devices visible to this process, single controller
                (rank = device): NCCL's single-process collectives
                (``torch.cuda.nccl``) across distinct GPUs, device-local
                torch where ranks share one device or lie on the CPU.
    NCCL      — rank = process: a ``torch.distributed`` process group of
                the group's own ("nccl" for CUDA tensors by default;
                "gloo" when the caller asks for it).
    CPU       — host-memory tensors over the runtime RPC (the reference's
                gloo role, torch_gloo_collective_group.py).
    AUTO      — NCCL_MESH if more than one CUDA device is visible, else CPU.
    """

    NCCL_MESH = "nccl_mesh"
    NCCL = "nccl"
    CPU = "cpu"
    AUTO = "auto"


class ReduceOp(str, enum.Enum):
    SUM = "sum"
    PRODUCT = "product"
    MIN = "min"
    MAX = "max"


UNSET_RANK = -1


@dataclasses.dataclass
class PartialResult:
    """Result of a K-of-N partial collective (``allreduce(...,
    min_ranks=K, grace_s=...)``).

    ``value`` is the reduced tensor over the ranks that contributed in
    time; for SUM it is rescaled by ``world / len(contributed)`` so
    ``value / world`` equals the *mean over actual contributors* — a
    skipped rank dilutes nothing, it is simply absent from the mean.
    ``skipped`` names the ranks whose contribution missed the grace
    sub-deadline (empty when everyone arrived); a skipped rank receives
    the SAME value with itself listed in ``skipped``, so the group stays
    op-sequence-synchronized and the straggler rejoins typed instead of
    hanging."""

    value: object
    contributed: list[int]
    skipped: list[int]
    world: int

    @property
    def is_partial(self) -> bool:
        return bool(self.skipped)


class CollectiveWork:
    """Typed handle for an asynchronously dispatched collective op
    (``allreduce_async()`` and friends — the T3-style overlap
    primitive, arXiv:2401.16677).

    The op is in flight the moment the handle exists; ``wait()`` joins
    it and returns exactly what the synchronous verb would have
    (including a :class:`PartialResult` envelope in partial mode), or
    raises the same typed fault-tolerance errors. ``done()`` is a
    non-blocking completion probe. Handles are single-op: ``wait()``
    may be called repeatedly (later calls return the cached result),
    and out-of-order waits across handles are legal — each handle owns
    its own result buffers.

    Flight-recorder contract: the op's recorded wall interval spans
    *dispatch → completion* (not the issuing call window and not the
    ``wait()`` call window), so the comm-exposure attribution credits
    time genuinely hidden behind compute as overlapped."""

    __slots__ = ("group_name", "verb", "_result", "_error", "_finished",
                 "_finalize_cb", "_leak_box", "__weakref__")

    def __init__(self, group_name: str = "", verb: str = ""):
        self.group_name = group_name
        self.verb = verb
        self._result = None
        self._error: BaseException | None = None
        self._finished = False
        # Applied once to the successful result on the waiter's thread
        # (the dispatch layer hangs partial-result bookkeeping here).
        self._finalize_cb = None
        # Sanitizer leak box: set by sanitize.watch_work; wait() marks
        # it closed so a GC'd un-waited handle warns (TPU104's twin).
        self._leak_box = None
        from ray_tpu_torch._private import sanitize

        if sanitize.leaks_enabled():
            sanitize.watch_work(self)

    # Subclasses implement _join(timeout_s) -> result and _probe() ->
    # bool; the caching/raise discipline lives here once.
    def _join(self, timeout_s: float | None):  # pragma: no cover
        raise NotImplementedError

    def _probe(self) -> bool:  # pragma: no cover
        raise NotImplementedError

    def wait(self, timeout_s: float | None = None):
        """Block until the op completes; return its result (or raise
        its typed error). Idempotent — repeat calls replay the cached
        outcome."""
        if not self._finished:
            try:
                out = self._join(timeout_s)
                if self._finalize_cb is not None:
                    out = self._finalize_cb(out)
                self._result = out
            except BaseException as e:
                # A *local* wait deadline is not op completion: the op
                # is still in flight and a later wait() may join it —
                # only terminal outcomes are cached.
                if not getattr(e, "transient_wait", False):
                    self._error = e
                    self._finished = True
                    if self._leak_box is not None:
                        self._leak_box["closed"] = True
                raise
            self._finished = True
            if self._leak_box is not None:
                self._leak_box["closed"] = True
        if self._error is not None:
            raise self._error
        return self._result

    def done(self) -> bool:
        """Non-blocking: has the op completed (successfully or not)?"""
        if self._finished:
            return True
        return self._probe()

    def __repr__(self):
        state = (
            "error" if self._error is not None
            else "done" if self._finished
            else "pending"
        )
        return (
            f"<CollectiveWork {self.verb} group={self.group_name!r} "
            f"{state}>"
        )


class FutureCollectiveWork(CollectiveWork):
    """CollectiveWork over a ``concurrent.futures.Future`` — the shape
    both process-backed backends produce (the cpu hub's op coroutine
    scheduled on the runtime loop; the nccl group's dispatch thread).
    ``finalize`` runs once on the successful result on the waiter's
    thread (partial-result bookkeeping and similar)."""

    __slots__ = ("_future",)

    def __init__(self, future, group_name: str = "", verb: str = "",
                 finalize=None):
        super().__init__(group_name=group_name, verb=verb)
        self._future = future
        self._finalize_cb = finalize

    def _join(self, timeout_s: float | None):
        from concurrent.futures import CancelledError as _FutCancelled
        from concurrent.futures import TimeoutError as _FutTimeout

        try:
            out = self._future.result(timeout_s)
        except _FutCancelled:
            # The group was destroyed under this handle (queued dispatch
            # cancelled): fail typed, like every other in-flight op.
            raise CollectiveGroupDestroyedError(
                self.group_name, self.verb
            ) from None
        except _FutTimeout:
            err = CollectiveTimeoutError(
                self.group_name,
                self.verb,
                timeout_s,
                detail="wait() deadline elapsed before the dispatched "
                       "op completed (the op itself is still bounded "
                       "by its own deadline; this handle can be "
                       "waited again)",
            )
            err.transient_wait = True
            raise err from None
        return out

    def _probe(self) -> bool:
        return self._future.done()


class CollectiveError(RayTpuError):
    """Base for collective fault-tolerance errors. All subclasses keep
    their fields in ``args`` so they survive the task-error pickle path
    (a worker's abort reaches the driver typed, as ``.cause``)."""


class CollectiveTimeoutError(CollectiveError):
    """A collective op or rendezvous missed its deadline.

    ``missing_ranks`` names the ranks whose contribution (or rendezvous
    key) never arrived — None when the caller cannot know (e.g. the hub
    stopped answering)."""

    def __init__(
        self,
        group: str = "",
        op: str = "",
        timeout_s: float | None = None,
        missing_ranks=None,
        detail: str = "",
    ):
        super().__init__(group, op, timeout_s, missing_ranks, detail)
        self.group = group
        self.op = op
        self.timeout_s = timeout_s
        self.missing_ranks = (
            sorted(missing_ranks) if missing_ranks is not None else None
        )
        self.detail = detail

    def __str__(self):
        missing = (
            f" missing ranks {self.missing_ranks}"
            if self.missing_ranks is not None
            else ""
        )
        tail = f" ({self.detail})" if self.detail else ""
        return (
            f"collective {self.op or 'op'} on group {self.group!r} timed "
            f"out after {self.timeout_s}s:{missing or ' no contribution'}"
            f"{tail}"
        )


class CollectiveMemberDiedError(CollectiveError):
    """A group member died (head-declared node/worker death, or the hub
    connection dropped). The group is poisoned: every in-flight and
    future op fails with this until ``reform_group()`` re-forms it from
    the survivors."""

    def __init__(
        self,
        group: str = "",
        op: str = "",
        dead_ranks=(),
        detail: str = "",
    ):
        super().__init__(group, op, tuple(dead_ranks), detail)
        self.group = group
        self.op = op
        self.dead_ranks = sorted(dead_ranks)
        self.detail = detail

    def __str__(self):
        tail = f" ({self.detail})" if self.detail else ""
        return (
            f"collective group {self.group!r} member(s) "
            f"{self.dead_ranks} died"
            + (f" during {self.op}" if self.op else "")
            + f"; reform_group() to continue with the survivors{tail}"
        )


class CollectiveGroupDestroyedError(CollectiveError):
    """The group was destroyed while this op was in flight —
    destroy_collective_group fails pending futures instead of leaving
    their awaiting coroutines pending forever. ``detail`` of
    ``"reformed"`` means the peer incarnation moved to a new epoch (a
    reform happened under this op): reform_in_place()/auto_reform can
    rejoin, a plain destroy cannot."""

    def __init__(self, group: str = "", op: str = "", detail: str = ""):
        super().__init__(group, op, detail)
        self.group = group
        self.op = op
        self.detail = detail

    def __str__(self):
        tail = f" ({self.detail})" if self.detail else ""
        return (
            f"collective group {self.group!r} was destroyed"
            + (f" while {self.op} was in flight" if self.op else "")
            + tail
        )
